"""The selective scan as an autograd Function (``repro``'s ``custom_vjp``).

Forward: the B13 kernel (:func:`ssm_scan.selective_scan`; its plain
version on the CPU).  Backward: the B13 backward kernel
(:func:`ssm_scan.selective_scan_bwd`: the reverse recurrence over
recomputed states; on the CPU its plain version
:func:`ref.selective_scan_bwd`, step by step), the port of
``repro.kernels.ssm_scan.ops._bwd`` (``jax.vjp`` of the reference loop).
Only the gradients that autograd asks for are computed, each returned in
its input's dtype.

``d_tile``/``chunk`` default to the JAX package's kernel defaults.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ssm_scan

_DEFAULT_D_TILE = 256
_DEFAULT_CHUNK = 64


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, h0, d_tile, chunk):
        ctx.d_tile, ctx.chunk = d_tile, chunk
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0)
        ctx.set_materialize_grads(False)      # an unused h_last reads nothing
        return ssm_scan.selective_scan(dt, x, bmat, cmat, a, h0,
                                       d_tile=d_tile, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = ctx.saved_tensors
        x = inputs[1]
        if gy is None:
            gy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        grads = ssm_scan.selective_scan_bwd(
            *inputs, gy, gh, d_tile=ctx.d_tile, chunk=ctx.chunk,
            needs=ctx.needs_input_grad[:6])
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(grads, inputs)) + (None, None)


def selective_scan(dt, x, bmat, cmat, a, h0, *, d_tile=None, chunk=None):
    """(dt, x [B,S,D], B/C [B,S,N], A [D,N], h0 [B,D,N]) -> (y, h_last)."""
    return _SelectiveScan.apply(
        dt, x, bmat, cmat, a, h0,
        int(d_tile) if d_tile is not None else _DEFAULT_D_TILE,
        int(chunk) if chunk is not None else _DEFAULT_CHUNK)
