"""The selective scan as an autograd Function (``repro``'s ``custom_vjp``).

Forward: the B13 kernel (:func:`ssm_scan.selective_scan`; its plain
version on the CPU).  Backward: recompute from the saved inputs and
differentiate a plain form of the same recurrence with autograd, as
``repro.kernels.ssm_scan.ops`` does (``jax.vjp`` of its reference).  The
form differentiated here is the model's chunked doubling scan
(``models.mamba.chunked_scan``: about log2(chunk) vectorised steps per
chunk, not S sequential ones); the JAX package has no backward kernel for
B13 either, and neither has the port yet (ROADMAP).

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
        ctx.chunk = chunk
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0)
        return ssm_scan.selective_scan(dt, x, bmat, cmat, a, h0,
                                       d_tile=d_tile, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models import mamba
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(w)
                    for t, w in zip(ctx.saved_tensors, need)]
            y, h_last = mamba.chunked_scan(*args, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, h_last), [t for t, w in zip(args, need) if w],
                (gy, gh), allow_unused=True))
        return tuple(next(grads) if w else None for w in need) + (None, None)


def selective_scan(dt, x, bmat, cmat, a, h0, *, d_tile=None, chunk=None):
    """(dt, x [B,S,D], B/C [B,S,N], A [D,N], h0 [B,D,N]) -> (y, h_last)."""
    return _SelectiveScan.apply(
        dt, x, bmat, cmat, a, h0,
        int(d_tile) if d_tile is not None else _DEFAULT_D_TILE,
        int(chunk) if chunk is not None else _DEFAULT_CHUNK)
