"""Selective scan (mamba-1), the SSM hot spot of LM token attribution.

:func:`selective_scan` wraps the CUDA kernel ``csrc/ssm_scan.cu``, the port
of ``repro.kernels.ssm_scan.ssm_scan.selective_scan_pallas``: one launch
per mamba layer, the f32 state in registers, B/C and the block's dt/x
columns staged in shared memory chunk by chunk.  CPU tensors run the plain
recurrence :func:`ref.selective_scan`.

``d_tile`` and ``chunk`` are the launch knobs of the JAX package (how many
channels one grid cell covers, how many timesteps one staging chunk
holds).  As there, they split the grid and the staging, never the
arithmetic of an element, so every pair gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check, check_kernel_operands, on_card
from repro_torch.kernels.ssm_scan import ref

#: Kernel entry point per element type of x (and y).
_ENTRY = {torch.float32: "repro_selective_scan",
          torch.bfloat16: "repro_selective_scan_bf16"}
#: States a kernel thread keeps in registers, and channels per block.
MAX_STATE = 16
MAX_THREADS = 128


def selective_scan(dt, x, bmat, cmat, a, h0, *, d_tile: int, chunk: int):
    """dt/x [B,S,D], bmat/cmat [B,S,N], a [D,N] f32, h0 [B,D,N] f32 ->
    (y [B,S,D] in x's dtype, h_last [B,D,N] f32).

    dt, B and C are cast to f32 (as ``selective_scan_pallas`` does); x is
    f32 or bf16.  ``d % min(d_tile, D) == 0`` is required, as in the JAX
    package.  CPU tensors run :func:`ref.selective_scan`; CUDA tensors the
    kernel.
    """
    name = "selective_scan"
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"{name}: x must be [B,S,D] and a [D,N], got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    b, s, d = x.shape
    n = a.shape[1]
    dt_t = min(d_tile, d)
    assert d % dt_t == 0, (d, dt_t)
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    dt = dt.to(torch.float32)
    bmat = bmat.to(torch.float32)
    cmat = cmat.to(torch.float32)
    check(name, dt, torch.float32, (b, s, d), what="dt")
    check(name, x, tuple(_ENTRY), what="x")
    check(name, bmat, torch.float32, (b, s, n), what="bmat")
    check(name, cmat, torch.float32, (b, s, n), what="cmat")
    check(name, a, torch.float32, (d, n), what="a")
    check(name, h0, torch.float32, (b, d, n), what="h0")
    if not on_card(name, dt, x, bmat, cmat, a, h0):
        return ref.selective_scan(dt, x, bmat, cmat, a, h0)
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{name}: the kernel keeps N <= {MAX_STATE} "
                         f"states in registers, got N = {n}")
    # B/C come as views of one projection: make every operand dense
    dt, x, bmat, cmat, a, h0 = (t.contiguous()
                                for t in (dt, x, bmat, cmat, a, h0))
    check_kernel_operands(name, dt, x, bmat, cmat, a, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    if b and d:
        _build.launch(name, _ENTRY[x.dtype], x.device, dt.data_ptr(),
                      x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                      a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                      h_last.data_ptr(), b, s, d, n,
                      min(dt_t, MAX_THREADS), chunk)
    return y, h_last
