"""2x2 max-pool + 2-bit argmax (paper §III.D, Fig. 5).

:func:`maxpool_fwd` wraps the CUDA kernel ``csrc/pool.cu`` (the port of
``repro.kernels.pool.pool.maxpool_fwd_pallas``): one pass emits the pooled
map and the crumb-packed argmax.  :func:`unpool_bwd` wraps its backward
twin (the port of ``unpool_bwd_pallas``): the pooled gradient routed to
the stored argmax, the backward of the standalone pool (``pool.ops``).  On
the seed-batched path the unpool runs instead as the prologue of the fused
conv backward (``conv2d.conv2d_bwd_fused``), whose plain twin calls
:func:`ref.unpool_scatter`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check, check_kernel_operands, on_card
from repro_torch.kernels.pool import ref
from repro_torch.kernels.tiling import crumb_bytes


#: Kernel entry point per element type: f32, and int16 for the fxp16 path.
_ENTRY = {torch.float32: "repro_maxpool_fwd",
          torch.int16: "repro_maxpool_fwd_i16"}


def maxpool_fwd(x: torch.Tensor):
    """x: [N, H, W, C] f32 or int16, H and W even -> (pooled [N, H/2, W/2,
    C] of the same type, packed argmax uint8 [N, H/2, W/2, ceil(C/4)]).

    Candidates are (0,0), (0,1), (1,0), (1,1); the first maximum wins.
    CPU tensors run :func:`ref.maxpool_fwd`; CUDA tensors the kernel.
    """
    name = "maxpool_fwd"
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: x must be [N, H, W, C] with even H, W; "
                         f"got {tuple(x.shape)}")
    check(name, x, tuple(_ENTRY), what="x")
    if not on_card(name, x):
        return ref.maxpool_fwd(x)
    check_kernel_operands(name, x)
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, h // 2, w // 2, crumb_bytes(c)), dtype=torch.uint8,
                      device=x.device)
    if y.numel():
        _build.launch(name, _ENTRY[x.dtype], x.device, x.data_ptr(),
                      y.data_ptr(), idx.data_ptr(), n, h, w, c)
    return y, idx


#: Backward entry point per element type: f32, and int16 for the fxp16 path.
_BWD_ENTRY = {torch.float32: "repro_unpool_bwd",
              torch.int16: "repro_unpool_bwd_i16"}


def unpool_bwd(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """packed uint8 [N, H/2, W/2, ceil(C/4)] and g [N, H/2, W/2, C] f32 or
    int16 -> [N, H, W, C] of g's type: each window's gradient at its stored
    argmax candidate, 0 at the other three (paper Fig. 5b).

    Crumbs past C are ignored.  CPU tensors run :func:`ref.unpool_bwd`;
    CUDA tensors the kernel, which writes every output element once.
    """
    name = "unpool_bwd"
    if g.dim() != 4:
        raise ValueError(f"{name}: g must be [N, H/2, W/2, C], got "
                         f"{tuple(g.shape)}")
    check(name, g, tuple(_BWD_ENTRY), what="g")
    n, hp, wp, c = g.shape
    check(name, packed, torch.uint8, (n, hp, wp, crumb_bytes(c)),
          what="packed")
    if not on_card(name, packed, g):
        return ref.unpool_bwd(packed, g)
    check_kernel_operands(name, packed, g)
    out = torch.empty((n, 2 * hp, 2 * wp, c), dtype=g.dtype, device=g.device)
    if out.numel():
        _build.launch(name, _BWD_ENTRY[g.dtype], g.device, packed.data_ptr(),
                      g.data_ptr(), out.data_ptr(), n, hp, wp, c)
    return out
