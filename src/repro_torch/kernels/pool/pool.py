"""2x2 max-pool + 2-bit argmax (paper §III.D, Fig. 5), alone and fused with
the ReLU + 1-bit mask before it.

:func:`maxpool_fwd` wraps the B3 instance of the CUDA template
``csrc/relu_pool.cuh`` (the port of
``repro.kernels.pool.pool.maxpool_fwd_pallas``; entry in ``csrc/pool.cu``):
one pass emits the pooled map and the crumb-packed argmax.
:func:`relu_pool_fwd` runs the template's fused instance at the pooled
conv layers: ReLU (+ the 1-bit mask of every pre-pool element) and the
pool in one pass, where B2 then B3 would write the ReLU'd map and read it
back.  :func:`unpool_bwd` wraps its backward
twin (the port of ``unpool_bwd_pallas``): the pooled gradient routed to
the stored argmax, the backward of the standalone pool (``pool.ops``).  On
the seed-batched path the unpool runs instead as the prologue of the fused
conv backward (``conv2d.conv2d_bwd_fused``), whose plain twin calls
:func:`ref.unpool_scatter`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, check, check_kernel_operands, on_card
from repro_torch.kernels.pool import ref
from repro_torch.kernels.tiling import (check_relu_pool_threads, crumb_bytes,
                                        mask_bytes, relu_pool_threads)
from repro_torch.obs.profile import instrument


#: Kernel entry point per element type: f32, bf16 for the bf16 path and
#: int16 for the fxp16 path.
_ENTRY = {torch.float32: "repro_maxpool_fwd",
          torch.bfloat16: "repro_maxpool_fwd_bf16",
          torch.int16: "repro_maxpool_fwd_i16"}


def _check_map(name: str, x: torch.Tensor, entries: dict) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: x must be [N, H, W, C] with even H, W; "
                         f"got {tuple(x.shape)}")
    check(name, x, tuple(entries), what="x")


def _pooled(x: torch.Tensor):
    """Empty pooled map and crumbs for ``x`` [N, H, W, C]."""
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, h // 2, w // 2, crumb_bytes(c)), dtype=torch.uint8,
                      device=x.device)
    return y, idx


def _threads(x: torch.Tensor, threads: Optional[int]) -> int:
    """The rule's block size for the pooled instances over ``x``: one
    thread a window and 8 channels."""
    if threads is not None:
        return threads
    n, h, w, c = x.shape
    return relu_pool_threads(n * (h // 2) * (w // 2) * mask_bytes(c))


@instrument("pool")
def maxpool_fwd(x: torch.Tensor, *, threads: Optional[int] = None):
    """x: [N, H, W, C] f32, bf16 or int16, H and W even -> (pooled [N,
    H/2, W/2, C] of the same type, packed argmax uint8 [N, H/2, W/2,
    ceil(C/4)]).

    Candidates are (0,0), (0,1), (1,0), (1,1); the first maximum wins.
    CPU tensors run :func:`ref.maxpool_fwd`; CUDA tensors the kernel.
    ``threads``: the block size (tests, sweeps): :func:`relu_pool_threads`'s
    by default, ``RELU_POOL_GENERAL`` for the general kernel; every choice
    gives the same bits.
    """
    name = "maxpool_fwd"
    _check_map(name, x, _ENTRY)
    threads = _threads(x, threads)
    check_relu_pool_threads(name, threads)
    if not on_card(name, x):
        return ref.maxpool_fwd(x)
    check_kernel_operands(name, x)
    n, h, w, c = x.shape
    y, idx = _pooled(x)
    if y.numel():
        _build.launch(name, _ENTRY[x.dtype], x.device, x.data_ptr(),
                      y.data_ptr(), idx.data_ptr(), n, h, w, c, threads)
    return y, idx


#: Fused ReLU+mask+pool entry point per element type.
_FUSED_ENTRY = {torch.float32: "repro_relu_pool_fwd",
                torch.bfloat16: "repro_relu_pool_fwd_bf16",
                torch.int16: "repro_relu_pool_fwd_i16"}


@instrument("pool")
def relu_pool_fwd(x: torch.Tensor, mask: bool = True, *,
                  threads: Optional[int] = None):
    """x: [N, H, W, C] f32, bf16 or int16 (a conv's output), H and W
    even -> (pooled ReLU [N, H/2, W/2, C] of the same type, the 1-bit mask of
    ``x > 0`` uint8 [N, H, W, ceil(C/8)] or None where not ``mask``, packed
    argmax uint8 [N, H/2, W/2, ceil(C/4)]).

    Bitwise :func:`maxpool_fwd` of :func:`relu_mask.relu_fwd`'s output and
    its mask in ``_relu_fwd_mask4``'s layout (``mask=False``: deconvnet,
    which stores no mask, Table II), in one launch.  CPU tensors run
    :func:`ref.relu_pool_fwd`; CUDA tensors the kernel.  ``threads``: the
    block size (tests, sweeps), :func:`relu_pool_threads`'s by default.
    """
    name = "relu_pool_fwd"
    _check_map(name, x, _FUSED_ENTRY)
    threads = _threads(x, threads)
    check_relu_pool_threads(name, threads, general=False)
    if not on_card(name, x):
        return ref.relu_pool_fwd(x, mask)
    n, h, w, c = x.shape
    # input pixels are offset in 64 bits, threads (a window x 8 channels)
    # counted in 32: any input whose threads fit
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel operands must be contiguous")
    if n * (h // 2) * (w // 2) * mask_bytes(c) >= 2 ** 31:
        raise ValueError(f"{name}: {n * (h // 2) * (w // 2)} windows of "
                         f"{c} channels exceed the kernel's 32-bit threads")
    y, idx = _pooled(x)
    m = (torch.empty((n, h, w, mask_bytes(c)), dtype=torch.uint8,
                     device=x.device) if mask else None)
    if y.numel():
        _build.launch(name, _FUSED_ENTRY[x.dtype], x.device, x.data_ptr(),
                      y.data_ptr(), _build.ptr(m), idx.data_ptr(), n, h, w,
                      c, threads)
    return y, m, idx


#: Backward entry point per element type: f32, bf16 for the bf16 autograd
#: paths, and int16 for the fxp16 path.
_BWD_ENTRY = {torch.float32: "repro_unpool_bwd",
              torch.bfloat16: "repro_unpool_bwd_bf16",
              torch.int16: "repro_unpool_bwd_i16"}


def unpool_bwd(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """packed uint8 [N, H/2, W/2, ceil(C/4)] and g [N, H/2, W/2, C] f32,
    bf16 or int16 -> [N, H, W, C] of g's type: each window's gradient at its
    stored argmax candidate, +0 at the other three (paper Fig. 5b).

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
