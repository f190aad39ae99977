"""Fused ReLU + 1-bit packed mask (paper §III.D, Fig. 4).

:func:`relu_fwd` is the wrapper of the B2 instance of the CUDA template
``csrc/relu_pool.cuh`` (the port of
``repro.kernels.relu_mask.relu_mask.relu_fwd_pallas``; entry in
``csrc/relu_mask.cu``): one pass emits ``max(x, 0)`` and the packed
``x > 0`` bits.  At the pooled conv layers the same template fuses it with
the pool (``pool.relu_pool_fwd``).  :func:`relu_bwd`
wraps its backward twin (the port of ``relu_bwd_pallas``, on f32 and bf16
gradients): the method's gate (Eq. 3-5) on a gradient by the stored bits,
the backward of the standalone ReLU (``relu_mask.ops``) and the weight
gradients of the fused blocks.

:func:`unpack_bits` and :func:`gate_gradient` are the plain versions of the
in-kernel helpers that the fused conv/vmm backward kernels run as their
prologue and epilogue; the plain twins of those kernels call them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_kernel_operands, on_card)
from repro_torch.kernels.relu_mask import ref
from repro_torch.kernels.tiling import (check_relu_pool_threads, mask_bytes,
                                        relu_pool_threads)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[..., C/8] uint8 -> [..., C] bool (C = 8 * bytes)."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1]
                        + (packed.shape[-1] * 8,)).to(torch.bool)


def gate_gradient(g: torch.Tensor, mask_bits: Optional[torch.Tensor],
                  method: str) -> torch.Tensor:
    """The method's rectifier rule (paper Eq. 3-5) on a gradient block.

    ``mask_bits`` broadcasts against ``g`` (seed-batched gradients carry
    leading axes the stored mask does not — the mask-reuse amortization).
    """
    if method == "deconvnet":                        # Eq. 4: no mask read
        return torch.where(g > 0, g, 0)
    if method == "guided":                           # Eq. 5
        return torch.where(mask_bits & (g > 0), g, 0)
    return torch.where(mask_bits, g, 0)              # Eq. 3: saliency


#: Kernel entry point per element type: f32, bf16 for the bf16 path and
#: int16 for the fxp16 path.
_ENTRY = {torch.float32: "repro_relu_fwd",
          torch.bfloat16: "repro_relu_fwd_bf16",
          torch.int16: "repro_relu_fwd_i16"}


def relu_fwd(x2d: torch.Tensor, *, threads: Optional[int] = None):
    """x2d: [R, C] f32, bf16 or int16 -> (relu [R, C] of the same type,
    packed mask uint8 [R, ceil(C/8)]).

    Bit ``j`` of byte ``b`` is ``x[:, 8b + j] > 0`` (strictly); bits past C
    are 0.  CPU tensors run :func:`ref.relu_fwd`; CUDA tensors the kernel.
    ``threads``: the block size (tests, sweeps): :func:`relu_pool_threads`'s
    by default, ``RELU_POOL_GENERAL`` for the general kernel; every choice
    gives the same bits.
    """
    name = "relu_fwd"
    if x2d.dim() != 2:
        raise ValueError(f"{name}: x must be [R, C], got {tuple(x2d.shape)}")
    check(name, x2d, tuple(_ENTRY), what="x")
    r, c = x2d.shape
    if threads is None:
        threads = relu_pool_threads(r * mask_bytes(c))
    check_relu_pool_threads(name, threads)
    if not on_card(name, x2d):
        return ref.relu_fwd(x2d)
    check_kernel_operands(name, x2d)
    y = torch.empty_like(x2d)
    m = torch.empty((r, mask_bytes(c)), dtype=torch.uint8, device=x2d.device)
    if r and c:
        _build.launch(name, _ENTRY[x2d.dtype], x2d.device, x2d.data_ptr(),
                      y.data_ptr(), m.data_ptr(), r, c, threads)
    return y, m


#: Backward entry point per element type: f32, and bf16 for the bf16
#: autograd paths (the fxp16 path has no vjp).
_BWD_ENTRY = {torch.float32: "repro_relu_bwd",
              torch.bfloat16: "repro_relu_bwd_bf16"}


def relu_bwd(packed: Optional[torch.Tensor], g2d: torch.Tensor,
             method: str) -> torch.Tensor:
    """Masked gradient gate: packed uint8 [R, ceil(C/8)] and g2d [R, C] f32
    or bf16 -> [R, C] of g2d's type, by ``method``'s rule (paper Eq. 3-5).

    It selects and never rounds, so every type is exact; ``g > 0`` is
    strict (-0.0 gates to +0.0).  Bits past C are ignored.  ``packed=None`` is accepted for deconvnet
    only, whose rule reads no mask (Table II stores none).  CPU tensors run
    :func:`ref.relu_bwd`; CUDA tensors the kernel.
    """
    name = "relu_bwd"
    if method not in METHOD_CODES:
        raise ValueError(f"method={method!r} not in {tuple(METHOD_CODES)}")
    if g2d.dim() != 2:
        raise ValueError(f"{name}: g must be [R, C], got {tuple(g2d.shape)}")
    check(name, g2d, tuple(_BWD_ENTRY), what="g")
    r, c = g2d.shape
    if packed is None:
        if method != "deconvnet":
            raise ValueError(f"{name}: method={method!r} needs the stored "
                             f"1-bit mask; only deconvnet takes none")
    else:
        check(name, packed, torch.uint8, (r, mask_bytes(c)), what="packed")
    if not on_card(name, packed, g2d):
        return ref.relu_bwd(packed, g2d, method)
    check_kernel_operands(name, packed, g2d)
    out = torch.empty_like(g2d)
    if r and c:
        _build.launch(name, _BWD_ENTRY[g2d.dtype], g2d.device,
                      _build.ptr(packed), g2d.data_ptr(), out.data_ptr(), r,
                      c, METHOD_CODES[method])
    return out
