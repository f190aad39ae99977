"""True-int16 FC matmul kernels (paper §IV: the 16-bit fixed-point
datapath): forward and fused backward.

:func:`vmm_fxp` wraps ``repro_vmm_fxp_fwd`` of ``csrc/vmm_fxp.cu`` (the port
of ``repro.kernels.vmm.fxp.vmm_fxp_pallas``): Q7.8 int16 inputs x Q1.14
int16 weights, int32 accumulation, one requantize, then the Q7.8 bias added
with saturation in the epilogue — the reference's ``sat_add(vmm_fxp_pallas(x,
w), b)`` in one launch, K split across blocks as in the f32 forward
(``vmm.vmm_splits``, with an int32 workspace summed by a second kernel).
:func:`vmm_bwd_fused_fxp` wraps ``repro_vmm_bwd_fused_fxp`` (the port of
``vmm_bwd_fused_fxp_pallas``): the f32 fused backward's dataflow, argument
contract and tiled template (``vmm.vmm_bwd_fused``, ``csrc/vmm_bwd.cuh``)
on int16 gradients, with the requantize before the epilogue gate.  Plain
versions: :func:`ref.vmm_fxp` and :func:`vmm_bwd_fused_fxp_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixedpoint import sat_add
from repro_torch.kernels.vmm import ref
from repro_torch.kernels.vmm.vmm import (VmmBwdPlan, bwd_fused,
                                         bwd_fused_plain, vmm_fwd)
from repro_torch.obs.profile import instrument


def _vmm_fxp_plain(x, w, b):
    y = ref.vmm_fxp(x, w)
    return y if b is None else sat_add(y, b)


@instrument("vmm_fwd")
def vmm_fxp(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, *,
            plan: Optional[int] = None) -> torch.Tensor:
    """int16 [M, K] (Q7.8) @ int16 [K, N] (Q1.14) (+ int16 b [N], Q7.8,
    saturating) -> int16 [M, N].

    CPU tensors run :func:`ref.vmm_fxp` (then ``sat_add(., b)``); CUDA
    tensors the kernel, with ``plan`` slices of K (a tile planner's entry)
    or, when it is None, ``vmm_splits``'.
    """
    return vmm_fxp_with_splits(x, w, b, splits=plan)


def vmm_fxp_with_splits(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None, *,
                        splits: Optional[int] = None) -> torch.Tensor:
    """:func:`vmm_fxp` with the number of K slices (1 to
    ``vmm_max_splits``) chosen by the caller, for tests and sweeps: the
    int32 partial sums wrap like the whole sum, so every split gives the
    same bits.  One count of ``vmm_fxp_fwd`` per call, whatever the
    split."""
    return vmm_fwd("vmm_fxp", "vmm_fxp_fwd",
                   {torch.int16: "repro_vmm_fxp_fwd"}, torch.int32,
                   _vmm_fxp_plain, x, w, b, splits)


def vmm_bwd_fused_fxp_plain(g, w, **kw):
    """Plain twin of :func:`vmm_bwd_fused_fxp`: gate, int16 product with its
    requantize, gate, as separate PyTorch ops."""
    return bwd_fused_plain(ref.vmm_fxp, g, w, **kw)


@instrument("vmm_bwd")
def vmm_bwd_fused_fxp(g: torch.Tensor, w: torch.Tensor, *,
                      relu_mask: Optional[torch.Tensor] = None,
                      gate: Optional[bool] = None,
                      method: str = "saliency",
                      out_relu_mask: Optional[torch.Tensor] = None,
                      out_gate: Optional[bool] = None,
                      plan: Optional[VmmBwdPlan] = None) -> torch.Tensor:
    """int16 twin of :func:`vmm.vmm_bwd_fused`: the same operands, gates and
    tile plans (``vmm.vmm_bwd_plan``; ``vmm.VMM_BWD_GENERAL`` for the
    general kernel), Q7.8 gradients ``g`` [S, M, K] and the Q1.14
    transposed weight ``w``.  The int32 sums wrap, so every plan gives the
    plain version's bits.

    CPU tensors run :func:`vmm_bwd_fused_fxp_plain`; CUDA tensors the kernel
    (one launch for all S seeds).
    """
    return bwd_fused("vmm_bwd_fused_fxp",
                     {torch.int16: "repro_vmm_bwd_fused_fxp"},
                     vmm_bwd_fused_fxp_plain, g, w,
                     relu_mask=relu_mask, gate=gate, method=method,
                     out_relu_mask=out_relu_mask, out_gate=out_gate,
                     plan=plan)
