"""True-int16 convolution kernels (paper §IV: the 16-bit fixed-point
datapath): forward and fused backward.

:func:`conv2d_fxp` wraps ``repro_conv2d_fxp_fwd`` of ``csrc/conv2d_fxp.cu``
(the port of ``repro.kernels.conv2d.fxp.conv2d_fxp_pallas``): Q7.8 int16
feature maps x Q1.14 int16 weights, int32 accumulation, one requantize,
then the Q7.8 bias added with saturation in the epilogue — the reference's
``sat_add(conv2d_fxp_pallas(x, w), b)`` in one launch, tiled like the f32
forward by ``conv2d.conv_plan`` (at 2-byte elements).
:func:`conv2d_bwd_fused_fxp` wraps ``repro_conv2d_bwd_fused_fxp`` (the port
of ``conv2d_bwd_fused_fxp_pallas``): the f32 fused backward's dataflow and
argument contract (``conv2d.conv2d_bwd_fused``) on int16 gradients, with the
requantize before the epilogue gate.  Plain versions: :func:`ref.conv2d_fxp`
and :func:`conv2d_bwd_fused_fxp_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixedpoint import sat_add
from repro_torch.kernels.conv2d import ref
from repro_torch.kernels.conv2d.conv2d import (ConvBwdPlan, ConvPlan,
                                               bwd_fused, bwd_fused_plain,
                                               conv_fwd)
from repro_torch.obs.profile import instrument


def _conv2d_fxp_plain(x, w, b):
    y = ref.conv2d_fxp(x, w)
    return y if b is None else sat_add(y, b)


@instrument("conv2d_fwd")
def conv2d_fxp(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """int16 [N, H, W, Cin] (Q7.8) x int16 [K, K, Cin, Cout] (Q1.14)
    (+ int16 b [Cout], Q7.8, saturating) -> int16 [N, H, W, Cout], stride 1,
    SAME padding.

    CPU tensors run :func:`ref.conv2d_fxp` (then ``sat_add(., b)``); CUDA
    tensors the kernel, tiled by ``plan`` (a tile planner's entry) or, when
    it is None, by ``conv_plan`` for K in ``CONV_KS``.
    """
    return conv2d_fxp_planned(x, w, b, plan=plan)


def conv2d_fxp_planned(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *,
                       plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """:func:`conv2d_fxp` with the tile chosen by the caller, for tests and
    sweeps: every plan, and ``CONV_GENERAL`` (the general kernel), gives
    the same bits.  One count of ``conv2d_fxp_fwd`` per call."""
    return conv_fwd("conv2d_fxp", "conv2d_fxp_fwd",
                    {torch.int16: "repro_conv2d_fxp_fwd"}, _conv2d_fxp_plain,
                    x, w, b, plan)


def conv2d_bwd_fused_fxp_plain(g, wt, **kw):
    """Plain twin of :func:`conv2d_bwd_fused_fxp`: unpool, gate, int16 conv
    with its requantize, gate, as separate PyTorch ops."""
    return bwd_fused_plain(ref.conv2d_fxp, g, wt, **kw)


@instrument("conv2d_bwd")
def conv2d_bwd_fused_fxp(
        g: torch.Tensor, wt: torch.Tensor, *,
        pool_idx: Optional[torch.Tensor] = None,
        relu_mask: Optional[torch.Tensor] = None,
        gate: Optional[bool] = None,
        method: str = "saliency",
        out_relu_mask: Optional[torch.Tensor] = None,
        out_gate: Optional[bool] = None,
        plan: Optional[ConvBwdPlan] = None) -> torch.Tensor:
    """int16 twin of :func:`conv2d.conv2d_bwd_fused`: the same operands,
    gates and ``plan``, Q7.8 gradients ``g`` and a Q1.14 flip-transposed
    kernel ``wt``.

    CPU tensors run :func:`conv2d_bwd_fused_fxp_plain`; CUDA tensors the
    kernel (one launch for all S seeds).
    """
    return bwd_fused("conv2d_bwd_fused_fxp",
                     {torch.int16: "repro_conv2d_bwd_fused_fxp"},
                     conv2d_bwd_fused_fxp_plain, g, wt,
                     pool_idx=pool_idx, relu_mask=relu_mask, gate=gate,
                     method=method, out_relu_mask=out_relu_mask,
                     out_gate=out_gate, plan=plan)
