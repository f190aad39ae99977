"""Convolution with the paper's compute-block-reuse backward (Fig. 6,
Table I): the standalone op of the unfused path.

The forward is the conv kernel (B1, or its bf16 instance, which routes
any channel count: the tensor cores where Cin is a multiple of 16, FFMA
otherwise).  The input gradient is the SAME kernel on the flip-transposed
weight; the weight gradient (training only) is
:func:`ref.conv2d_weight_grad`, an f32 sum rounded once to the weight's
type, outside the kernels as in the JAX package.  ``x`` is saved only when ``w`` needs a gradient — the port's
counterpart of XLA dropping the weight branch on the attribution path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv2d import ref
from repro_torch.kernels.conv2d.conv2d import conv2d as conv2d_kernel


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return conv2d_kernel(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_kernel(g, ref.flip_transpose(w))
        if ctx.needs_input_grad[1]:
            dw = ref.conv2d_weight_grad(x, w, g)
        return dx, dw


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv, NHWC x HWIO, on the kernel both ways."""
    return _Conv2d.apply(x, w)
