"""FC matmul with transposed-operand backward reuse (paper §III.E, Table
I): the standalone op of the unfused path.

The forward is the vmm kernel (B4, or its bf16 instance); the input
gradient is the SAME kernel on a contiguous ``W^T``; the weight gradient
(training only) is a plain f32 product, rounded once to the weight's type
(:func:`ref.vmm_weight_grad`).  ``x`` is saved only when ``w`` needs a
gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vmm import ref
from repro_torch.kernels.vmm.vmm import vmm as vmm_kernel


class _Vmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return vmm_kernel(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = vmm_kernel(g, w.T.contiguous())
        if ctx.needs_input_grad[1]:
            dw = ref.vmm_weight_grad(x, g, w.dtype)
        return dx, dw


def vmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] -> [M, N], on the kernel both ways."""
    return _Vmm.apply(x, w)
