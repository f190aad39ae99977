"""Attribution-aware 2x2 max-pool on the kernels: the standalone op of the
unfused path.

The forward is the pool+argmax kernel (B3), whose 2-bit packed argmax is
the only saved tensor — every method stores it (Table II) — and the
backward is the unpool kernel (B12), for every method including
``"autodiff"``: the first-max routing, as ``repro.kernels.pool.ops`` has it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pool.pool import maxpool_fwd, unpool_bwd


class _MaxPoolAttr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, packed = maxpool_fwd(x.contiguous())
        ctx.save_for_backward(packed)
        return y

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        return unpool_bwd(packed, g.contiguous())


def maxpool2x2(x: torch.Tensor, method: str = "autodiff") -> torch.Tensor:
    """2x2/2 max-pool, NHWC; the backward routes to the stored argmax for
    every ``method`` (the rule sets differ only at rectifiers)."""
    return _MaxPoolAttr.apply(x)
