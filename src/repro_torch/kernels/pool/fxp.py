"""int16 entry point of the pool kernel family (paper §IV).

Max-pool, the fused ReLU+mask+pool and unpool are comparison and select
only, so the fxp16 "variants" are the same kernels on int16 feature maps
(``csrc/relu_pool.cuh`` and ``csrc/pool.cu`` are templated on the element
type); these wrappers pin the dtype, as
``repro.kernels.pool.fxp`` does, so the int16 CNN path cannot silently mix
domains.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check
from repro_torch.kernels.pool.pool import (maxpool_fwd, relu_pool_fwd,
                                           unpool_bwd)


def maxpool_fwd_fxp(x: torch.Tensor):
    """int16 [N, H, W, C] -> (int16 pooled, packed 2-bit argmax)."""
    check("maxpool_fwd_fxp", x, torch.int16, what="x")
    return maxpool_fwd(x)


def relu_pool_fwd_fxp(x: torch.Tensor, mask: bool = True):
    """int16 [N, H, W, C] -> (int16 pooled ReLU, 1-bit mask or None, packed
    2-bit argmax): the fused pass of the int16 pooled layers."""
    check("relu_pool_fwd_fxp", x, torch.int16, what="x")
    return relu_pool_fwd(x, mask)


def unpool_bwd_fxp(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Standalone int16 unpool: int16 g [N, H/2, W/2, C] -> int16 [N, H, W,
    C] (the fused int16 conv backward inlines this)."""
    check("unpool_bwd_fxp", g, torch.int16, what="g")
    return unpool_bwd(packed, g)
