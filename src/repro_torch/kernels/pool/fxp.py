"""int16 entry point of the pool kernel family (paper §IV).

Max-pool is comparison and select only, so the fxp16 "variant" is the same
kernel on int16 feature maps (``csrc/pool.cu`` is templated on the element
type); this wrapper pins the dtype, as ``repro.kernels.pool.fxp`` does, so
the int16 CNN path cannot silently mix domains.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check
from repro_torch.kernels.pool.pool import maxpool_fwd


def maxpool_fwd_fxp(x: torch.Tensor):
    """int16 [N, H, W, C] -> (int16 pooled, packed 2-bit argmax)."""
    check("maxpool_fwd_fxp", x, torch.int16, what="x")
    return maxpool_fwd(x)
