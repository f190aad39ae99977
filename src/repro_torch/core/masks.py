"""Bit-packed residual masks (paper §III.D, Table II), in PyTorch.

Byte layout is the JAX package's, so residuals move between the two:

* 1-bit masks: bit ``j`` of byte ``b`` is channel ``8b + j`` (LSB first);
* 2-bit crumbs: crumb ``j`` of byte ``b`` is channel ``4b + j``.

Channels past the end of the last byte pack as 0.  All helpers work on the
last axis and on any device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.tiling import BITS_PER_BYTE, CRUMBS_PER_BYTE


def _pack(vals: torch.Tensor, per_byte: int, width: int) -> torch.Tensor:
    v = vals.to(torch.int32)
    rem = (-v.shape[-1]) % per_byte
    if rem:
        v = torch.nn.functional.pad(v, (0, rem))
    v = v.reshape(v.shape[:-1] + (v.shape[-1] // per_byte, per_byte))
    shifts = torch.arange(per_byte, device=v.device, dtype=torch.int32) * width
    return (v << shifts).sum(dim=-1).to(torch.uint8)


def _unpack(packed: torch.Tensor, per_byte: int, width: int,
            n: int) -> torch.Tensor:
    shifts = torch.arange(per_byte, device=packed.device,
                          dtype=torch.int32) * width
    v = (packed.to(torch.int32)[..., None] >> shifts) & ((1 << width) - 1)
    v = v.reshape(packed.shape[:-1] + (packed.shape[-1] * per_byte,))
    return v[..., :n]


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """Bool tensor -> uint8, 8 bits per byte along the last axis.

    Returns ``bits.shape[:-1] + (ceil(n/8),)``.
    """
    return _pack(bits, BITS_PER_BYTE, 1)


def unpack_mask(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_mask`: bool tensor with last axis ``n``."""
    return _unpack(packed, BITS_PER_BYTE, 1, n).to(torch.bool)


def pack_crumbs(idx: torch.Tensor) -> torch.Tensor:
    """Values in [0, 3] -> uint8, 4 per byte along the last axis (Fig. 5b)."""
    return _pack(idx, CRUMBS_PER_BYTE, 2)


def unpack_crumbs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_crumbs`: int32 values in [0, 3]."""
    return _unpack(packed, CRUMBS_PER_BYTE, 2, n)


def mask_nbytes(shape) -> int:
    """Bytes of a packed 1-bit mask for a tensor of ``shape``."""
    return (math.prod(shape) + 7) // 8


def crumb_nbytes(shape) -> int:
    """Bytes of a packed 2-bit index tensor for ``shape`` windows."""
    return (math.prod(shape) + 3) // 4
