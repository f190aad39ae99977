"""Packing constants shared by the kernels and their plain versions.

The TPU tile policies of ``repro.kernels.tiling`` (sublane/lane padding,
Cout and matmul tiles) do not carry over: the CUDA kernels mask their ragged
edges instead of padding channels, so only the packed-residual geometry is
kept here.
"""
from __future__ import annotations

#: 2-bit pool-argmax crumbs per packed byte.
CRUMBS_PER_BYTE = 4
#: 1-bit ReLU-mask bits per packed byte.
BITS_PER_BYTE = 8


def align_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (ceil-align)."""
    return -(-x // m) * m


def mask_bytes(c: int) -> int:
    """Packed 1-bit mask bytes for ``c`` channels."""
    return align_up(c, BITS_PER_BYTE) // BITS_PER_BYTE


def crumb_bytes(c: int) -> int:
    """Packed 2-bit pool-index bytes for ``c`` channels."""
    return align_up(c, CRUMBS_PER_BYTE) // CRUMBS_PER_BYTE
