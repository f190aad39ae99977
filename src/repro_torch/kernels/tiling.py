"""Packing constants shared by the kernels and their plain versions.

The TPU tile policies of ``repro.kernels.tiling`` (sublane/lane padding,
Cout and matmul tiles) do not carry over: the CUDA kernels mask their ragged
edges instead of padding channels, so only the packed-residual geometry is
kept here, with the card's SM count that the launch choices of the conv
and FC forwards (``conv_plan``, ``vmm_splits``) and of the ReLU / pool
template (:func:`relu_pool_threads`) are sized against.
"""
from __future__ import annotations

#: 2-bit pool-argmax crumbs per packed byte.
CRUMBS_PER_BYTE = 4
#: 1-bit ReLU-mask bits per packed byte.
BITS_PER_BYTE = 8
#: Streaming multiprocessors of the H100 SXM, for which the kernels' launch
#: shapes are chosen.
H100_SMS = 132


def cdiv(x: int, m: int) -> int:
    """``ceil(x / m)`` for positive ``m``."""
    return -(-x // m)


def align_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (ceil-align)."""
    return cdiv(x, m) * m


def mask_bytes(c: int) -> int:
    """Packed 1-bit mask bytes for ``c`` channels."""
    return align_up(c, BITS_PER_BYTE) // BITS_PER_BYTE


def crumb_bytes(c: int) -> int:
    """Packed 2-bit pool-index bytes for ``c`` channels."""
    return align_up(c, CRUMBS_PER_BYTE) // CRUMBS_PER_BYTE


#: Block sizes the ReLU / pool template (``csrc/relu_pool.cuh``: B2, B3 and
#: the fused ReLU+mask+pool) may run; ``chip_smoke.py --sweep`` times each.
RELU_POOL_THREADS = (32, 64, 128, 256, 512)
#: The block size that selects B2's / B3's general kernel (their first
#: design, ``relu_fwd_kernel`` / ``maxpool_fwd_kernel``) instead.
RELU_POOL_GENERAL = 0


def relu_pool_threads(work: int) -> int:
    """Block size of one template launch of ``work`` threads (one a mask
    byte of an output pixel): the largest of :data:`RELU_POOL_THREADS` up
    to 128 that still gives every SM a block, else the smallest.  Swept on
    an H100 (``chip_smoke.py --sweep``), block sizes differ by a few tenths
    of a microsecond a launch; 256 cost f32 B2 17 % (CUPTI) at
    ``[32768, 32]``."""
    for t in sorted((t for t in RELU_POOL_THREADS if t <= 128),
                    reverse=True):
        if cdiv(work, t) >= H100_SMS:
            return t
    return RELU_POOL_THREADS[0]


def check_relu_pool_threads(name: str, threads: int,
                            general: bool = True) -> None:
    """Raise unless the template can run blocks of ``threads`` (or, where
    ``general``, ``threads`` selects the general kernel)."""
    if not (threads in RELU_POOL_THREADS
            or (general and threads == RELU_POOL_GENERAL)):
        raise ValueError(f"{name}: threads={threads} not in "
                         f"{RELU_POOL_THREADS}"
                         + (" or RELU_POOL_GENERAL (0)" if general else ""))
