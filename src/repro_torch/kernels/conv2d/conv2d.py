"""Convolution kernels (paper §III.B, Fig. 4-6): forward and fused backward.

:func:`conv2d` wraps ``repro_conv2d_fwd`` of ``csrc/conv2d.cu`` (the port of
``repro.kernels.conv2d.conv2d.conv2d_pallas``), with the conv bias added in
its epilogue; :func:`conv_plan` chooses its tile for each shape and element
size (K in :data:`CONV_KS`; other odd K, or :data:`CONV_GENERAL`, run the
general kernel it shares with the fused backward, which tiles itself).
:func:`conv2d_bwd_fused` wraps ``repro_conv2d_bwd_fused`` (the
port of ``conv2d_bwd_fused_pallas``): the unpool scatter by the stored 2-bit
argmax and the Eq. 3-5 gate by the stored 1-bit mask run as a prologue on
the gradient as it is staged, then the SAME conv with the flip-transposed
kernel, then an optional epilogue gate — a conv layer's whole backward step
in one launch, the seeds of a block (all S up to 3) sharing one load of the
stored residuals.  :func:`conv_bwd_plan` chooses its tile (K in
:data:`CONV_KS`; other odd K, or :data:`CONV_BWD_GENERAL`, run the general
kernel, which tiles itself).
:func:`conv2d_bwd_fused_plain` is that kernel's plain twin.

Both wrappers take f32 and bf16 (the bf16 path): each element type has its
entry point (:data:`_ENTRY`, :data:`_BWD_ENTRY`), bf16 with f32 sums,
rounded once to bf16 (the forward's bias added after the rounding, as the
JAX package adds it after ``conv2d_pallas``).  The bf16 forward runs on the
tensor cores where Cin is a multiple of 16 (``csrc/conv_fwd_mma.cu``,
tiled by :class:`ConvMmaPlan`; :func:`conv_bf16_plan` picks the route),
elsewhere on a bf16 instance of the f32 tiled template; the backward is
likewise on the tensor cores where C is a multiple of 16
(``csrc/conv_bwd_mma.cu``, tiled by :class:`ConvBwdMmaPlan`;
:func:`conv_bwd_bf16_plan` picks the route), elsewhere on a bf16 instance
of the f32 tiled backward.  bf16 has no general kernel: on the card it
takes K in :data:`CONV_KS` and a tile plan.  The int16 twins
(``conv2d.fxp``) share the argument contract, checks and plain dataflow
defined here; only the element type, the entry point and the conv itself
differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import masks
from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_image_operand, check_kernel_operands,
                                 on_card, validate_bp_gates)
from repro_torch.kernels.conv2d import ref
from repro_torch.kernels.pool.ref import unpool_scatter
from repro_torch.kernels.relu_mask.relu_mask import gate_gradient, unpack_bits
from repro_torch.kernels.tiling import (H100_SMS, align_up, cdiv,
                                        crumb_bytes, mask_bytes)
from repro_torch.obs.profile import instrument

#: ``csrc/conv2d.cu`` FW_TW and FW_MAX_THREADS: the forward's tile is
#: ``th`` rows x 8 pixels, at most 256 threads a block.
CONV_TILE_W, CONV_MAX_THREADS = 8, 256
#: Kernel sizes the register-tiled forward is compiled for (its tile holds a
#: row of PX + K - 1 inputs); ``repro_conv2d_fwd`` runs other odd K on the
#: general kernel it shares with the fused backward.
CONV_KS = (1, 3, 5, 7)
#: Images a conv forward launch covers at most (``csrc/common.cuh``
#: kBatchChunk): the batch rides ``gridDim.z`` (at most 65,535), so a larger
#: batch is launched in chunks, a multiple of 16 images each so every
#: chunk's pointers stay as aligned as the batch's.  An image is computed
#: alone, so the bits are those of one launch.
CONV_BATCH_CHUNK = 65520
#: Shared memory a block of the forward may stage (both ring stages): two
#: blocks, each with the 1 KB the card reserves, fit an SM's 228 KB.
CONV_SMEM_BUDGET = 112 * 1024
#: Cin channels per ring stage at most.
CONV_MAX_CIN_T = 32
#: Shared memory one block may use on an H100 (227 KB), an SM's in all
#: (228 KB) and what the card reserves per resident block.
CONV_SMEM_LIMIT = 227 * 1024
CONV_SMEM_PER_SM, CONV_SMEM_RESERVED = 228 * 1024, 1024
#: Threads a block aims for: among plans of about two blocks per SM, 128
#: were the fastest on the Table III layers, or within 1 % of it
#: (``python3 chip_smoke.py --sweep`` on an H100).
CONV_TARGET_THREADS = 128


@dataclass(frozen=True)
class ConvPlan:
    """The forward's tile: ``th`` rows x 8 pixels x ``tco`` output channels
    a block, ``px`` pixels (8 or 4) x 4 channels a thread, ``cin_t`` input
    channels a ring stage.  No field changes the order of any sum."""
    th: int
    px: int
    tco: int
    cin_t: int

    @property
    def threads(self) -> int:
        return self.th * (CONV_TILE_W // self.px) * (self.tco // 4)

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        return (cdiv(h, self.th) * cdiv(w, CONV_TILE_W)
                * cdiv(cout, self.tco) * n)

    def smem_bytes(self, k: int, *, esize: int = 4) -> int:
        """Both ring stages of ``esize``-byte elements (4 f32, 2 int16):
        the halo tile (rows padded to a multiple of 16 bytes, plus 16) and
        the weight slice, each stage rounded up to 16 bytes, as
        ``csrc/conv_fwd.cuh`` ``launch_tiled`` lays them out."""
        unit = 16 // esize
        xstride = align_up(self.cin_t, unit) + unit
        stage = ((self.th + k - 1) * (CONV_TILE_W + k - 1) * xstride
                 + k * k * self.cin_t * self.tco)
        return 2 * esize * align_up(stage, unit)

    def args(self) -> Tuple[int, int, int, int]:
        return (self.th, self.px, self.tco, self.cin_t)


def conv_cin_t(cin: int, k: int, th: int, px: int, tco: int, *,
               esize: int = 4) -> int:
    """Cin channels per ring stage of ``esize``-byte elements: up to 32,
    halved until both stages fit :data:`CONV_SMEM_BUDGET`; a multiple of
    16 bytes of elements (4 f32, 8 int16) where Cin is (16-byte copies)."""
    unit = 16 // esize
    step = unit if cin % unit == 0 else 1
    ct = max(1, min(cin, CONV_MAX_CIN_T) // step * step)
    while ct > step and ConvPlan(th, px, tco, ct).smem_bytes(
            k, esize=esize) > CONV_SMEM_BUDGET:
        ct = max(step, ct // 2 // step * step)
    return ct


def conv_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, *,
              esize: int = 4, sms: int = H100_SMS) -> ConvPlan:
    """The register-tiled forward's tile for one shape on an H100, for
    ``esize``-byte elements (4: B1 in f32, 2: B7 in int16).

    32 output channels a block (fewer where Cout is), and the tallest tile
    (up to 32 rows) whose grid still gives about two blocks per SM: at
    least twice the SMs rounded down to a power of two (256), as the tiles
    and the batch are powers of two.  Then 8 pixels a thread where that
    makes 128 threads, else 4 for twice the threads.  The element size
    only sets the chunk (:func:`conv_cin_t`): int16 stages take half the
    bytes, so a chunk halved for f32 may stay whole.  ``sms`` is the card's
    SM count (the tile planner passes its profile's).
    """
    if k not in CONV_KS:
        raise ValueError(f"conv2d: the tiled forward takes K in {CONV_KS}, "
                         f"got {k}")
    min_blocks = 1 << ((2 * sms).bit_length() - 1)
    tco = min(32, align_up(max(cout, 1), 4))
    th = min(32, 1 << max(0, (h - 1).bit_length()))
    while th > 1 and ConvPlan(th, 8, tco, 1).blocks(n, h, w, cout) \
            < min_blocks:
        th //= 2
    px = 8 if th * tco // 4 >= CONV_TARGET_THREADS else 4
    return ConvPlan(th, px, tco,
                    conv_cin_t(cin, k, th, px, tco, esize=esize))


#: The plan that selects the forward's general kernel (``conv_kernel`` /
#: ``conv_fxp_kernel``, the route of any K outside :data:`CONV_KS`); for
#: tests and sweeps that hold the tiled kernel against it.
CONV_GENERAL = ConvPlan(0, 0, 0, 0)


def conv_candidates(h: int, cin: int, cout: int, k: int, *,
                    esize: int = 4):
    """The register-tiled forward's tile plans that ``chip_smoke.py
    --sweep`` times for one layer (B1; B7 at ``esize`` 2) and the tile
    planner's autotuner measures: 1 to 32 rows (no more than H), 4 or 8
    pixels a thread, 4 to 64 output channels a block (no wider than Cout
    needs), chunks of 4 to 32 channels (whole 16-byte copies where Cin
    allows), 32 to 256 threads, within 227 KB of shared memory.  Every
    plan gives the same bits."""
    cts = sorted({min(c, cin) if cin % 4 else min(c, cin) // 4 * 4
                  for c in (4, 8, 16, 32)} - {0})
    out = []
    for th in (1, 2, 4, 8, 16, 32):
        for px in (4, 8):
            for tco in (4, 8, 16, 32, 64):
                for ct in cts:
                    p = ConvPlan(th, px, tco, ct)
                    if (th <= h and tco <= align_up(cout, 4)
                            and 32 <= p.threads <= CONV_MAX_THREADS
                            and p.smem_bytes(k, esize=esize)
                            <= CONV_SMEM_LIMIT):
                        out.append(p)
    return out

#: The bf16 tensor-core forward (``csrc/conv_fwd_mma.cu``): a tile row is
#: 16 pixels (one m16 fragment), a warp holds 32 output channels (four n8
#: fragments) of 1 or 2 rows, and a k step is one tap over 16 input
#: channels, so it takes Cin a multiple of 16.
CONV_MMA_TW, CONV_MMA_WN, CONV_MMA_K16 = 16, 32, 16
CONV_MMA_ROWS = (1, 2)
#: Cin channels a ring stage of the tensor-core forward at most.
CONV_MMA_MAX_CIN_T = 64


@dataclass(frozen=True)
class ConvMmaPlan:
    """The bf16 tensor-core forward's tile: ``th`` rows x 16 pixels x
    ``tco`` output channels (a multiple of 32) a block, ``mt`` rows (1 or
    2) x 32 channels a warp, ``cin_t`` input channels (a multiple of 16) a
    ring stage.  No field changes the order of any sum: each output walks
    the 16-channel groups, then the taps, in order."""
    th: int
    mt: int
    tco: int
    cin_t: int

    @property
    def threads(self) -> int:
        return 32 * (self.th // self.mt) * (self.tco // CONV_MMA_WN)

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        return (cdiv(h, self.th) * cdiv(w, CONV_MMA_TW)
                * cdiv(cout, self.tco) * n)

    def smem_bytes(self, k: int, cin: int) -> int:
        """The ring of 2-byte elements, as ``csrc/conv_fwd_mma.cu`` lays
        it out: a stage is the halo tile (a position's row of ``cin_t``
        channels padded by 16 bytes) then the weight slice (rows of
        ``tco`` padded by 16 bytes); two stages where Cin takes more than
        one, else one."""
        stage = ((self.th + k - 1) * (CONV_MMA_TW + k - 1) * (self.cin_t + 8)
                 + k * k * self.cin_t * (self.tco + 8))
        return 2 * (1 if self.cin_t >= cin else 2) * stage

    def args(self) -> Tuple[int, int, int, int]:
        return (self.th, self.mt, self.tco, self.cin_t)


def conv_mma_plan(n: int, h: int, w: int, cin: int, cout: int,
                  k: int, *, sms: int = H100_SMS) -> ConvMmaPlan:
    """The bf16 tensor-core forward's tile for one shape on an H100 (Cin a
    multiple of 16, K in :data:`CONV_KS`), from ``python3 chip_smoke.py
    --sweep`` on the Table III layers 1-3:

    32 output channels a block; the tallest tile (up to 16 rows) whose grid
    still gives a block per SM (128, the SMs rounded down to a power of
    two), one row a warp (two at 16 rows, so at most 8 warps); the largest
    chunk of up to 64 channels (whole 16-channel groups) within
    :data:`CONV_SMEM_BUDGET`, then fewer rows while the card's 227 KB is
    exceeded (K = 7).  On the three layers this is the sweep's fastest
    plan; 2-block-per-SM plans of 4 warps ran 12-32 % slower.
    """
    if k not in CONV_KS or cin % CONV_MMA_K16 or cin < CONV_MMA_K16:
        raise ValueError(f"conv2d: the tensor-core forward takes K in "
                         f"{CONV_KS} and Cin a multiple of 16, got K = {k}, "
                         f"Cin = {cin}")
    min_blocks = 1 << (sms.bit_length() - 1)
    tco = CONV_MMA_WN
    th = min(16, 1 << max(0, (h - 1).bit_length()))
    while th > 1 and ConvMmaPlan(th, 1, tco, 16).blocks(n, h, w, cout) \
            < min_blocks:
        th //= 2

    def plan(th: int, ct: int) -> ConvMmaPlan:
        return ConvMmaPlan(th, 2 if th == 16 else 1, tco, ct)

    ct = min(cin, CONV_MMA_MAX_CIN_T) // CONV_MMA_K16 * CONV_MMA_K16
    while ct > CONV_MMA_K16 and plan(th, ct).smem_bytes(k, cin) \
            > CONV_SMEM_BUDGET:
        ct = max(CONV_MMA_K16, ct // 2 // CONV_MMA_K16 * CONV_MMA_K16)
    while th > 1 and plan(th, ct).smem_bytes(k, cin) > CONV_SMEM_LIMIT:
        th //= 2
    return plan(th, ct)


def conv_mma_candidates(h: int, w: int, cin: int, cout: int, k: int):
    """The tensor-core tile plans ``chip_smoke.py --sweep`` times for one
    layer (and the card tests hold bitwise to each other): 1 to 16 rows,
    1 or 2 rows a warp, 32 or 64 channels a block (no wider than Cout
    needs), chunks of 16 to 64 channels (no deeper than Cin), within 256
    threads and 227 KB of shared memory."""
    out = []
    for th in (1, 2, 4, 8, 16):
        for mt in CONV_MMA_ROWS:
            for tco in (32, 64):
                for ct in (16, 32, 64):
                    p = ConvMmaPlan(th, mt, tco, ct)
                    if (th % mt == 0 and th <= max(1, h)
                            and tco <= align_up(max(cout, 1), CONV_MMA_WN)
                            and ct <= cin and p.threads <= CONV_MAX_THREADS
                            and p.smem_bytes(k, cin) <= CONV_SMEM_LIMIT):
                        out.append(p)
    return out


def conv_bf16_plan(n: int, h: int, w: int, cin: int, cout: int,
                   k: int, *, sms: int = H100_SMS):
    """The route and tile of a bf16 forward layer on an H100: the
    tensor-core kernel (:func:`conv_mma_plan`) where Cin is a multiple of
    16, the FFMA instance (:func:`conv_plan` at 2-byte elements) elsewhere.
    Table III's layer 0 (Cin = 3) stays on FFMA, which beats cuDNN's bf16
    conv there; layers 1-3 (Cin 32, 32, 64) take the tensor cores."""
    if cin % CONV_MMA_K16 == 0 and cin > 0:
        return conv_mma_plan(n, h, w, cin, cout, k, sms=sms)
    return conv_plan(n, h, w, cin, cout, k, esize=2, sms=sms)


def _check_fwd_plan(name: str, plan, k: int, esize: int, cin: int,
                    dtype: torch.dtype) -> None:
    """Raise unless the forward can run ``plan`` (a :class:`ConvPlan`, or
    a :class:`ConvMmaPlan` on bf16) at kernel size ``k`` on
    ``esize``-byte elements and ``cin`` input channels."""
    if plan == CONV_GENERAL:
        return
    if k not in CONV_KS:
        raise ValueError(f"{name}: a tile plan needs K in {CONV_KS}, got {k}")
    if isinstance(plan, ConvMmaPlan):
        if dtype != torch.bfloat16:
            raise ValueError(f"{name}: the tensor-core route is bf16's only, "
                             f"got {dtype}")
        if (cin % CONV_MMA_K16 or cin < CONV_MMA_K16
                or plan.mt not in CONV_MMA_ROWS or plan.th < plan.mt
                or plan.th % plan.mt or plan.tco < CONV_MMA_WN
                or plan.tco % CONV_MMA_WN or plan.cin_t < CONV_MMA_K16
                or plan.cin_t % CONV_MMA_K16
                or plan.threads > CONV_MAX_THREADS
                or plan.smem_bytes(k, cin) > CONV_SMEM_LIMIT):
            raise ValueError(f"{name}: invalid tile plan {plan} for Cin "
                             f"{cin}")
        return
    if (plan.px not in (4, 8) or plan.tco < 4 or plan.tco % 4
            or plan.th < 1 or plan.cin_t < 1
            or plan.threads > CONV_MAX_THREADS
            or plan.smem_bytes(k, esize=esize) > CONV_SMEM_LIMIT):
        raise ValueError(f"{name}: invalid tile plan {plan}")


#: Seeds a thread of the tiled fused backward sums at once (its register
#: micro-tile is seeds x PX pixels x 4 channels): ``csrc/conv_bwd.cuh`` is
#: compiled for 1, 2 and 3 at PX = 4 and for 1 at PX = 8 (more spill).
CONV_BWD_SEED_GROUPS = (1, 2, 3)
#: Output channels a block of the fused backward holds at most.
CONV_MAX_TCO_BWD = 64
#: The fused backward puts a launch's seeds in each thread where that
#: leaves this many warps an SM, and across thread slices where not (the
#: sweep's winners: in-thread on the pooled Table III layers, 8 and 16
#: warps an SM; slices on the unpooled ones, 4 and 2).
CONV_BWD_MIN_WARPS_PER_SM = 6


@dataclass(frozen=True)
class ConvBwdPlan:
    """The tiled fused backward's tile: ``th`` rows x 8 pixels x ``tco``
    output channels x ``sg * st`` seeds a block, in ``st`` slices of
    threads, each thread ``px`` pixels (8 or 4) x 4 channels x ``sg``
    seeds; ``cin_t`` gradient channels a ring stage.  No field changes the
    order of any sum.  :data:`CONV_BWD_GENERAL` (all zeros) selects the
    general kernel instead."""
    th: int
    px: int
    tco: int
    cin_t: int
    sg: int
    st: int = 1

    @property
    def seeds(self) -> int:
        """Seeds a block holds (its residual reads serve all of them)."""
        return self.sg * self.st

    @property
    def threads(self) -> int:
        return (self.st * self.th * (CONV_TILE_W // self.px)
                * (self.tco // 4))

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        return (cdiv(h, self.th) * cdiv(w, CONV_TILE_W)
                * cdiv(cout, self.tco) * n)

    def smem_bytes(self, k: int, *, pooled: bool = False,
                   esize: int = 4) -> int:
        """The compute buffer (gated inputs as 32-bit words, rows padded to
        4) and both ring stages (the landing buffer of ``esize``-byte
        gradients, pooled: the Hg x Wg tile, then the weight slice), as
        ``csrc/conv_bwd.cuh`` ``launch_tiled`` lays them out."""
        xh, xw = self.th + k - 1, CONV_TILE_W + k - 1
        gh, gw = (xh // 2 + 1, xw // 2 + 1) if pooled else (xh, xw)
        unit = 16 // esize
        lstride = align_up(self.cin_t, unit) + unit
        xs = 4 * self.seeds * self.cin_t * xh * align_up(xw, 4)
        land = esize * self.seeds * gh * gw * lstride
        wts = align_up(esize * k * k * self.cin_t * self.tco, 16)
        return xs + 2 * (land + wts)

    def args(self) -> Tuple[int, int, int, int, int, int]:
        return (self.th, self.px, self.tco, self.cin_t, self.sg, self.st)


#: The plan that selects the general fused-backward kernel (``conv_kernel``,
#: the route of any K outside :data:`CONV_KS`); for tests and sweeps that
#: hold the tiled kernel against it.
CONV_BWD_GENERAL = ConvBwdPlan(0, 0, 0, 0, 0, 0)


def _check_bwd_plan(plan, k: int, *, pooled: bool, esize: int, c: int,
                    s: int, dtype: torch.dtype) -> None:
    """Raise unless the fused backward can run ``plan`` (a
    :class:`ConvBwdPlan`, or a :class:`ConvBwdMmaPlan` on bf16) at kernel
    size ``k`` (pooled or not, on ``esize``-byte elements, ``c`` gradient
    channels, ``s`` seeds)."""
    if plan == CONV_BWD_GENERAL:
        return
    if k not in CONV_KS:
        raise ValueError(f"conv2d_bwd_fused: a tile plan needs K in "
                         f"{CONV_KS}, got {k}")
    if isinstance(plan, ConvBwdMmaPlan):
        if dtype != torch.bfloat16:
            raise ValueError(f"conv2d_bwd_fused: the tensor-core route is "
                             f"bf16's only, got {dtype}")
        if (c % CONV_MMA_K16 or c < CONV_MMA_K16
                or plan.sg not in CONV_BWD_SEED_GROUPS or plan.st < 1
                or plan.mt < 1 or plan.frags > CONV_BWD_MMA_FRAGS
                or plan.th < plan.mt or plan.th % plan.mt
                or (plan.tco != CONV_BWD_MMA_N8 and (
                    plan.tco < CONV_MMA_WN or plan.tco % CONV_MMA_WN))
                or plan.cin_t < CONV_MMA_K16 or plan.cin_t % CONV_MMA_K16
                or plan.threads > CONV_MAX_THREADS
                or plan.smem_bytes(k, c, s, pooled=pooled)
                > CONV_SMEM_LIMIT):
            raise ValueError(f"conv2d_bwd_fused: invalid tile plan {plan} "
                             f"for C {c}")
        return
    if (plan.px not in (4, 8) or plan.tco < 4 or plan.tco % 4
            or plan.th < 1 or plan.cin_t < 1
            or plan.sg not in CONV_BWD_SEED_GROUPS
            or (plan.px == 8 and plan.sg != 1) or plan.st < 1
            or plan.threads > CONV_MAX_THREADS
            or plan.smem_bytes(k, pooled=pooled, esize=esize)
            > CONV_SMEM_LIMIT):
        raise ValueError(f"conv2d_bwd_fused: invalid tile plan {plan}")


def conv_bwd_plan(s: int, n: int, h: int, w: int, c: int, cout: int,
                  k: int, *, pooled: bool = False,
                  esize: int = 4, sms: int = H100_SMS) -> ConvBwdPlan:
    """The tiled fused backward's tile for one launch on an H100 (``h``,
    ``w``: the output size; ``c`` the gradient's channels, ``cout`` the
    outgoing ones; ``esize`` bytes an element: 4 f32, 2 int16), from
    ``python3 chip_smoke.py --sweep`` on the Table III launches:

    * all S seeds in one block (up to 3; groups of 3 beyond): in each
      thread (``sg``) where the launch still has
      :data:`CONV_BWD_MIN_WARPS_PER_SM` warps an SM of such threads, else
      one seed a thread in ``st`` slices (the unpooled layers 2 and 0);
    * 64 output channels a block (fewer where Cout is);
    * the tallest tile (up to 32 rows) of at most 256 threads whose grid
      still gives a block per SM (128, the SMs rounded down to a power of
      two), at 4 pixels a thread, or at 8 where one seed is all a block
      holds and 8 make the tile taller (layer 1 of the vjp path);
    * the largest chunk of up to 32 channels (a multiple of
      :func:`bwd_cin_step`) whose shared memory lets as many blocks reside
      on an SM as the grid puts there; where even the smallest chunk does
      not fit the card's 227 KB (K = 7), fewer rows, then fewer channels a
      block, then a smaller chunk.
    """
    if k not in CONV_KS:
        raise ValueError(f"conv2d_bwd_fused: the tiled kernel takes K in "
                         f"{CONV_KS}, got {k}")
    seeds = min(max(s, 1), max(CONV_BWD_SEED_GROUPS))
    tco = min(CONV_MAX_TCO_BWD, align_up(max(cout, 1), 4))
    # threads of the launch with the seeds in each thread: 4 pixels x 4
    # channels a thread (seed groups beyond the first run in turn)
    threads = n * h * w * align_up(max(cout, 1), 4) // 16
    sg, st = ((seeds, 1) if threads
              >= CONV_BWD_MIN_WARPS_PER_SM * 32 * sms else (1, seeds))
    min_blocks = 1 << (sms.bit_length() - 1)

    def rows(px: int) -> int:
        th = min(32, 1 << max(0, (h - 1).bit_length()))
        while th > 1 and (
                ConvBwdPlan(th, px, tco, 1, sg, st).threads > CONV_MAX_THREADS
                or ConvBwdPlan(th, px, tco, 1, sg, st).blocks(n, h, w, cout)
                < min_blocks):
            th //= 2
        return th

    px, th = 4, rows(4)
    if sg == st == 1 and rows(8) > th:
        px, th = 8, rows(8)

    def fits(p: ConvBwdPlan) -> bool:
        per_sm = min(cdiv(p.blocks(n, h, w, cout), sms),
                     2048 // p.threads)
        return per_sm * (p.smem_bytes(k, pooled=pooled, esize=esize)
                         + CONV_SMEM_RESERVED) <= CONV_SMEM_PER_SM

    step = bwd_cin_step(c)
    ct = max(1, min(c, CONV_MAX_CIN_T) // step * step)
    while ct > step and not fits(ConvBwdPlan(th, px, tco, ct, sg, st)):
        ct = max(step, ct // 2 // step * step)
    while ConvBwdPlan(th, px, tco, ct, sg, st).smem_bytes(
            k, pooled=pooled, esize=esize) > CONV_SMEM_LIMIT:
        if th > 1:
            th //= 2
        elif tco > 4:
            tco = align_up(tco // 2, 4)
        else:
            ct = max(1, ct // 2)
    return ConvBwdPlan(th, px, tco, ct, sg, st)


def bwd_cin_step(c: int) -> int:
    """The chunk granule of the fused backward at ``c`` channels: 8 where
    whole 16-byte copies of int16 rows fit, 4 where those of f32 do."""
    return 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1


def conv_bwd_candidates(s: int, h: int, c: int, cout: int, k: int, *,
                        pooled: bool = False, esize: int = 4):
    """The tiled fused backward's plans that ``chip_smoke.py --sweep``
    times for one launch (B5; B8 at ``esize`` 2) and the tile planner's
    autotuner measures: 1 to 32 rows (no more than the output's H), 4 or 8
    pixels a thread (8 with one seed a thread), 4 to 64 output channels a
    block (no wider than Cout' needs), chunks of 8, 16 or 32 channels (no
    deeper than C), one seed, or all S up to 3 in a thread or across
    thread slices, 32 to 256 threads, within 227 KB of shared memory.
    Every plan gives the same bits."""
    seeds = {(1, 1), (min(s, 3), 1), (1, min(s, 3))}   # (sg, st)
    out = []
    for th in (1, 2, 4, 8, 16, 32):
        for px in (4, 8):
            for tco in (4, 8, 16, 32, 64):
                for ct in sorted({min(8, c), min(16, c), min(32, c)}):
                    for sg, st in sorted(seeds):
                        p = ConvBwdPlan(th, px, tco, ct, sg, st)
                        if (th <= h and tco <= align_up(cout, 4)
                                and (px == 4 or sg == 1)
                                and 32 <= p.threads <= CONV_MAX_THREADS
                                and p.smem_bytes(k, pooled=pooled,
                                                 esize=esize)
                                <= CONV_SMEM_LIMIT):
                            out.append(p)
    return out


#: The bf16 tensor-core fused backward (``csrc/conv_bwd_mma.cu``): a tile
#: row is 16 pixels (one m16 fragment, :data:`CONV_MMA_TW`), a block holds 8
#: output channels (one n8 fragment, for Cout' up to 8) or a multiple of 32
#: (four n8 fragments a warp), a warp at most 3 m16 fragments (seeds x
#: rows), and a k step is one tap over 16 channels, so it takes C a
#: multiple of 16.
CONV_BWD_MMA_N8, CONV_BWD_MMA_FRAGS = 8, 3
#: C channels a ring stage of the tensor-core backward at most.
CONV_BWD_MMA_MAX_CIN_T = 64


@dataclass(frozen=True)
class ConvBwdMmaPlan:
    """The bf16 tensor-core fused backward's tile: ``th`` rows x 16 pixels
    x ``tco`` output channels (8, or a multiple of 32) x ``sg * st`` seeds
    a block, in ``st`` seed slices of warps, each warp ``mt`` rows x ``sg``
    seeds (``sg * mt`` m16 fragments, at most 3) x 8 or 32 channels;
    ``cin_t`` gradient channels (a multiple of 16) a ring stage.  No field
    changes the order of any sum: each output walks the 16-channel groups,
    then the taps, in order."""
    th: int
    mt: int
    tco: int
    cin_t: int
    sg: int
    st: int = 1

    @property
    def seeds(self) -> int:
        """Seeds a block holds (its residual reads serve all of them)."""
        return self.sg * self.st

    @property
    def frags(self) -> int:
        """m16 fragments a warp holds (the kernel's template argument)."""
        return self.sg * self.mt

    @property
    def wn(self) -> int:
        """Output channels a warp holds: 8 at ``tco`` 8, else 32."""
        return CONV_BWD_MMA_N8 if self.tco == CONV_BWD_MMA_N8 else CONV_MMA_WN

    @property
    def threads(self) -> int:
        return (32 * (self.th // self.mt) * (self.tco // self.wn)
                * self.st)

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        return (cdiv(h, self.th) * cdiv(w, CONV_MMA_TW)
                * cdiv(cout, self.tco) * n)

    def smem_bytes(self, k: int, c: int, s: int, *,
                   pooled: bool = False) -> int:
        """As ``csrc/conv_bwd_mma.cu`` lays it out: the pooled layers'
        compute buffer (the halo tile, a position's row of ``cin_t`` 2-byte
        channels padded by 16 bytes, per seed), then the ring: a stage is
        the landing buffer (the seeds' gradient, pooled the Hg x Wg quarter
        tile; unpooled it is gated in place and is the compute buffer), the
        weight slice (rows of ``tco`` rounded up to an odd number of
        8-channel units) and the chunk's residual bytes (a mask byte per 8
        channels of each halo position, then, pooled, a crumb byte per 4 of
        each landing position, each part rounded up to 16 bytes), or a seed
        group's output tile where that is larger (it is written into the
        stage its products were summed from); two stages where the launch
        has more than one (seed group, chunk) pair, else one."""
        xh, xw = self.th + k - 1, CONV_MMA_TW + k - 1
        gh, gw = (xh // 2 + 1, xw // 2 + 1) if pooled else (xh, xw)
        xstride = self.cin_t + 8
        wstride = 8 * ((self.tco // 8) | 1)
        xs = self.seeds * xh * xw * xstride if pooled else 0
        res = (align_up(xh * xw * self.cin_t // 8, 16)
               + (align_up(gh * gw * self.cin_t // 4, 16) if pooled else 0))
        stage = max(2 * (self.seeds * gh * gw * xstride
                         + k * k * self.cin_t * wstride) + res,
                    2 * self.seeds * self.th * CONV_MMA_TW * wstride)
        pairs = cdiv(max(s, 1), self.seeds) * cdiv(c, self.cin_t)
        return 2 * xs + (2 if pairs > 1 else 1) * stage

    def args(self) -> Tuple[int, int, int, int, int, int]:
        return (self.th, self.mt, self.tco, self.cin_t, self.sg, self.st)


def conv_bwd_mma_plan(s: int, n: int, h: int, w: int, c: int, cout: int,
                      k: int, *, pooled: bool = False,
                      sms: int = H100_SMS) -> ConvBwdMmaPlan:
    """The bf16 tensor-core fused backward's tile for one launch on an H100
    (C a multiple of 16, K in :data:`CONV_KS`; ``h``, ``w`` the output
    size), from ``python3 chip_smoke.py --sweep`` on the Table III
    launches:

    * 8 output channels a block where Cout' is at most 8 (one n8
      fragment: Table III's layer 0), 64 where Cout' is 64 or more, else
      32;
    * the tallest tile (up to 8 rows, 256 threads at a row a warp) whose
      grid still gives a block per SM (128, the SMs rounded down to a
      power of two);
    * all S seeds in one block (up to 3; groups of 3 beyond), all of them
      in each warp, so a warp's B fragments serve every seed; where that
      leaves fewer than 8 warps (layer 2), one seed a warp in S slices at
      two rows a warp;
    * the largest chunk of up to 64 channels (whole 16-channel groups)
      whose shared memory lets as many blocks reside on an SM as the grid
      puts there; where even 16 do not fit the card's 227 KB, fewer rows,
      then 32 channels a block.

    On the four Table III launches this is the sweep's fastest plan or
    within 4 % of it.
    """
    if k not in CONV_KS or c % CONV_MMA_K16 or c < CONV_MMA_K16:
        raise ValueError(f"conv2d_bwd_fused: the tensor-core backward takes "
                         f"K in {CONV_KS} and C a multiple of 16, got "
                         f"K = {k}, C = {c}")
    seeds = min(max(s, 1), max(CONV_BWD_SEED_GROUPS))
    tco = (CONV_BWD_MMA_N8 if cout <= CONV_BWD_MMA_N8
           else 2 * CONV_MMA_WN if cout >= 2 * CONV_MMA_WN else CONV_MMA_WN)
    min_blocks = 1 << (sms.bit_length() - 1)
    th = min(8, 1 << max(0, (h - 1).bit_length()))
    while th > 1 and (
            ConvBwdMmaPlan(th, 1, tco, 16, seeds).threads > CONV_MAX_THREADS
            or ConvBwdMmaPlan(th, 1, tco, 16, seeds).blocks(n, h, w, cout)
            < min_blocks):
        th //= 2

    def plan(th: int, ct: int, tco: int) -> ConvBwdMmaPlan:
        p = ConvBwdMmaPlan(th, 1, tco, ct, seeds)
        if p.threads < 8 * 32 and seeds > 1 and th % 2 == 0:
            p = ConvBwdMmaPlan(th, 2, tco, ct, 1, seeds)
        return p

    def fits(p: ConvBwdMmaPlan) -> bool:
        per_sm = min(cdiv(p.blocks(n, h, w, cout), sms),
                     2048 // p.threads)
        return per_sm * (p.smem_bytes(k, c, s, pooled=pooled)
                         + CONV_SMEM_RESERVED) <= CONV_SMEM_PER_SM

    ct = min(c, CONV_BWD_MMA_MAX_CIN_T) // CONV_MMA_K16 * CONV_MMA_K16
    while ct > CONV_MMA_K16 and not fits(plan(th, ct, tco)):
        ct = max(CONV_MMA_K16, ct // 2 // CONV_MMA_K16 * CONV_MMA_K16)
    while plan(th, ct, tco).smem_bytes(
            k, c, s, pooled=pooled) > CONV_SMEM_LIMIT:
        if th > 1:
            th //= 2
        elif tco > CONV_MMA_WN:
            tco = CONV_MMA_WN
        else:
            break
    return plan(th, ct, tco)


def conv_bwd_mma_candidates(s: int, h: int, w: int, c: int, cout: int,
                            k: int, *, pooled: bool = False):
    """The tensor-core tile plans ``chip_smoke.py --sweep`` times for one
    launch (and the card tests hold bitwise to each other): 1 to 16 rows,
    1 to 3 rows a warp, the S seeds (up to 3) in each warp or one a warp,
    8, 32 or 64 channels a block (no wider than Cout' needs), chunks of 16
    to 64 channels (no deeper than C), within 256 threads and 227 KB of
    shared memory."""
    seeds = min(max(s, 1), max(CONV_BWD_SEED_GROUPS))
    out = []
    for th in (1, 2, 4, 8, 16):
        for mt in (1, 2, 3):
            for sg, st in sorted({(seeds, 1), (1, seeds)}, reverse=True):
                for tco in (CONV_BWD_MMA_N8, 32, 64):
                    for ct in (16, 32, 64):
                        p = ConvBwdMmaPlan(th, mt, tco, ct, sg, st)
                        if (th % mt == 0 and th <= max(1, h)
                                and p.frags <= CONV_BWD_MMA_FRAGS
                                and tco <= max(CONV_BWD_MMA_N8,
                                               align_up(cout, CONV_MMA_WN))
                                and ct <= c
                                and p.threads <= CONV_MAX_THREADS
                                and p.smem_bytes(k, c, s, pooled=pooled)
                                <= CONV_SMEM_LIMIT):
                            out.append(p)
    return out


def conv_bwd_bf16_plan(s: int, n: int, h: int, w: int, c: int, cout: int,
                       k: int, *, pooled: bool = False,
                       sms: int = H100_SMS):
    """The route and tile of a bf16 fused-backward launch on an H100: the
    tensor-core kernel (:func:`conv_bwd_mma_plan`) where C is a multiple
    of 16, as on all four Table III layers, the FFMA instance
    (:func:`conv_bwd_plan` at 2-byte elements) elsewhere."""
    if c % CONV_MMA_K16 == 0 and c > 0:
        return conv_bwd_mma_plan(s, n, h, w, c, cout, k, pooled=pooled,
                                 sms=sms)
    return conv_bwd_plan(s, n, h, w, c, cout, k, pooled=pooled, esize=2,
                         sms=sms)


def _check_kernel(name, w, cin, dtype):
    if (w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0
            or w.shape[2] != cin):
        raise ValueError(f"{name}: kernel must be [K, K, {cin}, Cout] with "
                         f"odd K, got {tuple(w.shape)}")
    check(name, w, dtype, what="kernel")


def _fwd_dims(name: str, dtypes: tuple, x: torch.Tensor,
              w: torch.Tensor, b: Optional[torch.Tensor]):
    """Check the forward's operands (x of one of ``dtypes``, w and b of
    x's); ``(n, h, w, cin, cout, k)``."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [N, H, W, Cin], got "
                         f"{tuple(x.shape)}")
    n, h, wd, cin = x.shape
    check(name, x, dtypes, what="x")
    _check_kernel(name, w, cin, x.dtype)
    k, cout = w.shape[0], w.shape[3]
    if b is not None:
        check(name, b, x.dtype, (cout,), what="b")
    return n, h, wd, cin, cout, k


def _check_general(name: str, dtype: torch.dtype, general: bool) -> None:
    """Raise where the card has no kernel for the general plan: bf16 is
    an instance of the tiled templates only."""
    if general and dtype == torch.bfloat16:
        raise ValueError(f"{name}: bf16 has no general kernel; on the card "
                         f"it takes K in {CONV_KS} and a tile plan")


def conv_fwd(name: str, counter: str, entries: dict, plain: Callable,
             x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             plan) -> torch.Tensor:
    """Check, then run ``plain(x, w, b)`` on the CPU or launch the entry
    of x's element type (``entries``) tiled by ``plan``: when it is None
    and K is in :data:`CONV_KS`, :func:`conv_bf16_plan`'s for bf16 and
    :func:`conv_plan`'s otherwise; the general kernel's zeros for any
    other K.  The bf16 entry takes its route first (1 for a
    :class:`ConvMmaPlan`, 0 for a :class:`ConvPlan`)."""
    n, h, wd, cin, cout, k = _fwd_dims(name, tuple(entries), x, w, b)
    esize, bf16 = x.element_size(), x.dtype == torch.bfloat16
    if plan is None:
        plan = (CONV_GENERAL if k not in CONV_KS
                else conv_bf16_plan(n, h, wd, cin, cout, k) if bf16
                else conv_plan(n, h, wd, cin, cout, k, esize=esize))
    _check_fwd_plan(name, plan, k, esize, cin, x.dtype)
    if not on_card(name, x, w, b):
        return plain(x, w, b)
    _check_general(name, x.dtype, plan == CONV_GENERAL)
    # each image offset in 64 bits: any batch, in chunks of CONV_BATCH_CHUNK
    check_image_operand(name, x)
    check_kernel_operands(name, w, b)
    mma = isinstance(plan, ConvMmaPlan)
    # bf16: the route argument, and the kernel it selects counted apart
    route, counted = (((int(mma),), dict(route="conv2d_fwd_bf16_mma" if mma
                                          else "conv2d_fwd_bf16_ffma"))
                      if bf16 else ((), {}))
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch(counter, entries[x.dtype], x.device, x.data_ptr(),
                      w.data_ptr(), _build.ptr(b), y.data_ptr(), n, h, wd,
                      cin, cout, k, *route, *plan.args(), **counted)
    return y


#: Forward entry point per element type: f32, and bf16 for the bf16 path.
_ENTRY = {torch.float32: "repro_conv2d_fwd",
          torch.bfloat16: "repro_conv2d_fwd_bf16"}


def _conv2d_plain(x, w, b):
    """The plain conv, then ``+ b`` in x's type (bf16: after the
    rounding, as the reference adds it)."""
    y = (ref.conv2d_bf16(x, w) if x.dtype == torch.bfloat16
         else ref.conv2d(x, w))
    return y if b is None else y + b


@instrument("conv2d_fwd")
def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *, plan=None) -> torch.Tensor:
    """[N, H, W, Cin] x [K, K, Cin, Cout] (+ b [Cout]) -> [N, H, W, Cout],
    stride 1, SAME padding, odd K, f32 accumulation; f32 or bf16 (rounded
    once, then ``+ b`` in bf16).

    CPU tensors run :func:`ref.conv2d` / :func:`ref.conv2d_bf16` (then
    ``+ b``); CUDA tensors the kernel, tiled by ``plan`` (a tile planner's
    entry, see :func:`conv2d_planned`) or, when it is None, by
    :func:`conv_plan` for K in :data:`CONV_KS` (bf16:
    :func:`conv_bf16_plan`, the tensor cores where Cin is a multiple of
    16).
    """
    return conv2d_planned(x, w, b, plan=plan)


def conv2d_planned(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None, *,
                   plan=None) -> torch.Tensor:
    """:func:`conv2d` with the tile chosen by the caller, for tests, sweeps
    and the tile planner: every :class:`ConvPlan`, and :data:`CONV_GENERAL`,
    gives the
    same bits; on bf16 a :class:`ConvPlan` selects the FFMA route and a
    :class:`ConvMmaPlan` the tensor-core route, every plan of a route the
    same bits (the two routes sum in other orders).  One count of
    ``conv2d_fwd`` per call."""
    return conv_fwd("conv2d", "conv2d_fwd", _ENTRY, _conv2d_plain, x, w, b,
                    plan)


def bwd_fused_plain(conv: Callable, g, wt, *, pool_idx=None, relu_mask=None,
                    gate=None, method="saliency", out_relu_mask=None,
                    out_gate=None):
    """Unpool, gate, ``conv(g, wt)``, gate, as separate PyTorch ops."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 5
    if not seeded:
        g = g[None]
    s, n, _, _, c = g.shape
    cout = wt.shape[-1]
    if pool_idx is not None:
        g = unpool_scatter(masks.unpack_crumbs(pool_idx, c), g)
    if gate:
        bits = None if relu_mask is None else unpack_bits(relu_mask)[..., :c]
        g = gate_gradient(g, bits, method)
    h, w = g.shape[2:4]
    out = conv(g.reshape(s * n, h, w, c), wt).reshape(s, n, h, w, cout)
    if out_gate:
        bits = (None if out_relu_mask is None
                else unpack_bits(out_relu_mask)[..., :cout])
        out = gate_gradient(out, bits, method)
    return out if seeded else out[0]


def conv2d_bwd_fused_plain(g, wt, **kw):
    """Plain twin of :func:`conv2d_bwd_fused`: unpool, gate, conv, gate, as
    separate PyTorch ops; bf16 sums the widened values in f32 and rounds
    once, after the epilogue gate."""
    if g.dtype == torch.bfloat16:
        return bwd_fused_plain(ref.conv2d_widened, g, wt, **kw).to(
            torch.bfloat16)
    return bwd_fused_plain(ref.conv2d, g, wt, **kw)


#: Fused-backward entry point per element type: f32, and bf16.
_BWD_ENTRY = {torch.float32: "repro_conv2d_bwd_fused",
              torch.bfloat16: "repro_conv2d_bwd_fused_bf16"}


def bwd_fused(name: str, entries: dict, plain: Callable,
              g: torch.Tensor, wt: torch.Tensor, *, pool_idx, relu_mask,
              gate, method, out_relu_mask, out_gate,
              plan=None) -> torch.Tensor:
    """Check the fused-backward operands, then run ``plain`` on the CPU or
    launch the entry of g's element type (``entries``, counted under
    ``name``): tiled by ``plan``, when it is None and K is in
    :data:`CONV_KS` by :func:`conv_bwd_bf16_plan` for bf16 and
    :func:`conv_bwd_plan` otherwise, on the general kernel for any other K
    or :data:`CONV_BWD_GENERAL`.  The bf16 entry takes its route first (1
    for a :class:`ConvBwdMmaPlan`, 0 for a :class:`ConvBwdPlan`)."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 5
    g5 = g if seeded else g[None]
    if g5.dim() != 5:
        raise ValueError(f"{name}: g must be [S, N, H, W, C] or [N, H, W, C],"
                         f" got {tuple(g.shape)}")
    s, n, hg, wg, c = g5.shape
    check(name, g5, tuple(entries), what="g")
    _check_kernel(name, wt, c, g.dtype)
    k, cout = wt.shape[0], wt.shape[3]
    h, w = (2 * hg, 2 * wg) if pool_idx is not None else (hg, wg)
    if pool_idx is not None:
        check(name, pool_idx, torch.uint8, (n, hg, wg, crumb_bytes(c)),
              what="pool_idx")
    if relu_mask is not None:
        check(name, relu_mask, torch.uint8, (n, h, w, mask_bytes(c)),
              what="relu_mask")
    if out_relu_mask is not None:
        check(name, out_relu_mask, torch.uint8, (n, h, w, mask_bytes(cout)),
              what="out_relu_mask")
    pooled, esize = pool_idx is not None, g.element_size()
    bf16 = g.dtype == torch.bfloat16
    if plan is None:
        plan = (CONV_BWD_GENERAL if k not in CONV_KS
                else conv_bwd_bf16_plan(s, n, h, w, c, cout, k,
                                        pooled=pooled) if bf16
                else conv_bwd_plan(s, n, h, w, c, cout, k, pooled=pooled,
                                   esize=esize))
    _check_bwd_plan(plan, k, pooled=pooled, esize=esize, c=c, s=s,
                    dtype=g.dtype)
    if not on_card(name, g5, wt, pool_idx, relu_mask, out_relu_mask):
        return plain(
            g, wt, pool_idx=pool_idx, relu_mask=relu_mask, gate=gate,
            method=method, out_relu_mask=out_relu_mask, out_gate=out_gate)
    _check_general(name, g.dtype, plan == CONV_BWD_GENERAL)
    check_kernel_operands(name, g5, wt, pool_idx, relu_mask, out_relu_mask)
    mma = isinstance(plan, ConvBwdMmaPlan)
    # bf16: the route argument, and the kernel it selects counted apart
    route, counted = (((int(mma),), dict(
        route="conv2d_bwd_fused_bf16_mma" if mma
        else "conv2d_bwd_fused_bf16_ffma")) if bf16 else ((), {}))
    out = torch.empty((s, n, h, w, cout), dtype=g.dtype, device=g.device)
    if out.numel():
        _build.launch(name, entries[g.dtype], g.device, g5.data_ptr(),
                      wt.data_ptr(),
                      _build.ptr(pool_idx), _build.ptr(relu_mask),
                      _build.ptr(out_relu_mask), out.data_ptr(), s, n, h, w,
                      c, cout, k, int(gate), int(out_gate),
                      METHOD_CODES[method], *route, *plan.args(), **counted)
    return out if seeded else out[0]


@instrument("conv2d_bwd")
def conv2d_bwd_fused(
        g: torch.Tensor, wt: torch.Tensor, *,
        pool_idx: Optional[torch.Tensor] = None,
        relu_mask: Optional[torch.Tensor] = None,
        gate: Optional[bool] = None,
        method: str = "saliency",
        out_relu_mask: Optional[torch.Tensor] = None,
        out_gate: Optional[bool] = None,
        plan=None) -> torch.Tensor:
    """One launch for a conv layer's whole backward step.

    ``g``:        gradients w.r.t. the layer output, [N, Hg, Wg, C] or
                  seed-batched [S, N, Hg, Wg, C] (Hg = H/2 when pooled).
    ``wt``:       flip-transposed kernel [K, K, C, Cout'] (made once by the
                  caller with ``ref.flip_transpose(w)``; Cout' is the
                  forward Cin).
    ``pool_idx``: [N, Hg, Wg, ceil(C/4)] packed 2-bit argmax (None: no pool).
    ``relu_mask``: [N, H, W, ceil(C/8)] packed 1-bit mask of the layer's
                  ReLU; ``gate=True`` with no mask selects deconvnet.
    ``out_relu_mask``/``out_gate``: the same as an epilogue on the outgoing
                  gradient, [N, H, W, ceil(Cout'/8)].
    ``plan``:     the tile (tests, sweeps): :func:`conv_bwd_plan`'s by
                  default (bf16: :func:`conv_bwd_bf16_plan`'s),
                  :data:`CONV_BWD_GENERAL` for the general kernel; every
                  plan gives the same bits, but for bf16, where a
                  :class:`ConvBwdPlan` selects the FFMA route and a
                  :class:`ConvBwdMmaPlan` the tensor cores, every plan of a
                  route the same bits (the two routes sum in other orders).
    Residuals carry no seeds axis: the seeds of a block share one load, all
    S of them for S <= 3 (groups of 3 beyond).  ``g`` and ``wt`` are f32 or
    bf16 (f32 sums, rounded once after the epilogue gate).
    CPU tensors run :func:`conv2d_bwd_fused_plain`; CUDA tensors the kernel.
    """
    return bwd_fused("conv2d_bwd_fused", _BWD_ENTRY,
                     conv2d_bwd_fused_plain, g, wt,
                     pool_idx=pool_idx, relu_mask=relu_mask, gate=gate,
                     method=method, out_relu_mask=out_relu_mask,
                     out_gate=out_gate, plan=plan)
