"""Analytic footprint / cost model per kernel family.

Two models behind one :class:`Footprint`:

* **The JAX package's TPU model** (``repro.plan.model``, formula for
  formula): for a candidate TPU tile, the on-chip bytes ONE grid cell
  holds (input / output blocks, packed residual blocks, accumulator
  scratch, the im2col patch matrix), the HBM bytes the whole call moves,
  and the share of the MAC array its dot shapes occupy.  These are audits
  on the card: the CUDA kernels have no VMEM block of that size.
* **The card's model** (:func:`card_footprint`, under a
  :class:`~repro_torch.plan.profiles.GpuProfile`): for one of the CUDA
  kernels' launch objects, ``vmem_bytes`` is a block's shared memory,
  ``hbm_bytes`` the launch's compulsory bytes (each input read once, each
  output written once), ``flops`` its operations (f32 and bf16: 2 per
  multiply-add, int16: one IMAD, the scan: one ``exp`` per state and
  step; the fused backwards count the products the unpool and the gate
  leave, at the density of random pre-activations), and ``mxu_util`` the
  grid's fill of the card: a wave is as many blocks as the SMs hold by
  shared memory, threads and their block limit, and the fill is the share
  of the SMs the waves keep busy (:func:`grid_fill`).  Its
  :meth:`CardFootprint.est_time_s` is the kernel table's bound (``PERF.md``
  §6) divided by that fill; ``staged_bytes`` counts what the blocks load
  (their halo and weight tiles, a split's partial sums), which the
  autotuner's ranking reads among plans of about the same estimate.

dtype widths: f32 -> 4 B operands / f32 accumulator; bf16 -> 2 B / f32;
fxp16 (true int16, paper §IV) -> 2 B / int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.kernels.tiling import (BITS_PER_BYTE, CRUMBS_PER_BYTE,
                                        cdiv, crumb_bytes, mask_bytes,
                                        relu_pool_threads)
from repro_torch.plan.profiles import LANE, SMEM_RESERVED, SUBLANE

#: operand element bytes per precision.
ELT_BYTES = {"f32": 4, "bf16": 2, "fxp16": 2}
#: accumulator element bytes (f32 for floats, int32 for fxp16).
ACC_BYTES = {"f32": 4, "bf16": 4, "fxp16": 4}

#: The JAX package's default TPU tiles (``repro.kernels.tiling``).
DEFAULT_CO_TILE, DEFAULT_TM, DEFAULT_TK, DEFAULT_TN = 128, 128, 512, 128


def align_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (ceil-align)."""
    return -(-x // m) * m


def pow2_span(unit: int, cap: int) -> Tuple[int, ...]:
    """Aligned candidate tiles: pow2 multiples of ``unit`` up to ``cap``,
    plus ``cap`` itself (the full-dim tile)."""
    out = []
    t = unit
    while t < cap:
        out.append(t)
        t *= 2
    out.append(cap)
    return tuple(out)


def cout_tiling(cout: int, co_tile: Optional[int] = None) -> Tuple[int, int]:
    """The TPU conv Cout tiling: ``(tco, cout_p)`` with ``tco | cout_p``,
    sublane-aligned and clamped to the aligned channel count."""
    if co_tile is None:
        co_tile = DEFAULT_CO_TILE
    tco = min(align_up(co_tile, SUBLANE), align_up(cout, SUBLANE))
    return tco, align_up(cout, tco)


def vmm_tiling(m: int, k: int, n: int, tm: Optional[int] = None,
               tk: Optional[int] = None, tn: Optional[int] = None):
    """The TPU FC tiling: ``(tm_, tk_, tn_, mp, kp, np_)``, tm clamped to
    the sublane-aligned M, tk / tn to the lane-aligned K / N."""
    tm = DEFAULT_TM if tm is None else tm
    tk = DEFAULT_TK if tk is None else tk
    tn = DEFAULT_TN if tn is None else tn
    tm_ = min(align_up(tm, SUBLANE), align_up(m, SUBLANE))
    tk_ = min(align_up(tk, LANE), align_up(k, LANE))
    tn_ = min(align_up(tn, LANE), align_up(n, LANE))
    return (tm_, tk_, tn_,
            align_up(m, tm_), align_up(k, tk_), align_up(n, tn_))


def _elt(precision: str) -> int:
    try:
        return ELT_BYTES[precision]
    except KeyError:
        raise ValueError(f"precision={precision!r} not in "
                         f"{tuple(ELT_BYTES)}") from None


@dataclass(frozen=True)
class Footprint:
    """Resource usage of one kernel call under a candidate tile shape."""

    #: peak on-chip bytes of ONE grid cell (blocks + scratch).
    vmem_bytes: int
    #: total HBM bytes moved by the whole call (all grid cells).
    hbm_bytes: int
    #: total MACs * 2 of the padded computation.
    flops: int
    #: fraction of the MAC array the tile's dot shapes occupy (0..1].
    mxu_util: float

    def fits(self, profile) -> bool:
        """Does one grid cell fit the profile's on-chip budget?"""
        return self.vmem_bytes <= profile.vmem_bytes

    def est_time_s(self, profile) -> float:
        """Two-term roofline estimate: compute at the derated peak vs
        HBM traffic at the profile bandwidth."""
        compute = self.flops / (profile.mxu_tflops * 1e12
                                * max(self.mxu_util, 1e-3))
        memory = self.hbm_bytes / (profile.hbm_gbps * 1e9)
        return max(compute, memory)


def _dot_util(sub_rows: int, depth: int, lanes: int, mxu: int) -> float:
    """MAC-array occupancy proxy of an [R, D] @ [D, L] tile dot."""
    return (min(1.0, sub_rows / mxu) * min(1.0, depth / mxu)
            * min(1.0, lanes / mxu))


# ---------------------------------------------------------------------------
# the JAX package's TPU model
# ---------------------------------------------------------------------------


def conv2d_fwd_footprint(n: int, h: int, w: int, k: int, cin: int,
                         cout: int, co_tile: int, precision: str = "f32",
                         mxu: int = 128) -> Footprint:
    """One (batch, cout-tile) grid cell of ``conv2d_pallas``: padded input
    block + weight block + the im2col patch matrix + the accumulator + the
    output block; the input block reloads once per cout tile."""
    elt, acc = _elt(precision), ACC_BYTES[precision]
    p = (k - 1) // 2
    cin_p = align_up(cin, SUBLANE)
    tco, cout_p = cout_tiling(cout, co_tile)
    x_blk = (h + 2 * p) * (w + 2 * p) * cin_p * elt
    w_blk = k * k * cin_p * tco * elt
    patches = h * w * k * k * cin_p * elt
    acc_blk = h * w * tco * acc
    out_blk = h * w * tco * elt
    tiles = cout_p // tco
    return Footprint(
        vmem_bytes=x_blk + w_blk + patches + acc_blk + out_blk,
        hbm_bytes=n * tiles * (x_blk + w_blk) + n * h * w * cout_p * elt,
        flops=2 * n * h * w * k * k * cin_p * cout_p,
        mxu_util=_dot_util(h * w, k * k * cin_p, tco, mxu))


def conv2d_bwd_footprint(s: int, n: int, hg: int, wg: int, k: int, c: int,
                         cout: int, co_tile: int, *, pooled: bool,
                         gated: bool = True, precision: str = "f32",
                         mxu: int = 128) -> Footprint:
    """One grid cell of the fused conv backward
    (``conv2d_bwd_fused_pallas``): unpool + mask-gate prologues and the
    flipped-transpose single-dot BP; ``s`` seeds share the cell, ``c`` is
    the contraction (forward Cout), ``cout`` the outgoing channels, ``hg /
    wg`` the incoming gradient's spatial dims."""
    elt, acc = _elt(precision), ACC_BYTES[precision]
    p = (k - 1) // 2
    cp = align_up(c, SUBLANE)
    tco, cout_p = cout_tiling(cout, co_tile)
    h, w = (2 * hg, 2 * wg) if pooled else (hg, wg)
    g_blk = s * hg * wg * cp * elt
    w_blk = k * k * cp * tco * elt
    idx_blk = hg * wg * cp // CRUMBS_PER_BYTE if pooled else 0
    mask_blk = h * w * cp // BITS_PER_BYTE if gated else 0
    gp_blk = s * (h + 2 * p) * (w + 2 * p) * cp * elt
    patches = s * h * w * k * k * cp * elt
    acc_blk = s * h * w * tco * acc
    out_blk = s * h * w * tco * elt
    tiles = cout_p // tco
    loads = g_blk + w_blk + idx_blk + mask_blk
    return Footprint(
        vmem_bytes=(g_blk + w_blk + idx_blk + mask_blk + gp_blk + patches
                    + acc_blk + out_blk),
        hbm_bytes=n * tiles * loads + s * n * h * w * cout_p * elt,
        flops=2 * s * n * h * w * k * k * cp * cout_p,
        mxu_util=_dot_util(s * h * w, k * k * cp, tco, mxu))


def vmm_fwd_footprint(m: int, k: int, n: int, tm: int, tk: int, tn: int,
                      precision: str = "f32", mxu: int = 128) -> Footprint:
    """One (M, N, K-step) grid cell of ``vmm_pallas``: x / w blocks, the
    accumulator scratch and the output block."""
    elt, acc = _elt(precision), ACC_BYTES[precision]
    tm_, tk_, tn_, mp, kp, np_ = vmm_tiling(m, k, n, tm, tk, tn)
    x_blk = tm_ * tk_ * elt
    w_blk = tk_ * tn_ * elt
    acc_blk = tm_ * tn_ * acc
    out_blk = tm_ * tn_ * elt
    cells = (mp // tm_) * (np_ // tn_) * (kp // tk_)
    return Footprint(
        vmem_bytes=x_blk + w_blk + acc_blk + out_blk,
        hbm_bytes=cells * (x_blk + w_blk) + mp * np_ * elt,
        flops=2 * mp * kp * np_,
        mxu_util=_dot_util(tm_, tk_, tn_, mxu))


def vmm_bwd_footprint(s: int, m: int, k: int, n: int, tk: int, tn: int, *,
                      gated: bool = True, out_gated: bool = False,
                      precision: str = "f32", mxu: int = 128) -> Footprint:
    """One grid cell of the fused FC backward (``vmm_bwd_fused_pallas``):
    the full sublane-padded M rows ride each cell, mask unpack + gating
    fused in."""
    elt, acc = _elt(precision), ACC_BYTES[precision]
    _, tk_, tn_, mp, kp, np_ = vmm_tiling(m, k, n, m, tk, tn)
    g_blk = mp * tk_ * elt
    w_blk = tk_ * tn_ * elt
    mask_blk = mp * tk_ // BITS_PER_BYTE if gated else 0
    omask_blk = mp * tn_ // BITS_PER_BYTE if out_gated else 0
    acc_blk = mp * tn_ * acc
    out_blk = mp * tn_ * elt
    cells = s * (np_ // tn_) * (kp // tk_)
    loads = g_blk + w_blk + mask_blk + omask_blk
    return Footprint(
        vmem_bytes=g_blk + w_blk + mask_blk + omask_blk + acc_blk + out_blk,
        hbm_bytes=cells * loads + s * mp * np_ * elt,
        flops=2 * s * mp * kp * np_,
        mxu_util=_dot_util(mp, tk_, tn_, mxu))


def pool_footprint(n: int, h: int, w: int, c: int,
                   precision: str = "f32") -> Footprint:
    """One batch cell of ``maxpool_fwd_pallas``: feature map in, pooled
    map + packed 2-bit indices out (no tile knobs: a budget check only)."""
    elt = _elt(precision)
    cp = align_up(c, CRUMBS_PER_BYTE)
    x_blk = h * w * cp * elt
    y_blk = (h // 2) * (w // 2) * cp * elt
    idx_blk = (h // 2) * (w // 2) * cp // CRUMBS_PER_BYTE
    cand_blk = 4 * y_blk
    return Footprint(
        vmem_bytes=x_blk + cand_blk + y_blk + idx_blk,
        hbm_bytes=n * (x_blk + y_blk + idx_blk),
        flops=0,
        mxu_util=1.0)


def ssm_scan_footprint(b: int, s: int, d: int, n: int,
                       d_tile: int = None, chunk: int = None,
                       precision: str = "f32") -> Footprint:
    """One (batch, d-tile, chunk) grid cell of ``selective_scan_pallas``,
    ranked by memory traffic alone (a VPU recurrence: ``flops=0``).
    ``d_tile=None`` models the unplanned whole-D launch, ``chunk=None``
    the whole sequence."""
    elt = _elt(precision)
    dt_t = min(d_tile if d_tile is not None else d, d)
    ck = min(chunk if chunk is not None else s, s)
    n_chunks = -(-s // ck)
    dt_blk = ck * dt_t * 4
    x_blk = ck * dt_t * elt
    bc_blk = 2 * ck * n * 4
    a_blk = dt_t * n * 4
    h0_blk = dt_t * n * 4
    scr = dt_t * n * 4
    y_blk = ck * dt_t * elt
    hl_blk = dt_t * n * 4
    cells = b * (d // dt_t if d % dt_t == 0 else -(-d // dt_t)) * n_chunks
    loads = dt_blk + x_blk + bc_blk + a_blk + h0_blk
    return Footprint(
        vmem_bytes=(dt_blk + x_blk + bc_blk + a_blk + h0_blk + scr
                    + y_blk + hl_blk),
        hbm_bytes=cells * loads + b * n_chunks * ck * d * elt + b * d * n * 4,
        flops=0,
        mxu_util=1.0)


# ---------------------------------------------------------------------------
# the card's model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CardFootprint(Footprint):
    """A CUDA launch on a :class:`~repro_torch.plan.profiles.GpuProfile`:
    ``flops`` counts operations of the kind ``rate`` (operations/s) is the
    card's peak for, and ``mxu_util`` is the grid's fill of the card."""

    rate: float = 1.0
    staged_bytes: int = 0

    def bound_s(self, profile) -> float:
        """The least time the card could take: bytes over its memory rate,
        operations over their peak, whichever is larger."""
        return max(self.hbm_bytes / profile.hbm_bytes_per_s,
                   self.flops / self.rate)

    def est_time_s(self, profile) -> float:
        """The bound, divided by the grid's fill of the card."""
        return self.bound_s(profile) / max(self.mxu_util, 1e-3)


def grid_fill(profile, blocks: int, threads: int, smem: int) -> float:
    """Share of the SMs a grid keeps busy over its waves.  A wave is as
    many blocks as the SMs hold at once: each as many as its threads, its
    shared memory (with :data:`SMEM_RESERVED` a block) and its block limit
    allow; the last wave may leave SMs idle."""
    if blocks < 1 or threads < 1:
        return 1.0
    per_sm = min(profile.threads_per_sm // threads, profile.blocks_per_sm,
                 profile.smem_per_sm // (smem + SMEM_RESERVED))
    if per_sm < 1:
        return 1e-3
    slots = per_sm * profile.sms
    waves = cdiv(blocks, slots)
    last = blocks - (waves - 1) * slots
    return ((waves - 1) * profile.sms + min(profile.sms, last)) / (
        waves * profile.sms)


def _rate_ops(profile, precision: str, macs: float) -> Tuple[float, float]:
    """(operations, their peak rate) of ``macs`` multiply-adds."""
    if precision == "fxp16":
        return macs, profile.imad_ops
    if precision == "bf16":
        return 2 * macs, profile.bf16_flops
    return 2 * macs, profile.f32_flops


def bwd_density(pooled: bool, gated: bool) -> float:
    """Share of a fused backward's incoming products that survive the
    unpool (one of a window's four) and the gate (half of random
    pre-activations; a pooled window's argmax is positive unless all four
    are not, 15 in 16)."""
    share = 0.25 if pooled else 1.0
    if gated:
        share *= 15 / 16 if pooled else 0.5
    return share


def _launch_geometry(family: str, kw, tile, precision: str):
    """(blocks, threads, shared bytes, bytes the blocks load) of one launch
    of ``tile``; the general kernels (all-zero plans) as (0, 0, 0, 0): they
    tile themselves."""
    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.ssm_scan import ssm_scan as scan
    from repro_torch.kernels.vmm import vmm as vm
    esize = ELT_BYTES[precision]
    if family == "conv2d_fwd":
        n, h, w, k, cin, cout = (kw[x] for x in ("n", "h", "w", "k", "cin",
                                                 "cout"))
        if tile == cv.CONV_GENERAL:
            return 0, 0, 0, 0
        mma = isinstance(tile, cv.ConvMmaPlan)
        smem = (tile.smem_bytes(k, cin) if mma
                else tile.smem_bytes(k, esize=esize))
        tw = cv.CONV_MMA_TW if mma else cv.CONV_TILE_W
        blocks = tile.blocks(n, h, w, cout)
        staged = blocks * esize * cin * ((tile.th + k - 1) * (tw + k - 1)
                                         + k * k * tile.tco)
        return blocks, tile.threads, smem, staged
    if family == "conv2d_bwd":
        s, n, k, c, cout = (kw[x] for x in ("s", "n", "k", "c", "cout"))
        pooled = bool(kw["pooled"])
        h, w = ((2 * kw["hg"], 2 * kw["wg"]) if pooled
                else (kw["hg"], kw["wg"]))
        if tile == cv.CONV_BWD_GENERAL:
            return 0, 0, 0, 0
        mma = isinstance(tile, cv.ConvBwdMmaPlan)
        smem = (tile.smem_bytes(k, c, s, pooled=pooled) if mma
                else tile.smem_bytes(k, pooled=pooled, esize=esize))
        xh = tile.th + k - 1
        xw = (cv.CONV_MMA_TW if mma else cv.CONV_TILE_W) + k - 1
        gh, gw = (xh // 2 + 1, xw // 2 + 1) if pooled else (xh, xw)
        blocks = tile.blocks(n, h, w, cout)
        staged = blocks * (esize * c * (s * gh * gw + k * k * tile.tco)
                           + xh * xw * mask_bytes(c)
                           + (gh * gw * crumb_bytes(c) if pooled else 0))
        return blocks, tile.threads, smem, staged
    if family == "vmm_fwd":
        m, k, n = kw["m"], kw["k"], kw["n"]
        if isinstance(tile, vm.VmmMmaPlan):
            # csrc/vmm_fwd_bf16.cu Layout: an 8-stage ring, then the inbox
            ring = 2 * 8 * (vm.MMA_TILE_M * (vm.MMA_CHUNK_K + 8)
                            + vm.MMA_CHUNK_K * (tile.bn + 8))
            blocks = tile.blocks(m, n)
            return (blocks, 128, ring + 4 * (vm.MMA_TILE_M * tile.bn + 16),
                    blocks * 2 * tile.slice(k) * (vm.MMA_TILE_M + tile.bn))
        splits = cdiv(k, vm.vmm_slice(k, tile))
        blocks = cdiv(m, vm.SPLIT_TILE_M) * cdiv(n, vm.SPLIT_TILE_N) * splits
        # csrc/vmm.cu: a 32 x 32 tile, 128 threads, x and w chunks static;
        # a split writes [splits, M, N] partial sums, read back once
        staged = (blocks * esize * vm.vmm_slice(k, tile)
                  * (vm.SPLIT_TILE_M + vm.SPLIT_TILE_N)
                  + (2 * 4 * splits * m * n if splits > 1 else 0))
        return (blocks, 128,
                4 * (vm.SPLIT_TILE_M * (vm.SPLIT_CHUNK_K + 4)
                     + vm.SPLIT_CHUNK_K * vm.SPLIT_TILE_N), staged)
    if family == "vmm_bwd":
        s, m, k, n = kw["s"], kw["m"], kw["k"], kw["n"]
        if tile == vm.VMM_BWD_GENERAL:
            return 0, 0, 0, 0
        smem = (tile.smem_bytes(k) if isinstance(tile, vm.VmmBwdMmaPlan)
                else tile.smem_bytes(esize=esize))
        blocks = tile.blocks(s * m, n)
        return (blocks, tile.threads, smem,
                blocks * (esize * k * (tile.br + tile.bn)
                          + tile.br * mask_bytes(k)))
    if family == "pool":
        work = (kw["n"] * (kw["h"] // 2) * (kw["w"] // 2)
                * cdiv(kw["c"], BITS_PER_BYTE))
        t = relu_pool_threads(work)
        return cdiv(work, t), t, 0, 0
    if family == "ssm_scan":
        b, s, d = kw["b"], kw["s"], kw["d"]
        ch = scan.fwd_channels(tile.d_tile, d)
        ck = max(1, min(tile.chunk, scan.FWD_MAX_CHUNK, s))
        # csrc/ssm_scan.cu Chunk::bytes, double-buffered
        smem = 2 * ck * (ch * (4 + esize) + 2 * scan.MAX_STATE * 4)
        return b * cdiv(d, ch), scan.LANES * ch, smem, 0
    raise ValueError(f"unknown kernel family {family!r}")


def card_footprint(family: str, kw, tile, precision: str,
                   profile) -> CardFootprint:
    """The card's footprint of one launch of ``tile`` (a CUDA kernel's
    launch object: ``ConvPlan``, ``ConvMmaPlan``, ``ConvBwdPlan``,
    ``ConvBwdMmaPlan``, a K split count, ``VmmMmaPlan``, ``VmmBwdPlan``,
    ``VmmBwdMmaPlan``, a ``ScanTile``; None for the pool, which has no
    plan)."""
    esize = _elt(precision)
    if family == "conv2d_fwd":
        n, h, w, k, cin, cout = (kw[x] for x in ("n", "h", "w", "k", "cin",
                                                 "cout"))
        nbytes = esize * (n * h * w * (cin + cout) + k * k * cin * cout
                          + cout)
        ops, rate = _rate_ops(profile, precision,
                              n * h * w * cout * k * k * cin)
    elif family == "conv2d_bwd":
        s, n, hg, wg, k, c, cout = (kw[x] for x in ("s", "n", "hg", "wg",
                                                    "k", "c", "cout"))
        pooled, gated = bool(kw["pooled"]), bool(kw.get("gated", True))
        h, w = (2 * hg, 2 * wg) if pooled else (hg, wg)
        nbytes = (esize * (s * n * hg * wg * c + k * k * c * cout
                           + s * n * h * w * cout)
                  + (n * hg * wg * crumb_bytes(c) if pooled else 0)
                  + (n * h * w * mask_bytes(c) if gated else 0))
        ops, rate = _rate_ops(profile, precision,
                              s * n * h * w * c * k * k * cout
                              * bwd_density(pooled, gated))
    elif family == "vmm_fwd":
        m, k, n = kw["m"], kw["k"], kw["n"]
        nbytes = esize * (m * k + k * n + n + m * n)
        ops, rate = _rate_ops(profile, precision, m * k * n)
    elif family == "vmm_bwd":
        s, m, k, n = kw["s"], kw["m"], kw["k"], kw["n"]
        gated = bool(kw.get("gated", True))
        nbytes = (esize * (s * m * k + k * n + s * m * n)
                  + (m * mask_bytes(k) if gated else 0))
        ops, rate = _rate_ops(profile, precision,
                              s * m * k * n * bwd_density(False, gated))
    elif family == "pool":
        n, h, w, c = kw["n"], kw["h"], kw["w"], kw["c"]
        hp, wp = h // 2, w // 2
        nbytes = (esize * n * c * (h * w + hp * wp) + n * h * w * mask_bytes(c)
                  + n * hp * wp * crumb_bytes(c))
        ops, rate = 0, 1.0
    elif family == "ssm_scan":
        b, s, d, n = kw["b"], kw["s"], kw["d"], kw["n"]
        nbytes = (4 * b * s * d + 2 * esize * b * s * d + 8 * b * s * n
                  + 4 * d * n + 8 * b * d * n)
        ops, rate = b * s * d * n, profile.exp_ops
    else:
        raise ValueError(f"unknown kernel family {family!r}")
    blocks, threads, smem, staged = _launch_geometry(family, kw, tile,
                                                     precision)
    return CardFootprint(vmem_bytes=int(smem), hbm_bytes=int(nbytes),
                         flops=int(ops),
                         mxu_util=grid_fill(profile, blocks, threads, smem),
                         rate=rate, staged_bytes=int(max(staged, nbytes)))
