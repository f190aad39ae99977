"""Tile planner: enumerate legal candidates, rank analytically, autotune.

Two planners behind one :func:`plan_cnn` / :func:`plan_lm`:

* **The JAX package's profiles** (``detected`` on the CPU, ``tpu-v4``,
  ``edge-*``, ``mesh:<p>:<n>``): ``repro.plan.planner``'s four-step sweep,
  entry for entry — enumerate ALIGNED TPU tiles, reject any whose
  analytic on-chip bytes exceed the budget (:class:`InfeasiblePlanError`
  when none fits), rank by the roofline estimate (ties prefer the larger
  tile), optionally measure the top :data:`AUTOTUNE_TOP_K`.  On the card
  such a plan is an audit: the CUDA kernels launch under their own rules.
* **The card's profile** (``h100``): each entry is the CUDA kernel's own
  launch object for that launch and precision — ``ConvPlan`` /
  ``ConvMmaPlan``, ``ConvBwdPlan`` / ``ConvBwdMmaPlan``, the K split count
  / ``VmmMmaPlan``, ``VmmBwdPlan`` / ``VmmBwdMmaPlan``, ``ScanTile``.
  Analytically it is exactly the launch rule of today (``conv_plan``,
  ``conv_bf16_plan``, ``conv_bwd_plan``, ``conv_bwd_bf16_plan``,
  ``vmm_splits``, ``vmm_mma_plan``, ``vmm_bwd_plan``, ``vmm_bwd_mma_plan``
  at the profile's SM count; the scan's unplanned ``(d_inner,
  ssm_chunk)``).  ``autotune=True`` measures the rule's plan, always, and
  the :data:`AUTOTUNE_TOP_K` best-ranked other candidates of the enumerators
  the card sweeps use (ranked by the card's footprint: the bound over the
  grid's fill, then the bytes the blocks stage), and keeps the fastest.  Such an entry applies at the launch
  shape it was planned for (:meth:`TilePlan.at`); a launch of any other
  shape runs the rule.

A :class:`~repro_torch.plan.cache.TuningCache` short-circuits planning and
measuring per kernel on a hit.
"""
from __future__ import annotations

import dataclasses
import statistics
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.plan import model as cost
from repro_torch.plan.cache import TuningCache, cache_key
from repro_torch.plan.model import align_up, pow2_span
from repro_torch.plan.profiles import (LANE, SUBLANE, GpuProfile,
                                       MeshProfile, get_profile)

#: precision -> operand dtype recorded in cache keys.
PLAN_DTYPES = {"f32": "float32", "bf16": "bfloat16", "fxp16": "int16"}

#: candidates measured per kernel when ``autotune=True`` (on the card: the
#: rule's plan and this many others).
AUTOTUNE_TOP_K = 3


class InfeasiblePlanError(ValueError):
    """No candidate tile fits the profile's on-chip budget."""


# ---------------------------------------------------------------------------
# tiles and the plan pytree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvTile:
    """Cout tile of the TPU conv kernels (fwd and fused bwd)."""

    co_tile: int


@dataclass(frozen=True)
class VmmTile:
    """(M, K, N) block triple of the TPU forward FC matmul."""

    tm: int
    tk: int
    tn: int


@dataclass(frozen=True)
class VmmBwdTile:
    """(K, N) block pair of the TPU fused FC backward (M rides whole)."""

    tk: int
    tn: int


@dataclass(frozen=True)
class ScanTile:
    """(d_tile, chunk) of the selective scan: channels a grid cell, steps a
    chunk.  On the card B13 takes them through ``fwd_channels`` /
    ``bwd_window``; as in the JAX package they split the grid and the
    staging, never an element's arithmetic."""

    d_tile: int
    chunk: int


@dataclass(frozen=True)
class TilePlan:
    """Frozen mapping ``layer-kernel key -> tile`` for one device target.

    Keys follow the CNN layer walk: ``conv{i}.fwd`` / ``conv{i}.bwd`` /
    ``fc{i}.fwd`` / ``fc{i}.bwd`` (and ``ssm{si}.scan``).  Hashable (it
    rides inside ``EngineSpec``).  ``shapes`` records, for a plan of the
    card, the launch each entry was planned at (its cache-key dims).
    """

    device: str
    precision: str
    entries: Tuple[Tuple[str, Any], ...]
    shapes: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "_index", dict(self.entries))
        object.__setattr__(self, "_shapes", dict(self.shapes))

    def get(self, key: str, default=None):
        return self._index.get(key, default)

    def at(self, key: str, dims) -> Any:
        """The card's launch object for ``key`` where this plan was made
        for the card at exactly the launch ``dims``; None otherwise (a
        TPU plan, another shape: the launch runs the card's rule)."""
        planned = self._shapes.get(key)
        if planned is None or tuple(int(d) for d in dims) != planned:
            return None
        return self._index.get(key)

    def keys(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def summary(self) -> str:
        lines = [f"TilePlan(device={self.device}, precision={self.precision})"]
        for key, tile in self.entries:
            lines.append(f"  {key:12s} {tile}")
        return "\n".join(lines)


_TPU_TILES = (ConvTile, VmmTile, VmmBwdTile)


def _card_classes():
    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.vmm import vmm as vm
    return {c.__name__: c for c in (
        cv.ConvPlan, cv.ConvMmaPlan, cv.ConvBwdPlan, cv.ConvBwdMmaPlan,
        vm.VmmMmaPlan, vm.VmmBwdPlan, vm.VmmBwdMmaPlan)}


#: Which card launch objects each family's entries may be.
_CARD_FAMILY = {"conv2d_fwd": ("ConvPlan", "ConvMmaPlan"),
                "conv2d_bwd": ("ConvBwdPlan", "ConvBwdMmaPlan"),
                "vmm_fwd": ("splits", "VmmMmaPlan"),
                "vmm_bwd": ("VmmBwdPlan", "VmmBwdMmaPlan")}


def _plan_kind(tile) -> Optional[str]:
    """The class name a cache entry records for a card launch object
    (``"splits"`` for a K split count); None for the shared tiles."""
    if isinstance(tile, _TPU_TILES + (ScanTile,)):
        return None
    if isinstance(tile, int):
        return "splits"
    return type(tile).__name__


def _encode_tile(tile) -> List[int]:
    if isinstance(tile, ConvTile):
        return [tile.co_tile]
    if isinstance(tile, VmmTile):
        return [tile.tm, tile.tk, tile.tn]
    if isinstance(tile, ScanTile):
        return [tile.d_tile, tile.chunk]
    if isinstance(tile, VmmBwdTile):
        return [tile.tk, tile.tn]
    if isinstance(tile, int):
        return [tile]
    return [int(v) for v in dataclasses.astuple(tile)]


_TILE_ARITY = {"conv2d_fwd": 1, "conv2d_bwd": 1, "vmm_fwd": 3, "vmm_bwd": 2,
               "ssm_scan": 2}


def _decode_tile(family: str, blob, kind: Optional[str] = None) -> Any:
    """Cache blob -> tile, or ``ValueError`` on an arity / family mismatch
    (the planner treats that as a cache miss and replans).  ``kind`` names
    a card launch object's class (a cache entry's ``"plan"``)."""
    vals = [int(v) for v in blob]
    if kind is not None:
        if kind not in _CARD_FAMILY.get(family, ()):
            raise ValueError(f"cache blob of a {kind} is no {family} plan")
        if kind == "splits":
            if len(vals) != 1:
                raise ValueError(f"cache blob {blob!r} is no K split count")
            return vals[0]
        cls = _card_classes()[kind]
        if len(vals) != len(dataclasses.fields(cls)):
            raise ValueError(f"cache blob {blob!r} does not decode as a "
                             f"{kind}")
        return cls(*vals)
    arity = _TILE_ARITY.get(family)
    if arity is None or len(vals) != arity:
        raise ValueError(f"cache blob {blob!r} does not decode as a "
                         f"{family} tile (need {arity} ints)")
    if family in ("conv2d_fwd", "conv2d_bwd"):
        return ConvTile(*vals)
    if family == "vmm_fwd":
        return VmmTile(*vals)
    if family == "ssm_scan":
        return ScanTile(*vals)
    return VmmBwdTile(*vals)


# ---------------------------------------------------------------------------
# autotune measurement (module-level so tests can stub/count)
# ---------------------------------------------------------------------------

#: Launches a measurement times (each between its own CUDA events, queued
#: behind a sleep kernel so the events time the card, not Python), and the
#: sleep's length.
MEASURE_REPS, MEASURE_COVER_MS = 20, 5.0


def _event_us(fn, reps: int = MEASURE_REPS) -> float:
    """Median device microseconds of ``fn()`` over ``reps`` launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e6 * MEASURE_COVER_MS))  # cycles, ~2 GHz clock
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return 1e3 * statistics.median(a.elapsed_time(b) for a, b in ev)


def measure_kernel(family: str, kw: Dict[str, Any], tile,
                   precision: str) -> float:
    """Device microseconds of one launch of the real CUDA wrapper under
    ``tile`` (a card launch object; None for the pool, which has none), on
    zero operands, by CUDA events.  Runs only on the card: raises
    elsewhere, and for a TPU tile, which no CUDA launch takes."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("measure_kernel times CUDA launches; no CUDA "
                           "device is available")
    if isinstance(tile, _TPU_TILES):
        raise ValueError(f"{family}: {tile} sizes a TPU VMEM block, which "
                         f"the CUDA kernels have not; autotune measures "
                         f"the h100 profile's launch objects")
    dev = torch.device("cuda")
    dt = getattr(torch, PLAN_DTYPES[precision])
    fxp = precision == "fxp16"

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    u8 = torch.uint8
    if family == "conv2d_fwd":
        from repro_torch.kernels.conv2d.conv2d import conv2d
        from repro_torch.kernels.conv2d.fxp import conv2d_fxp
        x = z(kw["n"], kw["h"], kw["w"], kw["cin"])
        w = z(kw["k"], kw["k"], kw["cin"], kw["cout"])
        b = z(kw["cout"])
        op = conv2d_fxp if fxp else conv2d
        return _event_us(lambda: op(x, w, b, plan=tile))
    if family == "conv2d_bwd":
        from repro_torch.kernels.conv2d.conv2d import conv2d_bwd_fused
        from repro_torch.kernels.conv2d.fxp import conv2d_bwd_fused_fxp
        s, n, hg, wg = kw["s"], kw["n"], kw["hg"], kw["wg"]
        k, c, cout = kw["k"], kw["c"], kw["cout"]
        pooled, gated = bool(kw["pooled"]), bool(kw.get("gated", True))
        h, w = (2 * hg, 2 * wg) if pooled else (hg, wg)
        g = z(s, n, hg, wg, c)
        wt = z(k, k, c, cout)
        idx = z(n, hg, wg, -(-c // 4), dtype=u8) if pooled else None
        mask = z(n, h, w, -(-c // 8), dtype=u8) if gated else None
        op = conv2d_bwd_fused_fxp if fxp else conv2d_bwd_fused
        return _event_us(lambda: op(g, wt, pool_idx=idx, relu_mask=mask,
                                    gate=gated, plan=tile))
    if family == "vmm_fwd":
        from repro_torch.kernels.vmm.fxp import vmm_fxp
        from repro_torch.kernels.vmm.vmm import vmm
        x = z(kw["m"], kw["k"])
        w = z(kw["k"], kw["n"])
        b = z(kw["n"])
        op = vmm_fxp if fxp else vmm
        return _event_us(lambda: op(x, w, b, plan=tile))
    if family == "vmm_bwd":
        from repro_torch.kernels.vmm.fxp import vmm_bwd_fused_fxp
        from repro_torch.kernels.vmm.vmm import vmm_bwd_fused
        s, m, k, n = kw["s"], kw["m"], kw["k"], kw["n"]
        gated = bool(kw.get("gated", True))
        g = z(s, m, k)
        w = z(k, n)
        mask = z(m, -(-k // 8), dtype=u8) if gated else None
        op = vmm_bwd_fused_fxp if fxp else vmm_bwd_fused
        return _event_us(lambda: op(g, w, relu_mask=mask, gate=gated,
                                    plan=tile))
    if family == "pool":
        from repro_torch.kernels.pool.fxp import relu_pool_fwd_fxp
        from repro_torch.kernels.pool.pool import relu_pool_fwd
        x = z(kw["n"], kw["h"], kw["w"], kw["c"])
        op = relu_pool_fwd_fxp if fxp else relu_pool_fwd
        return _event_us(lambda: op(x, mask=True))
    if family == "ssm_scan":
        from repro_torch.kernels.ssm_scan.ssm_scan import (selective_scan,
                                                           selective_scan_bwd)
        b, s, d, n = kw["b"], kw["s"], kw["d"], kw["n"]
        f32 = torch.float32
        x = z(b, s, d)
        dt_, bm, cm = z(b, s, d, dtype=f32), z(b, s, n, dtype=f32), \
            z(b, s, n, dtype=f32)
        a, h0 = z(d, n, dtype=f32), z(b, d, n, dtype=f32)
        knobs = dict(d_tile=tile.d_tile, chunk=tile.chunk)
        # the explain runs the forward and its backward under the knobs
        return _event_us(lambda: (
            selective_scan(dt_, x, bm, cm, a, h0, **knobs),
            selective_scan_bwd(dt_, x, bm, cm, a, h0, x, None, **knobs,
                               needs=(True, True, True, True, False,
                                      False))))
    raise ValueError(f"unknown kernel family {family!r}")


# ---------------------------------------------------------------------------
# per-family planning
# ---------------------------------------------------------------------------


def _footprint(family: str, kw: Dict[str, Any], tile, precision: str,
               profile) -> cost.Footprint:
    """The footprint of one launch under ``tile`` (None: the default
    policy — the JAX package's default tiles, or on the card its rule)."""
    if isinstance(profile, GpuProfile):
        if isinstance(tile, _TPU_TILES):
            raise ValueError(f"{family}: {tile} is a TPU tile; the "
                             f"{profile.name} profile plans CUDA launches")
        if tile is None and family != "pool":
            tile = _rule_plan(family, kw, profile, precision)
        return cost.card_footprint(family, kw, tile, precision, profile)
    mxu = profile.mxu
    if family == "conv2d_fwd":
        return cost.conv2d_fwd_footprint(
            kw["n"], kw["h"], kw["w"], kw["k"], kw["cin"], kw["cout"],
            tile.co_tile if tile is not None else None,
            precision=precision, mxu=mxu)
    if family == "conv2d_bwd":
        return cost.conv2d_bwd_footprint(
            kw["s"], kw["n"], kw["hg"], kw["wg"], kw["k"], kw["c"],
            kw["cout"], tile.co_tile if tile is not None else None,
            pooled=kw["pooled"], gated=kw.get("gated", True),
            precision=precision, mxu=mxu)
    if family == "vmm_fwd":
        t = tile or VmmTile(None, None, None)
        return cost.vmm_fwd_footprint(kw["m"], kw["k"], kw["n"],
                                      t.tm, t.tk, t.tn,
                                      precision=precision, mxu=mxu)
    if family == "vmm_bwd":
        t = tile or VmmBwdTile(None, None)
        return cost.vmm_bwd_footprint(kw["s"], kw["m"], kw["k"], kw["n"],
                                      t.tk, t.tn,
                                      gated=kw.get("gated", True),
                                      precision=precision, mxu=mxu)
    if family == "pool":
        return cost.pool_footprint(kw["n"], kw["h"], kw["w"], kw["c"],
                                   precision=precision)
    if family == "ssm_scan":
        return cost.ssm_scan_footprint(
            kw["b"], kw["s"], kw["d"], kw["n"],
            tile.d_tile if tile is not None else None,
            tile.chunk if tile is not None else kw["chunk_default"],
            precision=precision)
    raise ValueError(f"unknown kernel family {family!r}")


def _candidates(family: str, kw: Dict[str, Any]) -> List[Any]:
    """The JAX package's aligned TPU candidates."""
    if family in ("conv2d_fwd", "conv2d_bwd"):
        return [ConvTile(t)
                for t in pow2_span(SUBLANE, align_up(kw["cout"], SUBLANE))]
    if family == "vmm_fwd":
        tms = pow2_span(SUBLANE, align_up(kw["m"], SUBLANE))
        tks = pow2_span(LANE, align_up(kw["k"], LANE))
        tns = pow2_span(LANE, align_up(kw["n"], LANE))
        return [VmmTile(tm, tk, tn)
                for tm in tms for tk in tks for tn in tns]
    if family == "vmm_bwd":
        tks = pow2_span(LANE, align_up(kw["k"], LANE))
        tns = pow2_span(LANE, align_up(kw["n"], LANE))
        return [VmmBwdTile(tk, tn) for tk in tks for tn in tns]
    if family == "ssm_scan":
        return _scan_candidates(kw)
    raise ValueError(f"no tile candidates for family {family!r}")


def _scan_candidates(kw) -> List[ScanTile]:
    # d_tile must DIVIDE the channel axis; chunk lengths are free pow2s
    d = kw["d"]
    dts = [t for t in pow2_span(SUBLANE, d) if d % t == 0]
    cks = pow2_span(SUBLANE, align_up(kw["s"], SUBLANE))
    return [ScanTile(dt, ck) for dt in dts for ck in cks]


def _tile_volume(tile) -> int:
    if isinstance(tile, ConvTile):
        return tile.co_tile
    if isinstance(tile, VmmTile):
        return tile.tm * tile.tk * tile.tn
    if isinstance(tile, ScanTile):
        return tile.d_tile * tile.chunk
    return tile.tk * tile.tn


# -- the card's launch objects ----------------------------------------------


def _conv_out_hw(kw) -> Tuple[int, int]:
    return ((2 * kw["hg"], 2 * kw["wg"]) if kw["pooled"]
            else (kw["hg"], kw["wg"]))


def _rule_plan(family: str, kw: Dict[str, Any], profile: GpuProfile,
               precision: str):
    """Today's launch rule for one launch, at the profile's SM count."""
    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.vmm import vmm as vm
    sms, bf16 = profile.sms, precision == "bf16"
    esize = cost.ELT_BYTES[precision]
    if family in ("conv2d_fwd", "conv2d_bwd") and kw["k"] not in cv.CONV_KS:
        if bf16:
            raise InfeasiblePlanError(
                f"{family} {kw}: bf16 has no general kernel on the card; it "
                f"takes K in {cv.CONV_KS}")
        return (cv.CONV_GENERAL if family == "conv2d_fwd"
                else cv.CONV_BWD_GENERAL)
    if family == "conv2d_fwd":
        args = (kw["n"], kw["h"], kw["w"], kw["cin"], kw["cout"], kw["k"])
        if bf16:
            return cv.conv_bf16_plan(*args, sms=sms)
        return cv.conv_plan(*args, esize=esize, sms=sms)
    if family == "conv2d_bwd":
        h, w = _conv_out_hw(kw)
        args = (kw["s"], kw["n"], h, w, kw["c"], kw["cout"], kw["k"])
        if bf16:
            return cv.conv_bwd_bf16_plan(*args, pooled=bool(kw["pooled"]),
                                         sms=sms)
        return cv.conv_bwd_plan(*args, pooled=bool(kw["pooled"]),
                                esize=esize, sms=sms)
    if family == "vmm_fwd":
        rule = vm.vmm_mma_plan if bf16 else vm.vmm_splits
        return rule(kw["m"], kw["k"], kw["n"], sms=sms)
    if family == "vmm_bwd":
        rule = vm.vmm_bwd_mma_plan if bf16 else vm.vmm_bwd_plan
        return rule(kw["s"], kw["m"], kw["k"], kw["n"], sms=sms)
    if family == "ssm_scan":
        return ScanTile(kw["d"], kw["chunk_default"])
    raise ValueError(f"unknown kernel family {family!r}")


def _card_valid(family: str, kw, tile, precision: str) -> bool:
    """The wrappers' own validators on ``tile`` at this launch."""
    import torch

    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.vmm import vmm as vm
    dtype = getattr(torch, PLAN_DTYPES[precision])
    esize = cost.ELT_BYTES[precision]
    try:
        if family == "conv2d_fwd":
            cv._check_fwd_plan("conv2d", tile, kw["k"], esize, kw["cin"],
                               dtype)
        elif family == "conv2d_bwd":
            cv._check_bwd_plan(tile, kw["k"], pooled=bool(kw["pooled"]),
                               esize=esize, c=kw["c"], s=kw["s"],
                               dtype=dtype)
        elif family == "vmm_fwd":
            if isinstance(tile, vm.VmmMmaPlan):
                vm._check_mma_plan("vmm", tile, kw["k"])
            elif not 1 <= tile <= vm.vmm_max_splits(kw["k"]):
                return False
        elif family == "vmm_bwd":
            vm._check_bwd_plan("vmm_bwd_fused", tile, dtype, esize, kw["k"])
    except ValueError:
        return False
    return True


def _launch_key(family: str, kw, tile):
    """What a candidate launches: plans that make one launch are one."""
    if family == "vmm_fwd" and isinstance(tile, int):
        from repro_torch.kernels.vmm.vmm import vmm_slice
        return -(-kw["k"] // vmm_slice(kw["k"], tile))
    if family == "ssm_scan":
        from repro_torch.kernels.ssm_scan import ssm_scan as scan
        s = kw["s"]
        return (scan.fwd_channels(tile.d_tile, kw["d"]),
                max(1, min(tile.chunk, scan.FWD_MAX_CHUNK, s)),
                scan.bwd_window(s, tile.chunk))
    return tile


def _card_candidates(family: str, kw, precision: str) -> List[Any]:
    """The enumerators the card's sweeps time, for one launch."""
    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.vmm import vmm as vm
    bf16, esize = precision == "bf16", cost.ELT_BYTES[precision]
    if family == "conv2d_fwd":
        if kw["k"] not in cv.CONV_KS:
            return []
        h, w, cin, cout, k = (kw[x] for x in ("h", "w", "cin", "cout", "k"))
        if bf16 and cin % cv.CONV_MMA_K16 == 0:
            return cv.conv_mma_candidates(h, w, cin, cout, k)
        return cv.conv_candidates(h, cin, cout, k, esize=esize)
    if family == "conv2d_bwd":
        if kw["k"] not in cv.CONV_KS:
            return []
        h, w = _conv_out_hw(kw)
        s, c, cout, k = kw["s"], kw["c"], kw["cout"], kw["k"]
        pooled = bool(kw["pooled"])
        if bf16 and c % cv.CONV_MMA_K16 == 0:
            return cv.conv_bwd_mma_candidates(s, h, w, c, cout, k,
                                              pooled=pooled)
        return cv.conv_bwd_candidates(s, h, c, cout, k, pooled=pooled,
                                      esize=esize)
    if family == "vmm_fwd":
        if bf16:
            return vm.vmm_mma_candidates(kw["m"], kw["k"], kw["n"])
        return list(range(1, vm.vmm_max_splits(kw["k"]) + 1))
    if family == "vmm_bwd":
        enum = vm.vmm_bwd_mma_candidates if bf16 else vm.vmm_bwd_candidates
        return enum(kw["s"], kw["m"], kw["k"], kw["n"])
    if family == "ssm_scan":
        return _scan_candidates(kw)
    raise ValueError(f"no tile candidates for family {family!r}")


#: Card candidates whose estimate is within this factor of the best rank
#: among themselves by the bytes their blocks stage (fewer first: larger
#: tiles reuse more), as the JAX package's ties prefer the larger tile.
CARD_RANK_BAND = 1.05


def _ranked(scored) -> List[Any]:
    """``(est_s, staged_bytes, fields, plan)`` rows -> plans, best first:
    the band of estimates within :data:`CARD_RANK_BAND` of the best by
    staged bytes, then the rest by estimate."""
    if not scored:
        return []
    best = min(est for est, _, _, _ in scored)
    band = sorted((r for r in scored if r[0] <= CARD_RANK_BAND * best),
                  key=lambda r: (r[1], r[2]))
    rest = sorted((r for r in scored if r[0] > CARD_RANK_BAND * best),
                  key=lambda r: (r[0], r[1], r[2]))
    return [r[3] for r in band + rest]


def _plan_card(family: str, kw: Dict[str, Any], profile: GpuProfile,
               precision: str, autotune: bool):
    """The rule's plan; with ``autotune``, the fastest of it and the
    :data:`AUTOTUNE_TOP_K` best-ranked others (one per launch they make).
    Returns ``(plan, measured_us | None, rule_us | None)``."""
    rule = _rule_plan(family, kw, profile, precision)
    fp = cost.card_footprint(family, kw, rule, precision, profile)
    if not fp.fits(profile):
        raise InfeasiblePlanError(
            f"{family} {kw}: the rule's {rule} needs {fp.vmem_bytes} B of "
            f"shared memory > {profile.card}'s {profile.vmem_bytes} B a "
            f"block")
    if not autotune:
        return rule, None, None
    seen, scored = {_launch_key(family, kw, rule)}, []
    for tile in _card_candidates(family, kw, precision):
        key = _launch_key(family, kw, tile)
        if key in seen or not _card_valid(family, kw, tile, precision):
            continue
        fp = cost.card_footprint(family, kw, tile, precision, profile)
        if fp.fits(profile):
            seen.add(key)
            scored.append((fp.est_time_s(profile), fp.staged_bytes,
                           _encode_tile(tile), tile))
    rule_us = measure_kernel(family, kw, rule, precision)
    best, best_us = rule, rule_us
    for tile in _ranked(scored)[:AUTOTUNE_TOP_K]:
        us = measure_kernel(family, kw, tile, precision)
        if us < best_us:
            best_us, best = us, tile
    return best, best_us, rule_us


def _plan_family(family: str, kw: Dict[str, Any], profile, precision: str,
                 autotune: bool) -> Tuple[Any, Optional[float]]:
    """The four-step sweep: enumerate -> reject over-budget -> rank ->
    (optionally) measure.  Returns ``(tile, measured_us | None)``."""
    if isinstance(profile, GpuProfile):
        return _plan_card(family, kw, profile, precision, autotune)[:2]
    scored = []
    for tile in _candidates(family, kw):
        fp = _footprint(family, kw, tile, precision, profile)
        if fp.fits(profile):
            scored.append((fp.est_time_s(profile), -_tile_volume(tile), tile))
    if not scored:
        raise InfeasiblePlanError(
            f"{family} {kw} has no tile fitting {profile.name}'s "
            f"{profile.vmem_bytes} B on-chip budget under "
            f"precision={precision!r}")
    scored.sort(key=lambda t: t[:2])
    if not autotune:
        return scored[0][2], None
    best_us, best = None, scored[0][2]
    for _, _, tile in scored[:AUTOTUNE_TOP_K]:
        us = measure_kernel(family, kw, tile, precision)
        if best_us is None or us < best_us:
            best_us, best = us, tile
    return best, best_us


def plan_conv2d(n: int, h: int, w: int, k: int, cin: int, cout: int, *,
                profile=None, precision: str = "f32", autotune: bool = False):
    """Plan the conv forward's tile for one layer shape."""
    profile = get_profile(profile)
    kw = dict(n=n, h=h, w=w, k=k, cin=cin, cout=cout)
    return _plan_family("conv2d_fwd", kw, profile, precision, autotune)[0]


def plan_vmm(m: int, k: int, n: int, *, profile=None,
             precision: str = "f32", autotune: bool = False):
    """Plan the FC forward for one matmul shape (a TPU ``VmmTile``, or on
    the card its K split count / ``VmmMmaPlan``)."""
    profile = get_profile(profile)
    kw = dict(m=m, k=k, n=n)
    return _plan_family("vmm_fwd", kw, profile, precision, autotune)[0]


def _plan_entries(launches, profile, precision: str, autotune: bool,
                  cache: Optional[TuningCache]) -> TilePlan:
    """Plan every ``(key, family, kw)`` launch (pool launches audited
    only), through ``cache``."""
    card = isinstance(profile, GpuProfile)
    dtype = PLAN_DTYPES[precision]
    entries, shapes = [], []
    for key, family, kw in launches:
        if family == "pool":
            fp = _footprint(family, kw, None, precision, profile)
            if not fp.fits(profile):
                raise InfeasiblePlanError(
                    f"{key} ({family} {kw}) needs {fp.vmem_bytes} B on-chip "
                    f"> {profile.name}'s {profile.vmem_bytes} B budget")
            continue
        sig = [int(v) for v in kw.values()]
        if card:
            shapes.append((key, tuple(sig)))
        ck = None
        if cache is not None:
            ck = cache_key(family, sig, dtype, precision,
                           profile.cache_device)
            # an analytic-only entry must not satisfy an autotuned build
            hit = cache.lookup(ck, require_measured=autotune)
            if hit is not None:
                try:
                    entries.append((key, _decode_tile(family, hit["tile"],
                                                      hit.get("plan"))))
                    continue
                except (KeyError, TypeError, ValueError):
                    pass        # wrong-family blob: replan + store over it
        if card:
            tile, measured, rule_us = _plan_card(family, kw, profile,
                                                 precision, autotune)
        else:
            tile, measured = _plan_family(family, kw, profile, precision,
                                          autotune)
        if cache is not None:
            entry = {"family": family, "tile": _encode_tile(tile),
                     "measured_us": measured}
            if card:
                entry.update(plan=_plan_kind(tile), rule_us=rule_us)
            cache.store(ck, entry)
        entries.append((key, tile))
    return TilePlan(device=profile.name, precision=precision,
                    entries=tuple(entries), shapes=tuple(shapes))


# ---------------------------------------------------------------------------
# whole-model planning (the paper CNN layer walk)
# ---------------------------------------------------------------------------


def shard_batch_seeds(batch: int, seeds: int,
                      n_shards: int) -> Tuple[int, int]:
    """Per-shard ``(batch, seeds)`` once a mesh splits the two data axes:
    the batch axis first, leftover shards split the seeds; ceil-divided,
    so the shapes are the worst-case shard's."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    batch_ways = min(n_shards, max(batch, 1))
    local_batch = -(-max(batch, 1) // batch_ways)
    seed_ways = min(n_shards // batch_ways, max(seeds, 1))
    local_seeds = -(-max(seeds, 1) // max(seed_ways, 1))
    return local_batch, local_seeds


def cnn_kernel_shapes(cfg, batch: int = 1, seeds: int = 1):
    """Every kernel launch of the CNN's forward + fused-BP stack, in layer
    order: ``(key, family, shape-kwargs)`` triples, shared by the planner,
    the footprint audit, the drift table and the model's launches."""
    out = []
    h, w = cfg.in_hw
    cin, k = cfg.in_ch, cfg.kernel
    for i, cout in enumerate(cfg.channels):
        pooled = (i + 1) % cfg.pool_every == 0
        out.append((f"conv{i}.fwd", "conv2d_fwd",
                    dict(n=batch, h=h, w=w, k=k, cin=cin, cout=cout)))
        hg, wg = (h // 2, w // 2) if pooled else (h, w)
        out.append((f"conv{i}.bwd", "conv2d_bwd",
                    dict(s=seeds, n=batch, hg=hg, wg=wg, k=k, c=cout,
                         cout=cin, pooled=pooled, gated=cfg.conv_relu)))
        if pooled:
            out.append((f"pool{i}", "pool", dict(n=batch, h=h, w=w, c=cout)))
            h, w = h // 2, w // 2
        cin = cout
    fin = cfg.flat_features()
    dims = tuple(cfg.fc) + (cfg.num_classes,)
    n_fc = len(dims)
    for i, f in enumerate(dims):
        out.append((f"fc{i}.fwd", "vmm_fwd", dict(m=batch, k=fin, n=f)))
        out.append((f"fc{i}.bwd", "vmm_bwd",
                    dict(s=seeds, m=batch, k=f, n=fin, gated=i < n_fc - 1)))
        fin = f
    return out


def plan_cnn(cfg, device=None, precision: str = "f32", *, batch: int = 1,
             seeds: int = 1, autotune: bool = False,
             cache: Optional[TuningCache] = None) -> TilePlan:
    """Plan every kernel of the CNN stack for ``device`` (a profile name or
    :class:`~repro_torch.plan.profiles.DeviceProfile`).

    ``cache`` short-circuits planning AND measuring per kernel on a hit;
    misses are planned, measured when ``autotune`` is set, and written
    through.  Pool launches carry no tile knob but are audited against the
    budget.  A mesh profile splits the batch and seeds axes across its
    shards first (:func:`shard_batch_seeds`).
    """
    if precision not in PLAN_DTYPES:
        raise ValueError(f"precision={precision!r} not in "
                         f"{tuple(PLAN_DTYPES)}")
    profile = get_profile(device)
    if isinstance(profile, MeshProfile):
        batch, seeds = shard_batch_seeds(batch, seeds, profile.n_shards)
    return _plan_entries(cnn_kernel_shapes(cfg, batch, seeds), profile,
                         precision, autotune, cache)


def planned_tile(plan: Optional[TilePlan], key: str, kw, profile):
    """The tile ``plan`` gives launch ``key`` of shape ``kw`` under
    ``profile``: on the card only an entry planned at this shape
    (:meth:`TilePlan.at`), elsewhere the entry; None for the default."""
    if plan is None:
        return None
    if isinstance(profile, GpuProfile):
        return plan.at(key, [int(v) for v in kw.values()])
    return plan.get(key)


def cnn_plan_footprints(cfg, plan: Optional[TilePlan], *,
                        precision: str = "f32", batch: int = 1,
                        seeds: int = 1, profile=None
                        ) -> Dict[str, cost.Footprint]:
    """Analytic footprint of every kernel launch under ``plan`` (missing
    entries fall back to the default tile policy; on the card, entries
    planned at another shape to the rule) — the per-layer resource audit.
    Mesh profiles audit the per-shard slice."""
    profile = get_profile(profile if profile is not None
                          else (plan.device if plan else None))
    if isinstance(profile, MeshProfile):
        batch, seeds = shard_batch_seeds(batch, seeds, profile.n_shards)
    return {key: _footprint(family, kw, planned_tile(plan, key, kw, profile),
                            precision, profile)
            for key, family, kw in cnn_kernel_shapes(cfg, batch, seeds)}


# ---------------------------------------------------------------------------
# whole-model planning (the LM attribution stack)
# ---------------------------------------------------------------------------

#: sequence length the engine plans LM kernels at.  The scan's per-cell
#: VMEM is sequence-independent once ``chunk <= s``, so one planning length
#: serves every bucket; on the card the scan's knobs are clamped per
#: launch (``fwd_channels``, ``bwd_window``), so a ``ScanTile`` applies at
#: every sequence length too.
LM_PLAN_SEQ = 128


def lm_kernel_shapes(cfg, batch: int = 1, seq: int = LM_PLAN_SEQ):
    """Every planned kernel launch of the LM attribution stack: one
    ``ssm_scan`` launch per mamba / hybrid segment of
    ``cfg.layer_plan()``; ``chunk_default`` records the config's unplanned
    chunk length."""
    out = []
    for si, (kind, _count, _window) in enumerate(cfg.layer_plan()):
        if kind in ("mamba", "hybrid"):
            out.append((f"ssm{si}.scan", "ssm_scan",
                        dict(b=batch, s=seq, d=cfg.d_inner, n=cfg.ssm_state,
                             chunk_default=cfg.ssm_chunk)))
    return out


def plan_lm(cfg, device=None, precision: str = "f32", *, batch: int = 1,
            seq: int = LM_PLAN_SEQ, autotune: bool = False,
            cache: Optional[TuningCache] = None) -> TilePlan:
    """Plan the LM attribution stack's scan launches for ``device``,
    mirroring :func:`plan_cnn` (f32 or bf16: token attribution runs on
    float gradients)."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"plan_lm supports precision f32|bf16, "
                         f"got {precision!r}")
    profile = get_profile(device)
    if isinstance(profile, MeshProfile):
        batch, _ = shard_batch_seeds(batch, 1, profile.n_shards)
    return _plan_entries(lm_kernel_shapes(cfg, batch, seq), profile,
                         precision, autotune, cache)


def lm_plan_footprints(cfg, plan: Optional[TilePlan], *,
                       precision: str = "f32", batch: int = 1,
                       seq: int = LM_PLAN_SEQ, profile=None
                       ) -> Dict[str, cost.Footprint]:
    """Analytic footprint of every LM kernel launch under ``plan`` (None
    entries model the unplanned whole-D launch)."""
    profile = get_profile(profile if profile is not None
                          else (plan.device if plan else None))
    if isinstance(profile, MeshProfile):
        batch, _ = shard_batch_seeds(batch, 1, profile.n_shards)
    out = {}
    for key, family, kw in lm_kernel_shapes(cfg, batch, seq):
        tile = plan.get(key) if plan is not None else None
        out[key] = _footprint(family, kw, tile, precision, profile)
    return out
