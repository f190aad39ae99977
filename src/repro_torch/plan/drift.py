"""Cost-model drift: measured kernel times vs :meth:`Footprint.est_time_s`.

``repro.plan.drift``'s table: per ``cnn_kernel_shapes`` launch, the
estimated and measured microseconds and their ratio.  Measured times come
from the first source that has the launch:

  1. a :class:`repro_torch.obs.profile.KernelProfiler` aggregate whose
     (family, dims, precision) key matches (the profiler's signatures keep
     the planner's key order);
  2. the tuning cache's ``measured_us`` (written by ``autotune=True``);
  3. a fresh :func:`repro_torch.plan.planner.measure_kernel` when
     ``measure=True`` (on the card; a TPU plan's pool launches carry no
     tile and join only through source 1, the card's pool is timed on its
     own wrapper).

The table persists next to the tuning cache (``<cache>.drift.json``) as
strict JSON; ``python -m repro_torch.obs drift`` and ``launch/serve.py
--profile-kernels`` print it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from repro_torch.obs import jsonsafe
from repro_torch.plan.cache import TuningCache, cache_key, default_cache_path
from repro_torch.plan.planner import (PLAN_DTYPES, TilePlan, _footprint,
                                      _plan_family, cnn_kernel_shapes,
                                      measure_kernel, planned_tile)
from repro_torch.plan.profiles import GpuProfile, get_profile

__all__ = ["drift_path", "drift_rows", "format_drift", "write_drift"]


def drift_path(cache_path: Optional[str] = None) -> str:
    """Drift-table path next to the tuning cache it calibrates."""
    base = cache_path if cache_path is not None else default_cache_path()
    root, _ = os.path.splitext(base)
    return root + ".drift.json"


def _measured_us(family, kw, dims, precision, tile, profile, *,
                 profiler=None, cache=None, measure=False):
    """(measured_us, source) from the first source that has this launch."""
    if profiler is not None:
        agg = profiler.aggregates().get((family, dims, precision))
        if agg is not None:
            return agg["mean_us"], "profiler"
    if cache is not None and family != "pool":
        ck = cache_key(family, list(dims), PLAN_DTYPES[precision],
                       precision, profile.cache_device)
        entry = cache.lookup(ck, require_measured=True)
        if entry is not None:
            return entry["measured_us"], "cache"
    card = isinstance(profile, GpuProfile)
    if measure and (family != "pool" or card):
        if tile is None and family != "pool":
            tile, _ = _plan_family(family, kw, profile, precision, False)
        return measure_kernel(family, kw, tile, precision), "measured"
    return None, None


def drift_rows(cfg, plan: Optional[TilePlan] = None, *, device=None,
               precision: str = "f32", batch: int = 1, seeds: int = 1,
               profiler=None, cache: Optional[TuningCache] = None,
               measure: bool = False) -> List[Dict[str, Any]]:
    """One row per CNN kernel launch: est_us, measured_us, drift ratio.

    Rows without any measured source carry ``measured_us=None`` and
    ``drift=None`` (strict-JSON safe), so the table always names every
    launch.
    """
    profile = get_profile(device if device is not None
                          else (plan.device if plan is not None else None))
    rows = []
    for key, family, kw in cnn_kernel_shapes(cfg, batch, seeds):
        dims = tuple(int(v) for v in kw.values())
        tile = planned_tile(plan, key, kw, profile)
        est_s = _footprint(family, kw, tile, precision,
                           profile).est_time_s(profile)
        measured, source = _measured_us(
            family, kw, dims, precision, tile, profile,
            profiler=profiler, cache=cache, measure=measure)
        est_us = 1e6 * est_s
        rows.append({
            "key": key, "family": family,
            "shape": "x".join(str(d) for d in dims),
            "precision": precision, "device": profile.name,
            "est_us": est_us,
            "measured_us": measured,
            "source": source,
            "drift": (measured / est_us
                      if measured is not None and est_us > 0 else None),
        })
    return rows


def write_drift(rows: List[Dict[str, Any]],
                path: Optional[str] = None) -> str:
    """Persist the table (strict JSON) next to the tuning cache."""
    out = path if path is not None else drift_path()
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        jsonsafe.dump_strict({"rows": rows}, f, indent=2)
    return out


def format_drift(rows: List[Dict[str, Any]]) -> str:
    """Fixed-width table; unmeasured rows print '-'."""
    hdr = (f"{'key':<12} {'family':<11} {'shape':<24} "
           f"{'est_us':>10} {'meas_us':>10} {'drift':>7}  source")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        meas = f"{r['measured_us']:.1f}" if r["measured_us"] is not None \
            else "-"
        drift = f"{r['drift']:.2f}x" if r["drift"] is not None else "-"
        lines.append(f"{r['key']:<12} {r['family']:<11} {r['shape']:<24} "
                     f"{r['est_us']:>10.1f} {meas:>10} {drift:>7}  "
                     f"{r['source'] or '-'}")
    return "\n".join(lines)
