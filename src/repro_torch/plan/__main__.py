"""CLI: plan the paper CNN for a device profile, with the tuning cache.

    PYTHONPATH=src python -m repro_torch.plan --device edge-small
    python -m repro_torch.plan --device h100 --autotune        # on the card

Prints the per-kernel plan with its footprint audit and the cache
hit / miss counters, as ``python -m repro.plan`` does.
``--expect-full-hit`` exits 2 unless EVERY kernel was served from the
tuning cache (run twice: the second pass must replan without measuring);
an over-budget kernel exits 1.  Cache location: ``--cache`` or
``$REPRO_TORCH_PLAN_CACHE`` (see :mod:`repro_torch.plan.cache`).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    from repro_torch.models import cnn as cnn_lib
    from repro_torch.plan import (TuningCache, cnn_plan_footprints,
                                  get_profile, plan_cnn, profile_names)

    ap = argparse.ArgumentParser(prog="python -m repro_torch.plan")
    ap.add_argument("--device", default="detected",
                    help=f"one of {profile_names()} or 'mesh:<profile>:<n>' "
                         f"(e.g. mesh:edge-small:4)")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "fxp16"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--autotune", action="store_true",
                    help="refine the plan by measured timing (the card)")
    ap.add_argument("--cache", default=None,
                    help="tuning-cache JSON path (default: "
                         "$REPRO_TORCH_PLAN_CACHE or "
                         "~/.cache/repro_torch/)")
    ap.add_argument("--expect-full-hit", action="store_true",
                    help="exit 2 unless every kernel hit the tuning cache")
    args = ap.parse_args(argv)

    cfg = cnn_lib.CNNConfig()
    profile = get_profile(args.device)
    cache = TuningCache(args.cache)
    t0 = time.perf_counter()
    plan = plan_cnn(cfg, device=profile, precision=args.precision,
                    batch=args.batch, seeds=args.seeds,
                    autotune=args.autotune, cache=cache)
    dt_ms = (time.perf_counter() - t0) * 1e3
    fps = cnn_plan_footprints(cfg, plan, precision=args.precision,
                              batch=args.batch, seeds=args.seeds,
                              profile=profile)

    shards = getattr(profile, "n_shards", 1)
    mesh_note = f" n_shards={shards}" if shards > 1 else ""
    print(f"[plan] device={profile.name} vmem_budget="
          f"{profile.vmem_bytes / 2**20:.1f}MB{mesh_note} "
          f"precision={args.precision} planned in {dt_ms:.1f}ms")
    for key, tile in plan.entries:
        fp = fps[key]
        print(f"  {key:12s} {str(tile):34s} vmem={fp.vmem_bytes / 1024:8.1f}KB"
              f" fits={fp.fits(profile)}")
    print(f"[plan] cache={cache.path} entries={len(cache)} "
          f"hits={cache.hits} misses={cache.misses}")
    over = [k for k, fp in fps.items() if not fp.fits(profile)]
    if over:
        print(f"[plan] ERROR: over-budget kernels: {over}", file=sys.stderr)
        return 1
    if args.expect_full_hit and cache.misses:
        print(f"[plan] ERROR: expected a 100% cache hit, got "
              f"{cache.misses} misses", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
