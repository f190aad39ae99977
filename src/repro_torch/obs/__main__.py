"""``python -m repro_torch.obs`` — the observability CLI, as
``python -m repro.obs`` has it.

Subcommands::

    trace     run a short traced load-replay (simulated adapter, virtual
              clock) and write a Perfetto-loadable Chrome trace-event
              JSON, optionally the unified metrics snapshot
    validate  schema-check a trace-event JSON file (exit 1 on problems)
    metrics   print the default-registry catalog (JSON or Prometheus text)
    drift     print a persisted cost-model drift table (the profiler's or
              the card's measured times against the tile planner's
              estimates), as ``launch/serve.py --profile-kernels`` writes
              it

The ``trace`` run is the CI smoke: deterministic (virtual clock, seeded
trace), a few hundred requests, every admitted request leaving
admission -> queued -> engine -> cache spans.  It needs no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEADLINES = {"predict": 0.05, "explain": 0.1}


def _cmd_trace(args) -> int:
    from repro_torch.obs import registry as obs_registry
    from repro_torch.obs.trace import (Tracer, integrity_errors,
                                       validate_chrome)
    from repro_torch.serve import (AdmissionConfig, DegradePolicy,
                                   ExplanationServer)
    from repro_torch.serve.replay import (SimAdapter, VirtualClock, replay,
                                          synthesize)

    clock = VirtualClock()
    tracer = Tracer(clock=clock)
    server = ExplanationServer(
        SimAdapter(clock), max_batch=8, max_delay_s=0.002, clock=clock,
        tracer=tracer,
        admission=AdmissionConfig(
            capacity=256, default_deadline_s=DEADLINES["predict"],
            degrade=DegradePolicy(pressure_threshold=0.5,
                                  reroute_precision="fxp16")),
        method_opts={"integrated_gradients": {"steps": 4},
                     "smoothgrad": {"n": 4}})
    trace = synthesize(args.n, rate=args.rate, arrivals=args.arrivals,
                       seed=args.seed, deadline_s=DEADLINES)
    rep = replay(server, trace)
    tracer.finish()

    problems = integrity_errors(tracer.spans)
    chrome = tracer.to_chrome()
    problems += validate_chrome(chrome)
    tracer.save(args.out)
    print(f"replayed {rep.offered} requests "
          f"(completed={rep.completed} shed={rep.shed_total}): "
          f"{len(tracer.spans)} spans -> {args.out}")
    if args.metrics_out:
        from repro_torch.obs import jsonsafe
        with open(args.metrics_out, "w") as f:
            jsonsafe.dump_strict(obs_registry.snapshot(), f, indent=2)
        print(f"metrics snapshot -> {args.metrics_out}")
    if problems:
        for p in problems:
            print(f"PROBLEM: {p}", file=sys.stderr)
        return 1
    return 0


def _cmd_validate(args) -> int:
    from repro_torch.obs.trace import validate_chrome
    with open(args.path) as f:
        try:
            obj = json.load(f)
        except ValueError as e:
            print(f"PROBLEM: not valid JSON: {e}", file=sys.stderr)
            return 1
    problems = validate_chrome(obj)
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    if not problems:
        n = len(obj.get("traceEvents", []))
        print(f"ok: {args.path} ({n} events)")
    return 1 if problems else 0


def _cmd_metrics(args) -> int:
    from repro_torch.obs import metrics  # noqa: F401  (the catalog)
    from repro_torch.obs import registry as obs_registry
    if args.format == "prometheus":
        print(obs_registry.render_prometheus(), end="")
    else:
        from repro_torch.obs import jsonsafe
        print(jsonsafe.dumps_strict(obs_registry.snapshot(), indent=2))
    return 0


def _cmd_drift(args) -> int:
    from repro_torch.plan.drift import drift_path, format_drift
    path = args.path if args.path else drift_path()
    try:
        with open(path) as f:
            table = json.load(f)
    except OSError as e:
        print(f"no drift table at {path}: {e}", file=sys.stderr)
        return 1
    print(format_drift(table["rows"]))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="traced simulated load-replay")
    t.add_argument("--out", default="trace.json")
    t.add_argument("-n", type=int, default=400)
    t.add_argument("--rate", type=float, default=1500.0)
    t.add_argument("--arrivals", choices=("poisson", "bursty"),
                   default="poisson")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--metrics-out", default=None)
    t.set_defaults(fn=_cmd_trace)

    v = sub.add_parser("validate", help="schema-check a trace JSON file")
    v.add_argument("path")
    v.set_defaults(fn=_cmd_validate)

    m = sub.add_parser("metrics", help="print the default registry")
    m.add_argument("--format", choices=("json", "prometheus"),
                   default="json")
    m.set_defaults(fn=_cmd_metrics)

    d = sub.add_parser("drift", help="print a persisted drift table")
    d.add_argument("--path", default=None)
    d.set_defaults(fn=_cmd_drift)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pipe (e.g. `| head`) closed early; not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
