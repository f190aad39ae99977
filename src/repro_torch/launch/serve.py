"""Serving driver on the :mod:`repro_torch.serve` subsystem, as
``repro.launch.serve`` has it.

The paper's end goal — "real-time XAI on the edge" — as a service: requests
can ask not just for the next tokens (or class) but for WHY, served from the
same weights.  Two workloads:

  * ``--workload lm``  — token-level LM attribution as a served workload
    (:mod:`repro_torch.lm`): step-wise decode with per-generated-token
    contrastive attribution, then a mixed predict/explain stream through
    the ``ExplanationServer`` on an ``LMAdapter`` — sequence-length-bucketed
    batching, the same admission/deadline knobs as the CNN path.  Method
    choices come from the registry's token-capable explainers.
  * ``--workload cnn`` — a mixed predict/explain stream through the
    ``ExplanationServer`` (micro-batching + residual-mask cache): every
    explain that follows a predict for the same request id skips the
    forward pass and replays only the BP phase over the stored 1-/2-bit
    masks (paper §III.F).

Both run on the card unless ``--torch-device cpu`` asks for the CPU::

    python -m repro_torch.launch.serve --workload cnn --requests 16
    python -m repro_torch.launch.serve --workload lm --arch falcon-mamba-7b \\
        --method token_ixg --torch-device cpu

``--method occlusion|lime|rise`` serves the perturbation explainers
(``--perturb-samples`` sets lime's and rise's fan-out).
``--device-profile`` plans the kernels for a :mod:`repro_torch.plan`
profile before anything runs (``h100``: the card's own launch objects;
the JAX package's profiles: audits), ``--autotune`` refines the plan by
measured kernel times through the tuning cache.  ``--profile-kernels``
times every kernel wrapper call (fenced), prints the profiler's
aggregates and the cost-model drift table (estimate against measured time
per launch; on the card every launch is measured), and writes the table
(``--drift-out``, default next to the tuning cache).
``generate`` / ``explain`` stay importable helpers for the LM path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import engine as engine_lib
from repro_torch.engine.spec import resolve_device
from repro_torch.models import cnn as cnn_lib, transformer as tf
from repro_torch.obs import Tracer, dumps_strict, snapshot as obs_snapshot
from repro_torch.obs import profile as obs_profile
from repro_torch.serve import (AdmissionConfig, CNNAdapter, DegradePolicy,
                               ExplanationServer, Request, ShedError,
                               registry)


def generate(cfg, params, prompt_tokens, *, max_new: int = 16):
    """Greedy decode: prefill + decode_step loop. Returns [B, max_new]."""
    from repro_torch import lm as lm_lib
    return lm_lib.decode(params, cfg, prompt_tokens,
                         max_new=max_new).generated


def explain(cfg, params, prompt_tokens, *, method: str = "saliency",
            device=None):
    """Per-prompt-token relevance for the model's next-token prediction.

    Built once through the engine (build-cached: repeated calls for the
    same params/method reuse the engine and its token step).
    """
    eng = engine_lib.build(engine_lib.EngineSpec(
        model=engine_lib.LMModel(params, cfg, device=device), method=method))
    logits, scores = eng.explain_tokens({"tokens": prompt_tokens})
    return logits, scores


def _admission(args, degrade=None):
    if args.capacity is None and args.deadline_ms is None:
        return None
    return AdmissionConfig(
        capacity=args.capacity if args.capacity is not None else 1024,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms is not None else None),
        degrade=degrade)


def _run_stream(server, reqs):
    """Submit every request, poll after each, drain; sheds are counted."""
    responses, sheds = [], 0
    for req in reqs:                  # serve()'s dict collapses uids; keep all
        try:
            server.submit(req)
        except ShedError:             # admission refusal: typed, never a stall
            sheds += 1
            continue
        responses.extend(server.poll())
    responses.extend(server.drain())
    return responses, sheds


def _report(tag, server, tracer, args):
    for name, snap in server.stats.snapshot()["methods"].items():
        print(f"  {name:28s} n={snap['count']:3d} p50={snap['p50_us']:.0f}us "
              f"p99={snap['p99_us']:.0f}us hit_rate={snap['hit_rate']:.2f}")
    if tracer is not None:
        tracer.finish()
        tracer.save(args.trace_out)
        print(f"[serve/{tag}] trace: {len(tracer.spans)} spans -> "
              f"{args.trace_out} (load in https://ui.perfetto.dev)")
    if args.metrics:
        print(f"[serve/{tag}] unified metrics snapshot:")
        print(dumps_strict(obs_snapshot(), indent=2))


def run_lm(args) -> None:
    from repro_torch import lm as lm_lib

    device = resolve_device(args.torch_device)
    cfg = configs.get_smoke(args.arch)
    params = tf.init(cfg, generator=torch.Generator(device=device)
                     .manual_seed(0), device=device)
    # Bare rule-set names (saliency/deconvnet/guided) predate the served
    # token explainers; they map to token_ixg — the historical ixg score
    # reduction — so old invocations keep working through the server path.
    method = (args.method if args.method.startswith("token_")
              else "token_ixg")
    if method != args.method:
        print(f"[serve/lm] --method {args.method} -> {method} "
              f"(LM serving dispatches the registry token explainers)")
    # configure-once, as the CNN path: the spec resolves the scan's plan
    # for the device profile before anything runs
    adapter = lm_lib.LMAdapter.from_engine(engine_lib.build(
        engine_lib.EngineSpec(model=engine_lib.LMModel(params, cfg,
                                                       device=device),
                              method="saliency", precision=args.precision,
                              device=args.device_profile,
                              autotune=args.autotune)))
    eng = adapter.engine
    if eng.plan is not None:
        print(f"[serve/lm] planned ssm_scan tiles for device profile "
              f"{args.device_profile!r}:")
        for line in eng.plan.summary().splitlines()[1:]:
            print(f"  {line.strip()}")

    # step-wise generation + per-generated-token contrastive attribution
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=device)
                            .manual_seed(1), device=device)
    t0 = time.time()
    result = lm_lib.decode(params, cfg, prompts, max_new=args.max_new)
    print(f"[serve/lm] decoded {tuple(result.generated.shape)} in "
          f"{time.time() - t0:.2f}s on {device}")
    t0 = time.time()
    per_tok = lm_lib.explain_generated(params, cfg, result, plan=eng.plan)
    print(f"[serve/lm] contrastive per-generated-token attribution "
          f"{tuple(per_tok.shape)} in {time.time() - t0:.2f}s")

    admission = _admission(args)
    tracer = Tracer() if args.trace_out else None
    server = ExplanationServer(adapter, max_batch=args.batch,
                               max_delay_s=args.max_delay_ms / 1e3,
                               admission=admission, tracer=tracer)
    # mixed predict/explain traffic over ragged prompt lengths: pow2
    # padding buckets equal-length requests into shared launches (the
    # batcher's shape-keyed buckets ARE the sequence buckets)
    rng = np.random.RandomState(2)
    reqs = []
    for i in range(args.requests):
        s = int(rng.randint(max(2, args.prompt_len // 2),
                            args.prompt_len + 1))
        toks = np.asarray(lm_lib.pad_tokens(
            rng.randint(0, cfg.vocab, size=(s,)).astype(np.int32)))
        reqs.append(Request(uid=f"q{i}", kind="predict", x=toks))
        reqs.append(Request(uid=f"q{i}", kind="explain", x=toks,
                            method=method))
    buckets = sorted({req.x.shape[-1] for req in reqs})
    t0 = time.time()
    responses, sheds = _run_stream(server, reqs)
    dt = time.time() - t0
    errors = sum(1 for r in responses if not r.ok)
    print(f"[serve/lm] {len(responses)} responses in {dt:.2f}s "
          f"({len(responses) / dt:.1f} req/s); sequence buckets {buckets}; "
          f"{errors} errors")
    if admission is not None:
        snap = server.stats.snapshot()
        print(f"[serve/lm] admission: {sheds} shed at submit "
              f"(by reason {snap['sheds']}), "
              f"peak queue {snap['peak_queue_depth']}")
    for resp in responses:
        if resp.kind == "explain" and resp.ok:
            rel = resp.relevance.float().abs().cpu().numpy()
            print(f"  {resp.uid}: most relevant prompt positions "
                  f"{np.argsort(-rel)[:5].tolist()}")
            break
    _report("lm", server, tracer, args)


def run_cnn(args) -> None:
    device = resolve_device(args.torch_device)
    cfg = cnn_lib.CNNConfig()
    params = cnn_lib.init(torch.Generator().manual_seed(0), cfg)
    # configure-once: the spec decides precision x store-rules x backend x
    # tile plan; the server/adapter only ever execute the built engine.
    eng = engine_lib.build(engine_lib.EngineSpec(
        model=engine_lib.CNNModel(params, cfg, device=device),
        method="saliency", precision=args.precision,
        device=args.device_profile, autotune=args.autotune))
    if eng.n_shards > 1:
        print(f"[serve/cnn] mesh-sharded engine: {eng.n_shards} shards, "
              f"batcher fills {args.batch * eng.n_shards} seats/launch")
    if eng.plan is not None:
        print(f"[serve/cnn] planned tiles for device profile "
              f"{args.device_profile!r}:")
        for line in eng.plan.summary().splitlines()[1:]:
            print(f"  {line.strip()}")
    degrade = None
    if args.degrade_pressure is not None:
        # above the occupancy threshold: collapse top-K panels to argmax
        # and reroute float explains to the int16 sibling engine
        degrade = DegradePolicy(
            pressure_threshold=args.degrade_pressure,
            reroute_precision=("fxp16" if args.precision == "f32"
                               else None))
    admission = _admission(args, degrade)
    tracer = Tracer() if args.trace_out else None
    profiler = obs_profile.enable() if args.profile_kernels else None
    method_opts = {}
    if args.perturb_samples is not None:
        method_opts = {m: {"n_samples": args.perturb_samples}
                       for m in ("lime", "rise")}
    server = ExplanationServer(CNNAdapter.from_engine(eng),
                               max_batch=args.batch,
                               max_delay_s=args.max_delay_ms / 1e3,
                               method_opts=method_opts,
                               admission=admission, tracer=tracer)
    n = args.requests
    xs = torch.randn((n,) + cfg.in_hw + (cfg.in_ch,),
                     generator=torch.Generator().manual_seed(1)).numpy()
    cls = registry.get(args.method)
    reqs = []
    for i in range(n):
        reqs.append(Request(uid=f"q{i}", kind="predict", x=xs[i]))
        reqs.append(Request(
            uid=f"q{i}", kind="explain", x=xs[i], method=args.method,
            topk=args.topk if (i % 2 and cls.mask_reuse) else None,
            key=100 + i if cls.needs_key else None))
    t0 = time.time()
    responses, sheds = _run_stream(server, reqs)
    dt = time.time() - t0
    n_explain = sum(r.kind == "explain" for r in responses)
    hits = sum(r.cache_hit for r in responses)
    errors = [r for r in responses if not r.ok]
    print(f"[serve/cnn] {len(responses)} responses in {dt:.2f}s "
          f"({len(responses) / dt:.1f} req/s) on {device}; cache hits "
          f"{hits}/{n_explain} explains; {len(errors)} errors")
    for r in errors[:3]:
        print(f"  {r.uid} {r.kind}: {r.error_type}: {r.error}")
    if admission is not None:
        snap = server.stats.snapshot()
        print(f"[serve/cnn] admission: {sheds} shed at submit "
              f"(by reason {snap['sheds']}), degrades {snap['degrades']}, "
              f"peak queue {snap['peak_queue_depth']}")
    print(f"[serve/cnn] cache: {server.cache.stats.snapshot()}")
    _report("cnn", server, tracer, args)
    if profiler is not None:
        obs_profile.disable()
        print(f"[serve/cnn] kernel profile (fenced wall time a wrapper "
              f"call, {args.precision}):")
        print(obs_profile.format_aggregates(profiler))
        from repro_torch.plan import GpuProfile, get_profile
        from repro_torch.plan.drift import (drift_rows, format_drift,
                                            write_drift)
        profile = get_profile(args.device_profile)
        card = isinstance(profile, GpuProfile)
        print(f"[serve/cnn] cost-model drift ({profile.name}, "
              f"{args.precision}; "
              + ("launches the profiler missed measured on the card):"
                 if card else "the profiler's times):"))
        # at the served launch shapes: max_batch rows, top-K seeds
        rows = drift_rows(cfg, eng.plan, device=profile,
                          precision=args.precision, batch=args.batch,
                          seeds=args.topk, profiler=profiler, measure=card)
        print(format_drift(rows))
        print(f"[serve/cnn] drift table -> "
              f"{write_drift(rows, args.drift_out)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm", choices=["lm", "cnn"])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="lm workload: the SMOKE config of this arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--topk", type=int, default=3)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    # heavy-traffic hardening knobs; setting either of the first two
    # enables admission control on the server
    ap.add_argument("--capacity", type=int, default=None,
                    help="bounded admission queue: requests beyond this "
                         "many pending are shed with a typed error")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget; infeasible or "
                         "expired requests are shed, never silently late")
    ap.add_argument("--degrade-pressure", type=float, default=None,
                    help="queue occupancy in (0,1] above which explains "
                         "degrade (topk->argmax; f32 reroutes to the int16 "
                         "sibling) instead of shedding")
    # method lists derive from the registry: a newly registered explainer
    # is immediately servable without touching this file.
    ap.add_argument("--method", default="saliency", choices=registry.names())
    ap.add_argument("--perturb-samples", type=int, default=None,
                    help="cnn workload: mask fan-out N of the "
                         "perturbation explainers lime / rise, folded into "
                         "one forward of N x batch rows")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "fxp16"],
                    help="cnn workload numeric path; fxp16 = true int16 "
                         "fixed-point kernels (paper §IV)")
    ap.add_argument("--torch-device", default=None,
                    help="where the model runs: 'cuda' (the default: the "
                         "card, an error without one) or 'cpu'")
    from repro_torch.plan import profile_names
    ap.add_argument("--device-profile", default=None,
                    help="plan the kernels (cnn: conv / FC; lm: the scan) "
                         "for this repro_torch.plan profile before anything "
                         f"runs: one of {profile_names()} (h100: the "
                         "card's launch objects; the others: audits) or "
                         "'mesh:<profile>:<n>' for a mesh-sharded engine "
                         "whose batcher fills n x batch seats a launch")
    ap.add_argument("--autotune", action="store_true",
                    help="refine the tile plan by measured kernel times "
                         "(persisted in the repro_torch.plan tuning cache)")
    # observability: opt-in; the server runs on no-op singletons otherwise
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace-event "
                         "JSON of every request's admission -> queued -> "
                         "engine -> cache spans")
    ap.add_argument("--metrics", action="store_true",
                    help="print the unified repro_torch.obs metrics "
                         "snapshot")
    ap.add_argument("--profile-kernels", action="store_true",
                    help="cnn workload: time every kernel wrapper call "
                         "(fenced), print the aggregates per family, shape "
                         "and precision and the cost-model drift table")
    ap.add_argument("--drift-out", default=None, metavar="PATH",
                    help="where --profile-kernels writes the drift table "
                         "(default: next to the tuning cache)")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        if args.method not in registry.token_methods():
            raise SystemExit(
                f"--workload lm supports token-capable methods "
                f"{registry.token_methods()}; got {args.method!r}")
        if args.precision == "fxp16":
            raise SystemExit("--workload lm has no int16 fixed-point path "
                             "(token attribution needs float gradients)")
        run_lm(args)
    else:
        run_cnn(args)


if __name__ == "__main__":
    main()
