"""repro_torch.obs against repro.obs: the metrics registry, the clock, the
strict-JSON helpers and request tracing.

The same sequence of operations runs through both packages' classes (fresh
registries and tracers, never the process-wide defaults): every value,
percentile, snapshot, Prometheus text and Chrome trace-event JSON must be
equal, and the default catalogs must name the same series.
"""
import json
import math

import numpy as np
import pytest

import repro.obs as jobs
from repro.obs import metrics as jmetrics
from repro.obs import registry as jregistry
from repro.obs import trace as jtrace
from repro.serve import ExplanationServer as JServer
from repro.serve.replay import SimAdapter as JSim
from repro.serve.replay import replay as jreplay
from repro.serve.replay import synthesize as jsynthesize
from repro_torch import obs
from repro_torch.obs import metrics
from repro_torch.obs import registry
from repro_torch.obs import trace
from repro_torch.serve import ExplanationServer
from repro_torch.serve.replay import SimAdapter, replay, synthesize

PKGS = {"ref": (jobs, jregistry, jtrace), "port": (obs, registry, trace)}


def metric_program(reg_mod):
    """Counter / gauge / histogram operations on a fresh registry, with an
    overflowing label set and values across every bucket."""
    reg = reg_mod.Registry(max_label_sets=3)
    c = reg.counter("reqs_total", "requests", ("kind", "method"))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", ("kind",))
    rng = np.random.RandomState(0)
    for i in range(200):
        c.inc(kind=("predict", "explain")[i % 2], method=f"m{i % 5}")
        g.set(float(i % 17))
        g.set_max(float(rng.randint(40)))
        h.observe(float(10.0 ** rng.uniform(-7, 2)),
                  kind=("predict", "explain", "x", "y")[i % 4])
    c.inc(0.5, kind="predict", method="m0")
    out = {
        "values": [c.value(kind="predict", method="m0"), c.total(),
                   g.value(), c.overflowed, h.overflowed],
        "snapshot": reg.snapshot(),
        "prometheus": reg.render_prometheus(),
    }
    try:
        reg.gauge("reqs_total")
    except ValueError as e:
        out["reregister"] = str(e)
    assert reg.counter("reqs_total", "requests", ("kind", "method")) is c
    reg.reset()
    out["after_reset"] = reg.snapshot()
    return out


def test_metric_program_matches_reference():
    want = metric_program(jregistry)
    got = metric_program(registry)
    assert got == want
    json.dumps(got["snapshot"], allow_nan=False)


@pytest.mark.parametrize("vals", [[], [3.0], [5.0, 1.0, 2.0, 4.0],
                                  list(np.random.RandomState(1).rand(101))])
@pytest.mark.parametrize("q", [0, 1, 50, 99, 100])
def test_percentile_of_matches_reference(vals, q):
    s = sorted(vals)
    assert registry.percentile_of(s, q) == jregistry.percentile_of(s, q)


def test_default_catalog_names_the_same_series():
    """The same instruments (name, kind, labels) on the default registry,
    seeded with the same zero series at import."""
    want, got = jmetrics._R, metrics._R
    assert sorted(got._instruments) == sorted(want._instruments)
    for name, inst in want._instruments.items():
        mine = got.get(name)
        assert (mine.kind, mine.labelnames) == (inst.kind, inst.labelnames)
    for name in ("serve_sheds_total", "serve_degrades_total",
                 "serve_residual_cache_events_total"):
        assert ([lbl for lbl, _ in got.get(name).series()][:4]
                == [lbl for lbl, _ in want.get(name).series()][:4])
    assert obs.default_registry() is got


@pytest.mark.parametrize("obj", [
    {"a": float("nan"), "b": [1.0, float("inf"), {"c": -float("inf")}]},
    [0.5, (1, float("nan")), "s", None],
    3.0,
])
def test_jsonsafe_matches_reference(obj):
    assert obs.sanitize(obj) == jobs.sanitize(obj)
    assert (obs.dumps_strict(obs.sanitize(obj))
            == jobs.dumps_strict(jobs.sanitize(obj)))
    if isinstance(obj, dict):
        with pytest.raises(ValueError):
            obs.dumps_strict(obj)


def test_virtual_clock_matches_reference():
    a, b = obs.VirtualClock(1.5), jobs.VirtualClock(1.5)
    for dt in (0.0, 0.25, 1e-9, 3.0):
        assert a.advance(dt) == b.advance(dt) and a() == b()
    with pytest.raises(ValueError):
        a.advance(-1e-9)
    assert obs.monotonic() <= obs.monotonic()
    assert obs.perf() <= obs.perf()


def span_program(obs_mod, trace_mod):
    """One span program under a virtual clock: nested children, an
    annotation, an idempotent end, a clamp, a dropped span, an open span
    closed by ``finish``."""
    clock = obs_mod.VirtualClock()
    tracer = obs_mod.Tracer(clock=clock, max_spans=7)
    root = tracer.start("request/explain", cat="request", trace_id="q0#0",
                        args={"uid": "q0", "method": "guided"})
    clock.advance(0.001)
    adm = root.child("admission", cat="admission")
    adm.end(result="admitted")
    adm.end(result="ignored")
    queued = root.child("queued", cat="queue")
    clock.advance(0.0025)
    queued.end()
    batch = tracer.start("batch/explain", cat="batch", trace_id="batch#1",
                         args={"n": 3, "degraded": False})
    eng = root.child("engine", cat="engine", args={"batch": "batch#1"})
    clock.advance(0.004)
    eng.annotate(rows=4).end()
    root.child("cache", cat="cache").end(t=clock() - 1.0, result="hit")
    batch.end()
    root.end(status="ok", cache_hit=True, latency_s=0.0075)
    tracer.start("left/open", trace_id="q1#2")
    dropped = tracer.start("dropped", trace_id="q2#3")
    clock.advance(0.5)
    tracer.finish()
    chrome = tracer.to_chrome()
    return {"chrome": chrome, "dropped": tracer.dropped,
            "null": dropped is trace_mod.NULL_SPAN,
            "integrity": trace_mod.integrity_errors(tracer.spans),
            "valid": trace_mod.validate_chrome(chrome),
            "invalid": trace_mod.validate_chrome({"traceEvents": [
                {"ph": "B", "name": "x", "pid": 1, "tid": 1},
                {"ph": "X", "name": "y", "pid": 1, "tid": 1, "ts": 0,
                 "dur": -1.0, "args": {"parent_id": 99}}]})}


def test_span_program_saves_the_reference_chrome_json(tmp_path):
    want = span_program(jobs, jtrace)
    got = span_program(obs, trace)
    assert got == want
    assert got["null"] and got["dropped"] == 1 and got["integrity"] == []
    # Tracer.save writes the same strict JSON text
    paths = {}
    for name, (obs_mod, _, _) in PKGS.items():
        tracer = obs_mod.Tracer(clock=obs_mod.VirtualClock())
        s = tracer.start("a", trace_id="t", args={"v": float("nan")})
        s.child("b").end(t=0.25)
        s.end(t=0.5)
        paths[name] = tmp_path / f"{name}.json"
        tracer.save(str(paths[name]))
    assert paths["port"].read_text() == paths["ref"].read_text()


def test_null_tracer_allocates_nothing():
    assert obs.NULL_TRACER.start("x") is obs.NULL_SPAN
    assert obs.NULL_SPAN.child("y") is obs.NULL_SPAN
    assert obs.NULL_SPAN.end(status="ok") is None
    t = obs.Tracer(enabled=False)
    assert t.start("x") is obs.NULL_SPAN and t.spans == []
    assert isinstance(obs.RequestTrace(obs.NULL_SPAN).engine,
                      type(obs.NULL_SPAN))


@pytest.mark.parametrize("arrivals", ["poisson", "bursty"])
def test_traced_replay_saves_the_reference_trace(arrivals):
    """A traced server over the replay harness's stub model: the same trace
    gives the same spans, event for event, in both packages."""
    chrome = {}
    for name, (obs_mod, server_cls, sim, synth, run) in {
            "ref": (jobs, JServer, JSim, jsynthesize, jreplay),
            "port": (obs, ExplanationServer, SimAdapter, synthesize,
                     replay)}.items():
        trace_ev = synth(300, rate=4000.0, arrivals=arrivals, seed=3)
        clock = obs_mod.VirtualClock()
        tracer = obs_mod.Tracer()
        server = server_cls(sim(clock), clock=clock, max_batch=8,
                            max_delay_s=0.001, tracer=tracer)
        run(server, trace_ev)
        tracer.finish()
        assert jtrace.integrity_errors(tracer.spans) == []
        chrome[name] = tracer.to_chrome()
    assert chrome["port"] == chrome["ref"]
    assert len(chrome["port"]["traceEvents"]) > 600
    assert not math.isnan(chrome["port"]["traceEvents"][-1]["ts"])
