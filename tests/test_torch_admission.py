"""repro_torch.serve's admission layer and load-replay harness against
repro.serve's, on the replay harness's stub model (``SimAdapter``) under a
virtual clock: every decision is host-side arithmetic, so the two packages
must agree exactly.

* the controls — token bucket, rate limits, the service estimator, the
  admission decision (queue full, rate limit, deadline), EDF order in a
  bucket, the urgent early pop, expiry without a padded seat, top-K
  collapse, the precision reroute, dispatch timeouts — give the same
  outcomes, shed details and stats snapshots;
* ``synthesize``: poisson and bursty traces with an LM mix equal event for
  event (both draw from ``np.random.RandomState``);
* 5,000-event poisson and bursty replays with admission and degradation
  give the same ``ReplayReport.snapshot()``, field for field: every shed
  and degrade decision, the latency percentiles, the hit rate and the
  occupancy.

Responses are compared field by field; the stub's relevance (a float32
matmul, NumPy's in the reference and torch's here) within 1e-6 of max.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serve as jserve
from repro.serve import api as japi
from repro.serve import batcher as jbatcher
from repro.serve import replay as jreplay
import repro_torch.serve as tserve
from repro_torch.serve import api as tapi
from repro_torch.serve import batcher as tbatcher
from repro_torch.serve import replay as treplay

PKGS = {
    "ref": SimpleNamespace(serve=jserve, api=japi, batcher=jbatcher,
                           replay=jreplay),
    "port": SimpleNamespace(serve=tserve, api=tapi, batcher=tbatcher,
                            replay=treplay),
}
X = np.zeros((8, 8, 1), np.float32)


def both(program):
    """Run ``program(pkg)`` on each package -> (ref result, port result)."""
    return program(PKGS["ref"]), program(PKGS["port"])


def sim_server(p, clock=None, *, admission=None, **kw):
    clock = clock or p.replay.VirtualClock()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.0)
    return p.serve.ExplanationServer(p.replay.SimAdapter(clock), clock=clock,
                                     admission=admission, **kw)


def req(p, uid, kind="predict", x=X, **kw):
    return p.serve.Request(uid=uid, kind=kind, x=x, **kw)


def summary(resp):
    """A response as plain values (relevance separately)."""
    return dict(uid=resp.uid, kind=resp.kind, ok=resp.ok,
                error_type=resp.error_type, error=resp.error,
                targets=resp.targets, method=resp.method,
                cache_hit=resp.cache_hit, batch_size=resp.batch_size,
                latency_s=resp.latency_s, meta=dict(resp.meta))


def relevance(resp):
    r = resp.relevance
    if r is None:
        return None
    return np.asarray(r.numpy() if hasattr(r, "numpy") else r, np.float64)


def assert_same_responses(want, got):
    assert [summary(r) for r in got] == [summary(r) for r in want]
    for a, b in zip(want, got):
        ra, rb = relevance(a), relevance(b)
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert ra.shape == rb.shape
            assert np.abs(ra - rb).max() <= 1e-6 * max(np.abs(ra).max(),
                                                       1e-30)


def outcome(fn):
    """``fn()``'s value, or the type, reason and text of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:                              # noqa: BLE001
        return ("raised", type(e).__name__, getattr(e, "reason", None),
                str(e))


# -- the primitives -----------------------------------------------------------


def test_token_bucket_matches_reference():
    def program(p):
        b = p.serve.TokenBucket(p.serve.RateLimit(rate=10.0, burst=3.0))
        out = [b.try_take(t) for t in (0.0, 0.0, 0.0, 0.0, 0.05, 0.1, 0.1,
                                       0.4, 0.4, 0.4, 0.4, 10.0)]
        return out, b.tokens
    want, got = both(program)
    assert got == want
    assert want[0][:4] == [True, True, True, False]


@pytest.mark.parametrize("rate,burst", [(0.0, 2.0), (-1.0, 2.0), (5.0, 0.5),
                                        (5.0, 1.0)])
def test_rate_limit_validation_matches_reference(rate, burst):
    want, got = both(lambda p: outcome(
        lambda: repr(p.serve.RateLimit(rate, burst)).split("(", 1)[1]))
    assert got[:2] == want[:2]


def test_service_estimator_matches_reference():
    def program(p):
        est = p.serve.ServiceEstimator(prior_s=2e-3, alpha=0.3)
        out = [est.estimate("predict"), est.estimate("explain", "guided")]
        for kind, method, dur, live in (
                ("predict", "", 0.004, 4), ("predict", "", 0.010, 3),
                ("explain", "guided", 0.02, 0), ("predict", "", 0.001, 8),
                ("explain", "saliency", 0.008, 2)):
            est.observe(kind, method, dur, live)
            out.append(est.estimate(kind, method))
        ctl = p.serve.AdmissionController(p.serve.AdmissionConfig(
            capacity=8, service_prior_s=5e-4))
        ctl.estimator = est
        return out, est.snapshot(), [ctl.queue_wait_s(n) for n in (0, 1, 7)]
    want, got = both(program)
    assert got == want


def test_admission_decisions_match_reference():
    """Rate limit before capacity before deadline; the deadline anchored at
    the true arrival; degradation only above the pressure threshold."""
    def program(p):
        ctl = p.serve.AdmissionController(p.serve.AdmissionConfig(
            capacity=4, default_deadline_s=0.05, service_prior_s=0.01,
            rate_limits={"explain/guided": p.serve.RateLimit(100.0, 2.0)},
            degrade=p.serve.DegradePolicy(pressure_threshold=0.5,
                                          reroute_precision="fxp16")))
        out = []
        cases = [
            (dict(kind="predict"), 0, 0.0),
            (dict(kind="explain", method="guided"), 1, 0.0),
            (dict(kind="explain", method="guided"), 1, 0.0),
            (dict(kind="explain", method="guided"), 1, 0.0),    # rate limit
            (dict(kind="explain", method="guided"), 1, 0.02),   # refilled
            (dict(kind="predict"), 4, 0.03),                    # queue full
            (dict(kind="explain", method="saliency", topk=3), 2, 0.03),
            (dict(kind="explain", method="saliency"), 2, 0.03),  # reroute
            (dict(kind="explain", method="saliency"), 1, 0.03),  # calm
            (dict(kind="predict", deadline_s=0.001), 0, 0.04),  # infeasible
            (dict(kind="predict", arrive_t=0.0), 0, 0.06),      # spent
            (dict(kind="explain", method="saliency", arrive_t=0.0,
                  deadline_s=1.0), 3, 0.06),
        ]
        for i, (kw, pending, now) in enumerate(cases):
            arrive = kw.pop("arrive_t", None)
            r = req(p, f"r{i}", **kw)
            r.arrive_t = arrive
            res = outcome(lambda: ctl.admit(r, pending, now))
            out.append((res, r.deadline_t, r.topk, r.degraded,
                        r.degrade_action))
        return out
    want, got = both(program)
    assert got == want
    reasons = {o[0][2] for o in want if o[0][0] == "raised"}
    assert reasons == {"rate_limit", "queue_full", "deadline"}


def test_edf_order_and_urgent_pop_match_reference():
    def program(p):
        clock = p.replay.VirtualClock()
        mb = p.batcher.MicroBatcher(max_batch=8, max_delay_s=10.0,
                                    clock=clock)
        for uid, dl in (("a", 3.0), ("c", None), ("b", 1.0), ("d", 2.0),
                        ("e", 1.0)):
            r = req(p, uid, deadline_s=1.0 if dl else None)
            r.deadline_t = dl
            mb.submit(r)
        order = [[r.uid for r in b.requests] for b in mb.flush()]
        urgent = p.batcher.MicroBatcher(max_batch=8, max_delay_s=60.0,
                                        clock=clock)
        r = req(p, "u", deadline_s=1.0)
        r.deadline_t = 0.010
        urgent.submit(r)
        pops = [[b.requests[0].uid for b in urgent.ready(now=t,
                                                         service_est_s=0.002)]
                for t in (0.0, 0.008, 0.009)]
        return order, pops
    want, got = both(program)
    assert got == want
    assert want[0] == [["b", "e", "d", "a", "c"]]


def test_expiry_without_a_padded_seat_matches_reference():
    def program(p):
        clock = p.replay.VirtualClock()
        srv = sim_server(p, clock, max_delay_s=0.0, max_batch=8,
                         admission=p.serve.AdmissionConfig(capacity=10))
        srv.submit(req(p, "dead", deadline_s=0.001))
        srv.submit(req(p, "x"))
        srv.submit(req(p, "y"))
        clock.advance(0.01)
        out = srv.poll()
        srv.submit(req(p, "late", deadline_s=0.01))
        srv.submit(req(p, "z", "explain", method="guided"))
        clock.advance(0.05)
        out += srv.poll() + srv.drain()
        return out, srv.stats.snapshot()
    (want, wsnap), (got, gsnap) = both(program)
    assert_same_responses(want, got)
    assert gsnap == wsnap
    assert {r.uid: r.batch_size for r in got}["x"] == 2


def test_topk_collapse_and_reroute_match_reference():
    def program(p):
        clock = p.replay.VirtualClock()
        srv = sim_server(p, clock, max_delay_s=60.0, max_batch=8,
                         admission=p.serve.AdmissionConfig(
                             capacity=4, degrade=p.serve.DegradePolicy(
                                 pressure_threshold=0.5,
                                 reroute_precision="fxp16")))
        srv.submit(req(p, "p0"))
        srv.drain()
        for uid, kw in (("p0", dict(topk=2)), ("q1", {}),
                        ("q2", dict(topk=3)), ("q3", {}), ("q4", {})):
            try:
                srv.submit(req(p, uid, "explain", method="saliency", **kw))
            except p.api.ShedError:
                pass
        out = srv.drain()
        return (out, srv.stats.snapshot(), srv.cache.stats.snapshot(),
                srv._degraded_adapter.precision, sorted(
                    u for u in ("p0", "q1", "q2", "q3", "q4")
                    if srv.cache.peek(u) is not None))
    want, got = both(program)
    assert_same_responses(want[0], got[0])
    assert got[1:] == want[1:]
    assert want[1]["degrades"] == {"topk_to_argmax": 1,
                                   "reroute_precision": 1}


def test_minority_method_and_timeouts_match_reference():
    def program(p):
        clock = p.replay.VirtualClock()
        srv = sim_server(p, clock, max_batch=4, max_delay_s=0.005,
                         dispatch_timeout_s=0.0006,
                         admission=p.serve.AdmissionConfig(capacity=1000))
        srv.submit(req(p, "minority", "explain", method="guided",
                       deadline_s=0.05))
        out = []
        for i in range(40):
            srv.submit(req(p, f"s{i}", "explain", method="saliency"))
            clock.advance(0.001)
            out += srv.poll()
        out += srv.drain()
        return out, srv.stats.snapshot()
    (want, wsnap), (got, gsnap) = both(program)
    assert_same_responses(want, got)
    assert gsnap == wsnap and wsnap["timeouts"] > 0


def test_nonfinite_and_reroute_without_sibling_match_reference():
    def program(p):
        srv = sim_server(p, admission=p.serve.AdmissionConfig(capacity=10))
        bad = np.full((8, 8, 1), np.nan, np.float32)
        res = [outcome(lambda: srv.submit(req(p, "a", x=bad)))[:2]]

        class Bare:
            store_rules = "saliency"
        res.append(outcome(lambda: p.serve.ExplanationServer(
            Bare(), admission=p.serve.AdmissionConfig(
                degrade=p.serve.DegradePolicy(
                    reroute_precision="fxp16"))))[:2])
        return res, srv.batcher.pending()
    want, got = both(program)
    assert got == want
    assert want[0][0] == ("raised", "InvalidRequestError")


# -- synthesize ---------------------------------------------------------------

LM_MIX_EXTRA = {("lm_explain", "token_ixg", None): 0.10,
                ("lm_explain", "token_contrastive", None): 0.05}


@pytest.mark.parametrize("arrivals", ["poisson", "bursty"])
def test_synthesize_with_an_lm_mix_equals_reference_event_for_event(
        arrivals):
    def program(p):
        mix = dict(p.replay.DEFAULT_MIX)
        mix.update(LM_MIX_EXTRA)
        trace = p.replay.synthesize(
            3000, rate=1800.0, arrivals=arrivals, seed=11, mix=mix,
            deadline_s={"predict": 0.05, "explain": 0.1,
                        "lm_explain": 0.2})
        return [dataclasses.astuple(ev) for ev in trace]
    want, got = both(program)
    assert got == want
    assert {ev[8] for ev in want} == {None, 8, 16, 32}     # seq_len
    assert any(ev[7] is not None for ev in want)           # key seeds
    fields = [f.name for f in dataclasses.fields(treplay.TraceEvent)]
    assert fields == ["t", "uid", "kind", "method", "topk", "x_id",
                      "deadline_s", "key_seed", "seq_len"]


# -- replays ------------------------------------------------------------------


def replay_snapshot(p, arrivals, capacity, deadline_s, rate):
    clock = p.replay.VirtualClock()
    srv = p.serve.ExplanationServer(
        p.replay.SimAdapter(clock), clock=clock, max_batch=8,
        max_delay_s=0.002,
        admission=p.serve.AdmissionConfig(
            capacity=capacity, default_deadline_s=deadline_s,
            rate_limits={"explain/guided": p.serve.RateLimit(400.0, 8.0)},
            degrade=p.serve.DegradePolicy(pressure_threshold=0.5,
                                          reroute_precision="fxp16")),
        method_opts={"integrated_gradients": {"steps": 4},
                     "smoothgrad": {"n": 4}})
    trace = p.replay.synthesize(
        5000, rate=rate, arrivals=arrivals, seed=5,
        deadline_s={"predict": deadline_s / 2, "explain": deadline_s})
    return p.replay.replay(srv, trace).snapshot()


@pytest.mark.parametrize("arrivals,capacity,deadline_s,rate,reasons", [
    ("poisson", 32, 0.05, 2500.0, {"deadline", "expired", "rate_limit"}),
    ("bursty", 32, 0.05, 2500.0, {"deadline", "expired", "rate_limit"}),
    # the queue fills: every later arrival is shed at submit, and the
    # harness polls only after an admitted submit, so the queue holds
    # until the final drain (the reference's replay does the same)
    ("bursty", 16, 0.1, 2500.0, {"queue_full", "rate_limit"}),
])
def test_sim_replay_report_equals_reference_field_for_field(
        arrivals, capacity, deadline_s, rate, reasons):
    want, got = both(lambda p: replay_snapshot(p, arrivals, capacity,
                                               deadline_s, rate))
    assert got == want
    # the trace exercises the decisions the report counts
    assert want["offered"] == 5000 and want["errors"] == 0
    assert want["completed"] > 0
    assert set(want["sheds_by_reason"]) == reasons
    if arrivals == "bursty":
        assert want["degrades"]["reroute_precision"] > 0
        assert want["degrades"]["topk_to_argmax"] > 0
    if capacity == 32:
        assert 0 < want["cache_hit_rate"] < 1
        assert want["explain_p99_us"] > want["explain_p50_us"] > 0
