"""Load-replay SLO harness: synthesize traffic, drive the server, measure.

The hardening claims of :mod:`repro_torch.serve.admission` (bounded queues,
deterministic shedding, deadline envelopes) are only claims until a trace
of O(100k) mixed requests has been driven through the real dispatch loop.
This module supplies the three pieces:

  * :func:`synthesize` — deterministic traces of mixed predict/explain
    traffic: Poisson or bursty (on/off modulated Poisson) arrivals, a
    configurable method mix (pure-BP, top-K panels, composites,
    stochastic), explain-after-predict pairs that exercise the residual
    cache, and per-kind deadline envelopes;
  * :class:`VirtualClock` + :class:`SimAdapter` / :class:`TimedAdapter` —
    the server's clock is injectable, so a replay advances *virtual* time:
    ``SimAdapter`` stubs the model with a deterministic cost model (100k
    requests replay in seconds, queueing dynamics exact), ``TimedAdapter``
    wraps a real adapter and advances the clock by measured wall time,
    each program fenced by ``torch.cuda.synchronize`` (honest end-to-end
    numbers at smaller scale);
  * :func:`replay` — the driver: submits each event at its arrival time,
    polls between arrivals, drains at the end, and folds everything into a
    :class:`ReplayReport` (p50/p99 per kind, shed rate by reason,
    cache-hit rate, batch occupancy), JSON-ready.

Everything is seeded and virtual-clocked: the same (trace, adapter, server
config) triple replays to the same report, so SLO regressions are real
regressions, not sampling noise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.clock import VirtualClock, perf as perf_counter
from repro_torch.serve import registry
from repro_torch.serve.adapters import block_until_ready
from repro_torch.serve.api import EXPLAIN, PREDICT, Request, ShedError
from repro_torch.serve.stats import percentile

__all__ = [
    "DEFAULT_MIX", "LM_EXPLAIN", "LM_SEQ_LENS", "TraceEvent", "synthesize",
    "VirtualClock", "CostModel", "SimAdapter", "TimedAdapter", "ReplayReport",
    "replay",
]

# default (kind, method, topk) mix: weights need not sum to 1
DEFAULT_MIX: Dict[Tuple[str, str, Optional[int]], float] = {
    (PREDICT, "", None): 0.35,
    (EXPLAIN, "saliency", None): 0.25,
    (EXPLAIN, "guided", None): 0.12,
    (EXPLAIN, "deconvnet", None): 0.08,
    (EXPLAIN, "saliency", 5): 0.10,          # top-5 panels
    (EXPLAIN, "integrated_gradients", None): 0.07,
    (EXPLAIN, "smoothgrad", None): 0.03,
}

#: Trace-level request kind for token-level LM attribution.  The server
#: only knows PREDICT | EXPLAIN; an ``lm_explain`` mix entry synthesizes an
#: EXPLAIN event whose payload is a TOKEN SEQUENCE — ``seq_len`` drawn from
#: a pow2 bucket distribution instead of a fixed image shape — routed to
#: the LM server of a mixed CNN+LM replay (see :func:`replay`'s
#: ``lm_server``).
LM_EXPLAIN = "lm_explain"

#: Default pow2 sequence-length buckets for ``lm_explain`` traffic —
#: matches :func:`repro_torch.lm.adapter.bucket_len`'s grid so every
#: synthetic length is already a batcher bucket.
LM_SEQ_LENS: Tuple[int, ...] = (8, 16, 32)


@dataclass(frozen=True)
class TraceEvent:
    """One arrival of the synthetic trace (payload generated at replay)."""
    t: float                        # arrival time (virtual seconds)
    uid: str
    kind: str                       # PREDICT | EXPLAIN
    method: str = "saliency"
    topk: Optional[int] = None
    x_id: int = 0                   # index into the replay's example pool
    deadline_s: Optional[float] = None
    key_seed: Optional[int] = None  # seed of a stochastic method's draw
    seq_len: Optional[int] = None   # token-sequence length (LM traffic)


def synthesize(n: int, *, rate: float = 2000.0, arrivals: str = "poisson",
               seed: int = 0,
               mix: Optional[Dict[Tuple[str, str, Optional[int]], float]] = None,
               deadline_s: Optional[Dict[str, float]] = None,
               follow_predict_frac: float = 0.5,
               burst_factor: float = 8.0, burst_len_s: float = 0.05,
               idle_len_s: float = 0.2,
               x_pool: int = 64,
               lm_seq_lens: Tuple[int, ...] = LM_SEQ_LENS) -> List[TraceEvent]:
    """Deterministic trace of ``n`` arrivals at mean ``rate`` req/s.

    ``arrivals="poisson"`` draws exponential inter-arrival gaps;
    ``"bursty"`` modulates them with an on/off cycle (``burst_len_s`` at
    ``burst_factor *`` rate, then ``idle_len_s`` at 0.1x) whose MEAN rate is
    normalized back to ``rate`` — same offered load, spikier shape.
    ``follow_predict_frac`` of explain events reuse the uid of an earlier
    predict (residual-cache hit traffic); ``deadline_s`` maps kind ->
    latency budget (default: none).  Same seed, same trace.

    Mix entries may use the :data:`LM_EXPLAIN` kind (token-level LM
    attribution, e.g. ``(LM_EXPLAIN, "token_saliency", None)``): those
    synthesize EXPLAIN events with ``seq_len`` drawn uniformly from the
    ``lm_seq_lens`` pow2 buckets — a sequence-length distribution instead
    of an image shape.  LM explains never alias predict uids (token
    explainers are mask_reuse=False: there is no residual to hit) and take
    their deadline from ``deadline_s["lm_explain"]``, falling back to the
    plain explain envelope.
    """
    if arrivals not in ("poisson", "bursty"):
        raise ValueError(f"arrivals must be poisson|bursty, got {arrivals!r}")
    rng = np.random.RandomState(seed)
    mix = mix or DEFAULT_MIX
    classes = list(mix)
    weights = np.asarray([mix[c] for c in classes], float)
    weights /= weights.sum()
    deadline_s = deadline_s or {}

    if arrivals == "bursty":
        # normalize the on/off cycle so the long-run mean rate stays `rate`
        cycle = burst_len_s + idle_len_s
        mean_factor = (burst_factor * burst_len_s + 0.1 * idle_len_s) / cycle
        burst_rate = rate * burst_factor / mean_factor
        idle_rate = rate * 0.1 / mean_factor

    events: List[TraceEvent] = []
    predict_uids: List[str] = []
    t = 0.0
    for i in range(n):
        if arrivals == "poisson":
            t += rng.exponential(1.0 / rate)
        else:
            phase = t % (burst_len_s + idle_len_s)
            t += rng.exponential(
                1.0 / (burst_rate if phase < burst_len_s else idle_rate))
        kind, method, topk = classes[rng.choice(len(classes), p=weights)]
        uid = f"r{i}"
        seq_len = None
        if kind == LM_EXPLAIN:
            kind = EXPLAIN
            seq_len = int(lm_seq_lens[rng.randint(len(lm_seq_lens))])
            dl = deadline_s.get(LM_EXPLAIN, deadline_s.get(EXPLAIN))
        else:
            dl = deadline_s.get(kind)
        if kind == PREDICT:
            predict_uids.append(uid)
        elif (seq_len is None and predict_uids
                and rng.rand() < follow_predict_frac):
            # explain-after-predict traffic has temporal locality: draw
            # from the most recent predicts so the residual cache (an LRU)
            # sees realistic hit pressure rather than uniform history.
            lo = max(0, len(predict_uids) - 64)
            uid = predict_uids[rng.randint(lo, len(predict_uids))]
        events.append(TraceEvent(
            t=t, uid=uid, kind=kind, method=method, topk=topk,
            x_id=rng.randint(x_pool), deadline_s=dl,
            key_seed=(i if kind == EXPLAIN
                      and registry.get(method).needs_key else None),
            seq_len=seq_len))
    return events


# VirtualClock now lives in repro.obs.clock (imported above, re-exported
# here for existing callers): the obs layer owns the clock protocol so
# spans, deadlines, and stats always share one "now".


@dataclass(frozen=True)
class CostModel:
    """Modeled service times for :class:`SimAdapter` (virtual seconds).

    A dispatch costs ``launch_s`` (per-launch overhead) plus a
    per-row term: ``row_s`` per forward row, ``seed_row_s`` per (seed x
    row) of the BP phase.  ``scale`` derives the cheaper sibling used for
    the ``fxp16`` degradation reroute.

    ``n_shards > 1`` models a mesh-sharded engine: the batch axis splits
    across the mesh, so the per-row terms charge ``ceil(rows/n_shards)``
    rows — the slowest shard's slice — while ``launch_s`` stays whole
    (one sharded program launch, not N).  Mirrors how
    ``plan.shard_batch_seeds`` splits before per-core tiling.
    """

    launch_s: float = 200e-6
    row_s: float = 50e-6
    seed_row_s: float = 30e-6
    n_shards: int = 1

    def _rows(self, rows: int) -> int:
        return -(-rows // self.n_shards)        # slowest shard's slice

    def predict_s(self, rows: int) -> float:
        return self.launch_s + self._rows(rows) * self.row_s

    def replay_s(self, seeds: int, rows: int) -> float:
        return self.launch_s + seeds * self._rows(rows) * self.seed_row_s

    def scale(self, factor: float) -> "CostModel":
        return CostModel(self.launch_s * factor, self.row_s * factor,
                         self.seed_row_s * factor, self.n_shards)

    def sharded(self, n_shards: int) -> "CostModel":
        """The same per-core costs spread over an ``n_shards`` mesh."""
        return CostModel(self.launch_s, self.row_s, self.seed_row_s,
                         int(n_shards))


class SimAdapter:
    """Duck-typed serve adapter over a deterministic linear stub model.

    Real dataflow, modeled time: every server path (predict, cached BP
    replay, cold composite explainers, degradation reroute) runs with
    correct shapes and deterministic values, while the *cost* of each
    program advances the shared :class:`VirtualClock` per
    :class:`CostModel` — so a 100k-request replay resolves the queueing /
    shedding dynamics exactly without compiling or running kernels.

    The stub is ``logits = flatten(x) @ W`` (torch, on the CPU) with
    seeded ``W`` per input size (``np.random.RandomState``, the reference's
    draw); its true gradient is ``seed @ W^T``, so relevance maps are
    consistent across the hit and cold paths.  Composite explainers ride
    :meth:`model_fn`, whose closure advances the clock per call — IG at S
    steps pays S-fold row cost through its folded batch, mirroring the real
    engine's work, and autograd differentiates it.
    """

    input_kind = "image"
    store_rules = "saliency"
    num_classes = 4

    device = torch.device("cpu")

    def __init__(self, clock: VirtualClock, cost: Optional[CostModel] = None,
                 *, seed: int = 0, precision: str = "f32"):
        self.clock = clock
        self.cost = cost or CostModel()
        self.seed = seed
        self.precision = precision
        self._weights: Dict[int, torch.Tensor] = {}

    def _w(self, size: int) -> torch.Tensor:
        if size not in self._weights:
            rng = np.random.RandomState(self.seed + size)
            self._weights[size] = torch.from_numpy(
                rng.randn(size, self.num_classes).astype(np.float32))
        return self._weights[size]

    @property
    def n_shards(self) -> int:
        """Mesh extent of the modeled engine — the server reads this to
        size the batcher's ``fill_target`` (same duck-typed contract as
        ``CNNAdapter.n_shards``)."""
        return self.cost.n_shards

    def with_precision(self, precision: str) -> "SimAdapter":
        """Cheaper sibling for the degradation reroute (half-cost model,
        same weights/seed, shared clock)."""
        sib = SimAdapter(self.clock, self.cost.scale(0.5), seed=self.seed,
                         precision=precision)
        sib._weights = self._weights
        return sib

    # -- the three server-facing programs ------------------------------------

    def predict(self, xb):
        xb = torch.as_tensor(xb, dtype=torch.float32)
        rows = xb.shape[0]
        self.clock.advance(self.cost.predict_s(rows))
        flat = xb.reshape(rows, -1)
        return flat @ self._w(flat.shape[1]), {"x": xb}

    def explain_cached(self, method: str, residuals, seeds):
        xb = residuals["x"]
        seeds = torch.as_tensor(seeds, dtype=torch.float32)   # [S, B, C]
        s, b = seeds.shape[0], xb.shape[0]
        self.clock.advance(self.cost.replay_s(s, b))
        grad = seeds @ self._w(int(np.prod(xb.shape[1:]))).T   # [S, B, size]
        return grad.reshape(s, b, *xb.shape[1:])

    def model_fn(self, rules: str):
        """Rule-bound callable for cold composite explainers, differentiable
        (autograd is the engine); the clock advances per call with the
        folded batch's row cost (IG/smoothgrad fold steps/samples into
        rows)."""
        def f(xb):
            rows = int(xb.shape[0])
            self.clock.advance(self.cost.predict_s(rows)
                               + self.cost.replay_s(1, rows))
            flat = xb.reshape(rows, -1)
            return flat @ self._w(int(flat.shape[1]))
        return f

    def manual_backward(self, rules: str):
        return None                      # float path: autograd is the engine


class TimedAdapter:
    """Wrap a REAL adapter; advance the virtual clock by measured wall time.

    The replay then reports honest end-to-end service times for the real
    kernels while keeping arrivals on the virtual timeline: each program
    ends in ``torch.cuda.synchronize`` before the wall clock is read, so
    the clock advances by service time, not launch time.  Composite
    explainers ride the inner adapter's ``model_fn`` (not ``engine_for``)
    so their wall time is measured here too.
    """

    def __init__(self, inner, clock: VirtualClock):
        self.inner = inner
        self.clock = clock
        self.store_rules = inner.store_rules
        self.input_kind = getattr(inner, "input_kind", "image")

    @property
    def example_shape(self):
        return getattr(self.inner, "example_shape", None)

    @property
    def n_shards(self):
        return getattr(self.inner, "n_shards", 1)

    @property
    def device(self):
        return getattr(self.inner, "device", None)

    def _timed(self, fn, *args):
        t0 = perf_counter()
        out = block_until_ready(fn(*args))
        self.clock.advance(perf_counter() - t0)
        return out

    def predict(self, xb):
        return self._timed(self.inner.predict, xb)

    def explain_cached(self, method: str, residuals, seeds):
        return self._timed(self.inner.explain_cached, method, residuals,
                           seeds)

    def with_precision(self, precision: str) -> "TimedAdapter":
        return TimedAdapter(self.inner.with_precision(precision), self.clock)

    def model_fn(self, rules: str):
        f = self.inner.model_fn(rules)

        def timed_f(xb):
            t0 = perf_counter()
            out = block_until_ready(f(xb))
            self.clock.advance(perf_counter() - t0)
            return out
        return timed_f

    def manual_backward(self, rules: str):
        return self.inner.manual_backward(rules)

    def __getattr__(self, name):
        # TOKEN adapters (repro_torch.lm.LMAdapter) only: expose engine_for so
        # the server's registry token explainers ride a clock-advancing
        # engine wrapper.  Image adapters deliberately keep engine_for
        # hidden — composites must ride the timed model_fn closure above,
        # and exposing engine_for would reroute them around the timing.
        if (name == "engine_for" and self.input_kind == "tokens"
                and hasattr(self.inner, "engine_for")):
            def engine_for(rules: str) -> "_TimedLMEngine":
                return _TimedLMEngine(self.inner.engine_for(rules),
                                      self.clock)
            return engine_for
        raise AttributeError(name)


class _TimedLMEngine:
    """Engine facade for :class:`TimedAdapter` over an LM engine: the
    token-explain program's measured wall time advances the virtual clock
    (same contract as the image paths' timed closures)."""

    def __init__(self, eng, clock: VirtualClock):
        self._eng = eng
        self.clock = clock
        self.model_fn = eng.model_fn                # None for LM engines
        self.composite_backward = eng.composite_backward

    def explain_tokens(self, batch, *, mode: str = "ixg"):
        t0 = perf_counter()
        out = block_until_ready(self._eng.explain_tokens(batch, mode=mode))
        self.clock.advance(perf_counter() - t0)
        return out

    @property
    def device(self):
        return self._eng.device


@dataclass
class ReplayReport:
    """Everything the SLO gate needs, JSON-ready via :meth:`snapshot`."""

    offered: int = 0
    completed: int = 0
    errors: int = 0
    shed_submit: int = 0                  # refused by admission (raised)
    shed_queue: int = 0                   # admitted, expired while queued
    sheds_by_reason: Dict[str, int] = field(default_factory=dict)
    latencies_by_kind: Dict[str, List[float]] = field(default_factory=dict)
    deadline_misses: int = 0              # admitted+completed past deadline
    cache_hit_rate: float = 0.0
    mean_occupancy: float = 0.0
    peak_queue_depth: int = 0
    degrades: Dict[str, int] = field(default_factory=dict)
    makespan_s: float = 0.0

    @property
    def shed_total(self) -> int:
        return self.shed_submit + self.shed_queue

    @property
    def shed_rate(self) -> float:
        return self.shed_total / self.offered if self.offered else 0.0

    def p_us(self, kind: str, q: float) -> Optional[float]:
        """Latency percentile in us; ``None`` (JSON null, not NaN) when no
        request of ``kind`` completed."""
        lat = sorted(self.latencies_by_kind.get(kind, []))
        p = percentile(lat, q)
        return 1e6 * p if p is not None else None

    def snapshot(self) -> dict:
        out = {
            "offered": self.offered, "completed": self.completed,
            "errors": self.errors, "shed_total": self.shed_total,
            "shed_rate": self.shed_rate,
            "sheds_by_reason": dict(self.sheds_by_reason),
            "deadline_misses": self.deadline_misses,
            "cache_hit_rate": self.cache_hit_rate,
            "mean_occupancy": self.mean_occupancy,
            "peak_queue_depth": self.peak_queue_depth,
            "degrades": dict(self.degrades),
            "makespan_s": self.makespan_s,
        }
        for kind in sorted(self.latencies_by_kind):
            out[f"{kind}_p50_us"] = self.p_us(kind, 50)
            out[f"{kind}_p99_us"] = self.p_us(kind, 99)
        return out


def replay(server, trace: List[TraceEvent], *,
           example_shape: Tuple[int, ...] = (8, 8, 1),
           x_pool: int = 64, seed: int = 0,
           make_x: Optional[Callable[[TraceEvent], np.ndarray]] = None,
           lm_server=None, lm_vocab: int = 256) -> ReplayReport:
    """Drive ``server`` (whose clock must be a :class:`VirtualClock`)
    through ``trace``; returns the folded :class:`ReplayReport`.

    Each event advances the clock to its arrival time (service may have
    pushed time past it — arrivals never move time backwards), pre-stamps
    ``arrive_t`` with the TRUE arrival, submits, and polls.  Submit-time
    sheds are counted, never raised out.  Payloads come from a seeded pool
    of ``x_pool`` distinct examples unless ``make_x`` overrides.

    Mixed CNN+LM traffic: events with ``seq_len`` set (synthesized from
    :data:`LM_EXPLAIN` mix entries) carry seeded int32 token payloads —
    one pool of ``x_pool`` sequences PER length bucket, ids below
    ``lm_vocab`` — and are routed to ``lm_server`` (an
    :class:`~repro_torch.serve.server.ExplanationServer` on an LM adapter,
    typically :class:`TimedAdapter`-wrapped, sharing THIS replay's clock).
    Without an ``lm_server`` they fall through to ``server`` — a
    single-server LM replay when every event is LM, an error otherwise
    (the report's error count, not a crash: the server fault-isolates).
    Cache/occupancy fields always come from the primary ``server``; LM
    explains contribute latency percentiles and the shared queue-depth
    peak.
    """
    clock = server.clock
    if not isinstance(clock, VirtualClock):
        raise TypeError("replay needs a server built on a VirtualClock")
    if lm_server is not None and lm_server.clock is not clock:
        raise ValueError("lm_server must share the primary server's clock "
                         "(one virtual timeline)")
    rng = np.random.RandomState(seed)
    pool = rng.randn(x_pool, *example_shape).astype(np.float32)
    tok_pools: Dict[int, np.ndarray] = {}

    def _tokens(ev: TraceEvent) -> np.ndarray:
        s = int(ev.seq_len)
        if s not in tok_pools:
            r = np.random.RandomState(seed + 7919 * s)
            tok_pools[s] = r.randint(
                0, lm_vocab, size=(x_pool, s)).astype(np.int32)
        return tok_pools[s][ev.x_id % x_pool]

    rep = ReplayReport()
    deadlines: Dict[str, float] = {}
    t_start = clock()

    def account(resp):
        if resp.error_type == "ShedError":
            rep.shed_queue += 1
            reason = resp.meta.get("shed_reason", "expired")
            rep.sheds_by_reason[reason] = (
                rep.sheds_by_reason.get(reason, 0) + 1)
        elif not resp.ok:
            rep.errors += 1
        else:
            rep.completed += 1
            rep.latencies_by_kind.setdefault(resp.kind, []).append(
                resp.latency_s)
            dl = deadlines.get(resp.uid)
            if dl is not None and resp.latency_s > dl:
                rep.deadline_misses += 1

    servers = [server] if lm_server is None else [server, lm_server]
    for ev in trace:
        clock.t = max(clock.t, ev.t)
        rep.offered += 1
        if make_x is not None:
            x = make_x(ev)
        elif ev.seq_len is not None:
            x = _tokens(ev)
        else:
            x = pool[ev.x_id % x_pool]
        target = (lm_server if ev.seq_len is not None and lm_server is not None
                  else server)
        req = Request(
            uid=ev.uid, kind=ev.kind, x=x,
            method=ev.method, topk=ev.topk, deadline_s=ev.deadline_s,
            key=ev.key_seed)
        req.arrive_t = ev.t
        try:
            target.submit(req)
            if ev.deadline_s is not None:
                deadlines[ev.uid] = ev.deadline_s
        except ShedError as e:
            rep.shed_submit += 1
            rep.sheds_by_reason[e.reason] = (
                rep.sheds_by_reason.get(e.reason, 0) + 1)
            continue
        for srv in servers:
            for resp in srv.poll():
                account(resp)
    for srv in servers:
        for resp in srv.drain():
            account(resp)

    snap = server.stats.snapshot()
    cache = server.cache.stats
    lookups = cache.hits + cache.misses
    rep.cache_hit_rate = cache.hits / lookups if lookups else 0.0
    rep.mean_occupancy = snap["mean_occupancy"]
    rep.peak_queue_depth = snap["peak_queue_depth"]
    rep.degrades = snap["degrades"]
    if lm_server is not None:
        rep.peak_queue_depth = max(
            rep.peak_queue_depth,
            lm_server.stats.snapshot()["peak_queue_depth"])
    rep.makespan_s = clock() - t_start
    return rep
