"""Admission control: bounded queueing, deadline-aware shedding, rate
limits, and graceful degradation for
:class:`~repro_torch.serve.server.ExplanationServer`.

The engine stack under this layer makes latency *possible*; this layer makes
it a *promise*.  Following the latency-budgeted-pipeline framing of the XAI
acceleration literature (Pan & Mishra; ApproXAI treats accuracy-vs-latency
as a runtime policy knob), every decision is made at ADMISSION time, in O(1),
from host-side accounting only — no device tensors, no model calls:

  1. **token bucket per method** — a sustained-rate + burst contract per
     ``kind/method`` class, so one chatty method cannot starve the rest;
  2. **bounded queue** — ``pending >= capacity`` is an immediate
     ``queue_full`` shed, never an unbounded backlog;
  3. **deadline feasibility** — the expected completion time
     (``now + queued * per_request_estimate + service_estimate``) is checked
     against the request's absolute deadline; a request that cannot make it
     is shed NOW (``reason="deadline"``), when the caller can still react,
     rather than timed out after burning a queue slot;
  4. **degradation pressure** — above a queue-occupancy threshold the
     policy may downgrade top-K panels to argmax and reroute float traffic
     to the quantized ``fxp16`` engine instead of shedding outright
     (fidelity ≥0.988 Spearman per ``core/fidelity.py``).

Service-time estimates come from an EWMA over *observed* dispatch times per
``kind/method`` class (:class:`ServiceEstimator`), seeded with a
configurable prior so the very first requests are not blind.  The clock is
always injected by the server, so simulations and tests drive every decision
deterministically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

from repro_torch.obs import metrics as obsm
from repro_torch.serve.api import (EXPLAIN, SHED_DEADLINE, SHED_QUEUE_FULL,
                             SHED_RATE_LIMIT, Request, ShedError)


@dataclass(frozen=True)
class RateLimit:
    """Token bucket contract: ``rate`` sustained requests/s, ``burst`` depth."""

    rate: float
    burst: float

    def __post_init__(self):
        if self.rate <= 0 or self.burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, got {self}")


class TokenBucket:
    """Classic token bucket; refilled lazily from the injected clock."""

    def __init__(self, limit: RateLimit, now: float = 0.0):
        self.limit = limit
        self.tokens = float(limit.burst)
        self._last = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.limit.burst,
                          self.tokens + (now - self._last) * self.limit.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class ServiceEstimator:
    """EWMA per-request service time per ``kind/method`` class.

    The server observes ``(class, batch_duration, live_rows)`` after every
    dispatched micro-batch; the per-request cost is the amortized
    ``duration / live``.  ``prior_s`` seeds every class so admission is
    never blind before the first observation.
    """

    def __init__(self, prior_s: float = 1e-3, alpha: float = 0.2):
        self.prior_s = prior_s
        self.alpha = alpha
        self._est: Dict[str, float] = {}

    @staticmethod
    def key(kind: str, method: str = "") -> str:
        return f"{kind}/{method}" if method else kind

    def observe(self, kind: str, method: str, duration_s: float,
                live: int) -> None:
        per_req = duration_s / max(live, 1)
        k = self.key(kind, method)
        prev = self._est.get(k)
        self._est[k] = (per_req if prev is None
                        else (1 - self.alpha) * prev + self.alpha * per_req)
        obsm.SERVE_SERVICE_EST.set(self._est[k], cls=k)

    def estimate(self, kind: str, method: str = "") -> float:
        return self._est.get(self.key(kind, method), self.prior_s)

    def snapshot(self) -> Dict[str, float]:
        return dict(self._est)


@dataclass(frozen=True)
class DegradePolicy:
    """What to trade away under sustained pressure, instead of shedding.

    ``pressure`` is queue occupancy (``pending / capacity``); at or above
    the threshold, explain requests are downgraded: ``topk_to_argmax``
    collapses a K-panel to the single predicted class (K× less seed-batched
    BP work), and ``reroute_precision`` (e.g. ``"fxp16"``) reroutes the
    request to a cheaper sibling engine of that precision — served cold
    (stored float residuals cannot replay an int16 backward), heatmap
    fidelity certified by ``core/fidelity.py``.  Degraded responses carry
    ``meta["degraded"]``.
    """

    pressure_threshold: float = 0.75
    topk_to_argmax: bool = True
    reroute_precision: Optional[str] = None

    def __post_init__(self):
        if not 0.0 < self.pressure_threshold <= 1.0:
            raise ValueError("pressure_threshold must be in (0, 1]")


@dataclass(frozen=True)
class AdmissionConfig:
    """The admission layer's knobs (see module docstring for semantics).

    ``capacity`` bounds total queued requests; ``default_deadline_s``
    stamps a deadline on requests that carry none (None = admitted
    requests without a deadline never expire); ``rate_limits`` maps
    ``kind/method`` class names (``"predict"``, ``"explain/saliency"``,
    ...) to :class:`RateLimit` token buckets; ``service_prior_s`` seeds
    the :class:`ServiceEstimator`; ``reject_nonfinite`` refuses NaN/Inf
    example payloads at submit (:class:`InvalidRequestError`).
    """

    capacity: int = 1024
    default_deadline_s: Optional[float] = None
    rate_limits: Mapping[str, RateLimit] = field(default_factory=dict)
    degrade: Optional[DegradePolicy] = None
    service_prior_s: float = 1e-3
    reject_nonfinite: bool = True

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


class AdmissionController:
    """Stateful admission decisions over one server's queue.

    ``admit(req, pending, now)`` either stamps the request (deadline,
    degradation) and returns the degrade action taken (``None`` |
    ``"topk_to_argmax"`` | ``"reroute_precision"``), or raises
    :class:`~repro_torch.serve.api.ShedError`.  The caller (the server) owns
    stats accounting and the actual enqueue.
    """

    def __init__(self, config: AdmissionConfig, now: float = 0.0):
        self.config = config
        self.estimator = ServiceEstimator(prior_s=config.service_prior_s)
        self._buckets: Dict[str, TokenBucket] = {
            cls: TokenBucket(lim, now)
            for cls, lim in config.rate_limits.items()}

    # -- the decision --------------------------------------------------------

    def admit(self, req: Request, pending: int, now: float) -> Optional[str]:
        cfg = self.config
        cls = ServiceEstimator.key(
            req.kind, req.method if req.kind == EXPLAIN else "")

        bucket = self._buckets.get(cls)
        if bucket is not None and not bucket.try_take(now):
            raise ShedError(req.uid, SHED_RATE_LIMIT,
                            f"{cls} over {bucket.limit.rate:g} req/s "
                            f"(burst {bucket.limit.burst:g})")

        if pending >= cfg.capacity:
            raise ShedError(req.uid, SHED_QUEUE_FULL,
                            f"{pending} queued >= capacity {cfg.capacity}")

        deadline_s = (req.deadline_s if req.deadline_s is not None
                      else cfg.default_deadline_s)
        if deadline_s is not None:
            # Deadlines anchor at the TRUE arrival (replay drivers pre-stamp
            # arrive_t; is-None, not falsy — a t=0.0 replay arrival is real):
            # a request that reaches admission late — e.g. while the loop
            # serviced a burst — has already spent part of its budget, and
            # is shed deterministically if it spent all of it.
            req.deadline_t = ((now if req.arrive_t is None
                               else req.arrive_t) + deadline_s)
            eta = now + self.queue_wait_s(pending) + self.estimator.estimate(
                req.kind, req.method if req.kind == EXPLAIN else "")
            if eta > req.deadline_t:
                raise ShedError(
                    req.uid, SHED_DEADLINE,
                    f"eta +{eta - now:.4f}s > deadline +{deadline_s:.4f}s "
                    f"with {pending} queued")

        return self._maybe_degrade(req, pending)

    def queue_wait_s(self, pending: int) -> float:
        """Expected drain time of the current queue (serial dispatch)."""
        if not pending:
            return 0.0
        ests = self.estimator.snapshot()
        per_req = (sum(ests.values()) / len(ests) if ests
                   else self.config.service_prior_s)
        return pending * per_req

    def _maybe_degrade(self, req: Request, pending: int) -> Optional[str]:
        pol = self.config.degrade
        if pol is None or req.kind != EXPLAIN:
            return None
        if pending / self.config.capacity < pol.pressure_threshold:
            return None
        if pol.topk_to_argmax and req.topk is not None:
            # collapse the K-panel; the request still rides the primary
            # engine (and its residual cache), just with one seed.
            req.topk = None
            req.degrade_action = "topk_to_argmax"
            return "topk_to_argmax"
        if pol.reroute_precision is not None:
            # ``degraded`` reroutes dispatch to the cheaper sibling engine
            # AND buckets the request separately (incompatible programs).
            req.degraded = True
            req.degrade_action = "reroute_precision"
            return "reroute_precision"
        return None
