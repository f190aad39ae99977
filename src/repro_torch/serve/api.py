"""Request/response types and typed errors of the explanation-serving
subsystem, as ``repro.serve.api`` has them; a request's ``key`` is an int
seed here (a JAX PRNG key has no torch counterpart).

A request carries ONE example (no batch dimension) — the micro-batcher
(:mod:`repro_torch.serve.batcher`) stacks compatible requests into padded batches
so heterogeneous traffic shares kernel launches.  Two kinds:

  * ``predict`` — run the forward pass, return logits, and (on adapters that
    expose them) park the bit-packed ReLU/pool residuals in the
    :mod:`repro_torch.serve.residual_cache` under the request id.
  * ``explain`` — return a relevance map.  If a predict for the same ``uid``
    already populated the cache and the method is a pure-BP one, the forward
    pass is SKIPPED and the stored masks drive the fused seed-batched
    backward — the serving-time realization of the paper's compute-block
    reuse (§III.F).

Error surface (heavy-traffic hardening)
---------------------------------------
Under overload the server makes latency promises instead of queueing
unboundedly; the promise machinery speaks these types:

  * :class:`ShedError` — raised by ``ExplanationServer.submit`` when the
    admission layer REFUSES a request: the queue is at capacity
    (``reason="queue_full"``), the per-method token bucket is empty
    (``reason="rate_limit"``), or the deadline cannot be met given the
    current queue estimate (``reason="deadline"``).  A shed is a fast,
    deterministic "no" — the caller can retry, degrade, or fail over;
    nothing is silently dropped and nothing stalls.
  * A request that was ADMITTED but whose deadline expires while queued is
    not raised — it completes as a structured :class:`Response` with
    ``error_type="ShedError"`` and ``error="deadline expired in queue"``
    (the submit call has long returned).
  * :class:`InvalidRequestError` — a poisoned request rejected at submit
    time (non-finite input values, wrong example rank/shape when the
    adapter declares one).  A ``ValueError`` subclass, so legacy callers
    catching ``ValueError`` keep working.
  * Dispatch failures (an adapter/program raising mid-batch) never kill the
    worker loop: every request of the failing micro-batch completes as a
    ``Response`` with ``error_type`` set to the exception class name and
    ``error`` to its message; sibling buckets are unaffected.

Degradation is not an error: under sustained pressure the admission layer
may downgrade a top-K panel request to its argmax class or reroute float
traffic to the quantized ``fxp16`` engine (fidelity ≥0.988 Spearman,
certified by ``core/fidelity.py``); such responses carry
``meta["degraded"]`` describing what was traded away.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

PREDICT = "predict"
EXPLAIN = "explain"

#: :class:`ShedError` reasons.
SHED_QUEUE_FULL = "queue_full"
SHED_RATE_LIMIT = "rate_limit"
SHED_DEADLINE = "deadline"
SHED_EXPIRED = "expired"        # admitted, then deadline-expired in queue


class ServeError(Exception):
    """Base of every typed serving error."""


class ShedError(ServeError):
    """The admission layer refused (or gave up on) a request.

    Attributes: ``uid`` (the refused request), ``reason`` (one of
    ``queue_full | rate_limit | deadline | expired``), ``detail`` (a
    human-readable explanation with the numbers that drove the decision).
    """

    def __init__(self, uid: str, reason: str, detail: str = ""):
        self.uid = uid
        self.reason = reason
        self.detail = detail
        super().__init__(f"shed {uid!r} ({reason}): {detail}")


class InvalidRequestError(ServeError, ValueError):
    """A malformed request rejected before admission (bad shape, non-finite
    values, ...) — a ``ValueError`` so pre-hardening callers still catch it."""


@dataclass
class Request:
    uid: str
    kind: str                       # PREDICT | EXPLAIN
    x: Any                          # single example, e.g. [H, W, C] image
    method: str = "saliency"        # registry name (EXPLAIN only)
    target: Optional[int] = None    # class to explain; None = argmax
    topk: Optional[int] = None      # K-class panel instead of one target
    # Stochastic methods: an int seed.  Each request's draw comes from its
    # own ``torch.Generator`` seeded with it, made at dispatch on the
    # engine's device; a seed is hashable and replayable, where a generator
    # is consumed by its draw.
    key: Optional[int] = None
    # Arrival time: None until the batcher stamps it on submit.  Replay
    # drivers pre-stamp true arrivals; None (not 0.0) is the sentinel so a
    # VirtualClock trace starting at t=0.0 is never re-stamped.
    arrive_t: Optional[float] = None
    # Monotonic stochastic-singleton bucket token, minted lazily by
    # ``batcher.bucket_key`` (id(req) is GC-reusable and would collide).
    batch_token: Optional[int] = None
    deadline_s: Optional[float] = None  # latency budget from submit (SLO)
    deadline_t: Optional[float] = None  # absolute deadline (admission-stamped)
    degraded: bool = False          # serve via the degraded sibling engine
    degrade_action: Optional[str] = None  # what admission traded away
    trace: Any = None               # obs RequestTrace (server-stamped)

    def __post_init__(self):
        if self.kind not in (PREDICT, EXPLAIN):
            raise ValueError(f"unknown request kind {self.kind!r}")
        if self.kind == PREDICT and self.topk is not None:
            raise ValueError("topk is an explain-request field")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")


@dataclass
class Response:
    uid: str
    kind: str
    logits: Any = None              # [C] for the request's example
    relevance: Any = None           # input-shaped map, or [K, ...] panel
    targets: Optional[Tuple[int, ...]] = None  # class(es) actually explained
    method: Optional[str] = None
    cache_hit: bool = False         # explain served from stored residuals
    batch_size: int = 0             # physical batch the request rode in
    latency_s: float = 0.0          # submit -> completion (batcher clock)
    error: Optional[str] = None     # failure/shed detail (None = success)
    error_type: Optional[str] = None  # exception class name, e.g. "ShedError"
    meta: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.error_type is None


def shed_response(req: Request, reason: str, detail: str = "") -> Response:
    """Structured response for a request dropped AFTER admission (the
    in-queue expiry path) — same shape as a dispatch result, never raised."""
    return Response(uid=req.uid, kind=req.kind,
                    method=req.method if req.kind == EXPLAIN else None,
                    error=detail or reason, error_type="ShedError",
                    meta={"shed_reason": reason})
