"""Dynamic micro-batcher: coalesce pending requests into padded batches.

Traffic against an explanation server is heterogeneous — CNN heatmap
requests, LM token-score requests, top-K class panels, different methods —
and every kernel launch runs one shape under one rule set.  The batcher
therefore:

  * **buckets** requests by a compatibility key (kind, method, example
    shape/dtype, panel width K): everything in a bucket can ride one kernel
    launch with per-example targets;
  * **pads** the stacked batch dimension up to the next power of two
    (capped at ``max_batch``), so the kernels see a handful of distinct
    batch shapes instead of one per occupancy — padding rows are sliced
    off the results, keeping per-request outputs identical to unbatched
    serving;
  * **deadlines** each bucket: a bucket pops when it is full OR its oldest
    request has waited ``max_delay_s`` — the classic throughput/latency
    micro-batching trade;
  * **fills toward the mesh** when the serving engine is sharded
    (``n_shards > 1``): a sharded launch has ``max_batch * n_shards``
    seats (:attr:`MicroBatcher.fill_target`), so buckets pop at full mesh
    occupancy instead of starving N-1 shards with single-core batches.

Heavy-traffic hardening adds per-REQUEST deadlines on top of the per-BUCKET
delay cap:

  * within a bucket, requests are kept in **EDF order** (earliest absolute
    deadline first; deadline-less requests keep FIFO order at the back), so
    when a bucket pops partially, the most urgent requests ride first;
  * a bucket also pops **early** when its most urgent deadline would be
    blown by waiting any longer (``deadline - now <= service estimate``) —
    a padded, under-full launch beats a blown SLO;
  * :meth:`MicroBatcher.expire` sweeps out requests that can no longer make
    their deadline even if launched immediately, so a doomed request never
    occupies a seat in a padded launch (the server turns the sweepings into
    structured shed responses).

Stochastic methods (per-request seeds) co-batch when the explainer can
FOLD per-example seeds along the batch axis (``fold_keys`` — smoothgrad and
the perturbation family): the server passes each request's own seed, so the
draw is request-deterministic no matter which neighbours shared the batch.
Only stochastic methods *without* key folding fall back to singleton
buckets (a per-request ``batch_token`` in the bucket key).

The clock is injectable so tests and simulations drive deadlines
deterministically.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import clock as clock_lib
from repro_torch.serve import registry
from repro_torch.serve.api import EXPLAIN, Request

BucketKey = Tuple

_INF = float("inf")

#: Monotonic mint for the stochastic-singleton bucket token.  NOT ``id(req)``:
#: CPython reuses object ids after GC, so two distinct in-flight smoothgrad
#: requests could collide into one bucket and share a noise draw.
_BATCH_TOKENS = itertools.count(1)


def _singleton_token(req: Request) -> int:
    """The request's monotonic bucket token, minted on first use.

    Lazily minted (rather than at submit) so :func:`bucket_key` is total
    over un-submitted requests too; ``itertools.count.__next__`` is atomic
    under CPython, so concurrent minting never duplicates a token.
    """
    if req.batch_token is None:
        req.batch_token = next(_BATCH_TOKENS)
    return req.batch_token


def _dtype_name(x) -> str:
    """NumPy's dtype name, for arrays and tensors alike (``float32``, not
    ``torch.float32``), so a bucket key does not depend on the container."""
    dt = np.asarray(x).dtype if not hasattr(x, "dtype") else x.dtype
    return str(dt).removeprefix("torch.")


def bucket_key(req: Request) -> BucketKey:
    """Requests with equal keys may share one padded kernel launch."""
    shape = tuple(np.shape(req.x))
    dtype = _dtype_name(req.x)
    if req.kind != EXPLAIN:
        return (req.kind, shape, dtype)
    # target-kind keeps a bucket homogeneous: an all-None bucket resolves
    # argmax targets inside the engine, an all-explicit one passes them in.
    # Degraded (rerouted-precision) requests run on another engine and must
    # not coalesce with primary traffic.
    # Stochastic methods whose explainer folds per-example seeds co-batch
    # freely (each request rides its own seed); only non-foldable ones get a
    # per-REQUEST token (not uid: two in-flight requests for one uid carry
    # distinct seeds and must not coalesce).
    cls = registry.get(req.method)
    singleton = cls.needs_key and not cls.fold_keys
    return (req.kind, req.method, shape, dtype, req.topk,
            req.target is None, req.degraded,
            _singleton_token(req) if singleton else None)


def pad_size(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at ``max_batch``.

    The cap is unconditional — callers pop at most ``max_batch`` requests
    per launch, and the compiled programs are shaped for it; an ``n`` above
    the cap is clamped, never returned as a non-pow2 escape hatch.
    """
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


def slack_s(deadline_t: float, now: float, service_est_s: float) -> float:
    """Deadline slack if launched RIGHT NOW: ``deadline - (now + est)``.

    The one boundary :meth:`MicroBatcher.expire` and
    :meth:`MicroBatcher.ready` share: a request is DOOMED iff
    ``slack < 0`` (cannot meet its deadline even launched immediately) and
    URGENT iff ``slack <= 0`` (waiting any longer blows it).  At exactly
    ``slack == 0`` the request is therefore dispatched, never expired —
    the launch that starts now completes at the deadline, on time.
    """
    return deadline_t - (now + service_est_s)


def host_array(x) -> np.ndarray:
    """A request payload as a host NumPy array (a tensor is copied off its
    device; payloads are expected on the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stack_padded(xs: List, size: int) -> torch.Tensor:
    """Stack examples into a batch padded with zero rows to ``size``, on
    the host: the engine moves the batch to its device in one copy."""
    first = host_array(xs[0])
    batch = np.zeros((max(size, len(xs)),) + first.shape, first.dtype)
    for i, x in enumerate(xs):
        batch[i] = host_array(x)
    return torch.from_numpy(batch)


def _deadline(req: Request) -> float:
    return req.deadline_t if req.deadline_t is not None else _INF


@dataclass
class Batch:
    """One popped bucket: the requests that will share a launch."""
    key: BucketKey
    requests: List[Request]

    @property
    def kind(self) -> str:
        return self.key[0]

    @property
    def degraded(self) -> bool:
        """True when this batch must run on the degraded sibling engine."""
        return bool(self.requests) and self.requests[0].degraded

    def stack(self, max_batch: int) -> Tuple[torch.Tensor, int]:
        """-> (padded [P, ...] batch, live row count)."""
        n = len(self.requests)
        return stack_padded([r.x for r in self.requests],
                            pad_size(n, max_batch)), n


@dataclass
class _Bucket:
    requests: List[Request] = field(default_factory=list)
    oldest_t: float = 0.0

    def refresh(self) -> None:
        self.oldest_t = min((r.arrive_t for r in self.requests),
                            default=0.0)

    def earliest_deadline(self) -> float:
        return _deadline(self.requests[0]) if self.requests else _INF


class MicroBatcher:
    def __init__(self, *, max_batch: int = 8, max_delay_s: float = 0.002,
                 clock: Callable[[], float] = clock_lib.monotonic,
                 n_shards: int = 1):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.max_batch = max_batch
        #: mesh extent of the serving engine: a sharded launch has
        #: ``max_batch * n_shards`` seats (``fill_target``), so buckets fill
        #: toward full mesh occupancy before popping.
        self.n_shards = n_shards
        self.max_delay_s = max_delay_s
        self.clock = clock
        self._buckets: Dict[BucketKey, _Bucket] = {}

    @property
    def fill_target(self) -> int:
        """Seats per launch: ``max_batch`` per shard across the mesh."""
        return self.max_batch * self.n_shards

    def pending(self) -> int:
        return sum(len(b.requests) for b in self._buckets.values())

    def submit(self, req: Request) -> None:
        # ``is None``, not falsy: replay drivers pre-stamp true arrivals,
        # and a VirtualClock trace legitimately starts at t == 0.0 — a falsy
        # check would re-stamp that first arrival and mis-anchor its
        # deadline and EDF position.
        if req.arrive_t is None:
            req.arrive_t = self.clock()
        bucket = self._buckets.setdefault(bucket_key(req), _Bucket())
        if not bucket.requests:
            bucket.oldest_t = req.arrive_t
        # EDF insert: keep the bucket ascending by absolute deadline;
        # deadline-less requests stay FIFO at the back (stable bisect).
        dl, reqs = _deadline(req), bucket.requests
        lo, hi = 0, len(reqs)
        while lo < hi:
            mid = (lo + hi) // 2
            if _deadline(reqs[mid]) <= dl:
                lo = mid + 1
            else:
                hi = mid
        reqs.insert(lo, req)
        bucket.oldest_t = min(bucket.oldest_t, req.arrive_t)

    def _pop(self, key: BucketKey, n: int) -> Batch:
        bucket = self._buckets[key]
        popped, bucket.requests = bucket.requests[:n], bucket.requests[n:]
        if bucket.requests:
            bucket.refresh()
        else:
            del self._buckets[key]
        return Batch(key, popped)

    def expire(self, now: Optional[float] = None,
               service_est_s: float = 0.0) -> List[Request]:
        """Remove and return every request that cannot meet its deadline
        even if launched right now (:func:`slack_s` ``< 0``; the exact
        boundary ``slack == 0`` is dispatchable, see :func:`slack_s`).

        Run this BEFORE :meth:`ready`: a doomed request must neither occupy
        a seat in a padded launch nor hold a bucket open.  The caller turns
        the sweepings into shed responses and accounts them.
        """
        now = self.clock() if now is None else now
        doomed: List[Request] = []
        for key in list(self._buckets):
            bucket = self._buckets[key]
            keep = []
            for req in bucket.requests:
                if slack_s(_deadline(req), now, service_est_s) < 0:
                    doomed.append(req)
                else:
                    keep.append(req)
            if len(keep) != len(bucket.requests):
                if keep:
                    bucket.requests = keep
                    bucket.refresh()
                else:
                    del self._buckets[key]
        return doomed

    def ready(self, now: Optional[float] = None,
              service_est_s: float = 0.0) -> List[Batch]:
        """Pop every bucket that is full (``fill_target`` seats — one
        ``max_batch`` per mesh shard), past the bucket delay cap, or whose
        most urgent request would blow its deadline by waiting any longer
        (:func:`slack_s` ``<= 0`` — the same boundary :meth:`expire`
        sweeps at, so a ``slack == 0`` request is launched, not shed)."""
        now = self.clock() if now is None else now
        out = []
        for key in list(self._buckets):
            bucket = self._buckets.get(key)
            while bucket and len(bucket.requests) >= self.fill_target:
                out.append(self._pop(key, self.fill_target))
                bucket = self._buckets.get(key)
            if bucket and (now - bucket.oldest_t >= self.max_delay_s
                           or slack_s(bucket.earliest_deadline(), now,
                                      service_est_s) <= 0):
                out.append(self._pop(key, len(bucket.requests)))
        return out

    def flush(self) -> List[Batch]:
        """Pop everything (shutdown / drain), fill_target chunks."""
        out = []
        for key in list(self._buckets):
            while key in self._buckets:
                out.append(self._pop(key, self.fill_target))
        return out
