"""Serving counters: per-method latency percentiles, throughput, cache hits.

Plain-Python accounting on the host side of the dispatch loop — nothing
here touches device tensors.  Latencies are recorded per (kind, method) so a
mixed workload reports predict and explain tails separately, and the
snapshot is a JSON-ready dict the benchmarks emit into ``BENCH_<date>.json``.

Two layers of accounting share these entry points:

  * each ``ServerStats`` instance keeps its server's own windows (what
    :meth:`snapshot` reports — unchanged shape, except empty-window
    percentiles are now ``None``, never ``NaN``: NaN is not JSON and used
    to corrupt BENCH files);
  * every record also increments the process-wide :mod:`repro_torch.obs`
    catalog series, so ``obs.snapshot()`` aggregates across all servers
    in the process alongside plan-cache and engine-cache series.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from repro_torch.obs import metrics as obsm

# percentiles are computed over a sliding window so a long-running server's
# stats stay O(1) memory; count/mean remain exact over the full lifetime
LATENCY_WINDOW = 4096


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ascending list (0 <= q <= 100).

    Returns ``None`` for an empty window — callers emit JSON null (the
    old ``float("nan")`` serialized as invalid-JSON ``NaN``).
    """
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _us(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else 1e6 * seconds


@dataclass
class MethodStats:
    count: int = 0
    cache_hits: int = 0
    total_s: float = 0.0
    latencies_s: Deque[float] = field(
        default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    def record(self, latency_s: float, cache_hit: bool) -> None:
        self.count += 1
        self.cache_hits += bool(cache_hit)
        self.total_s += latency_s
        self.latencies_s.append(latency_s)

    def snapshot(self) -> dict:
        lat = sorted(self.latencies_s)      # last LATENCY_WINDOW requests
        return {
            "count": self.count,
            "cache_hits": self.cache_hits,
            "hit_rate": self.cache_hits / self.count if self.count else 0.0,
            "mean_us": 1e6 * self.total_s / self.count if self.count else 0.0,
            "p50_us": _us(percentile(lat, 50)),
            "p99_us": _us(percentile(lat, 99)),
        }


class ServerStats:
    """Aggregates request completions; keys are ``kind/method``.

    The hardening counters make the overload story auditable: ``sheds``
    per reason (``queue_full | rate_limit | deadline | expired``),
    ``degrades`` per action, dispatch ``errors``/``timeouts``, and the
    peak queue depth observed at submit time.
    """

    def __init__(self):
        self.methods: Dict[str, MethodStats] = defaultdict(MethodStats)
        self.batches = 0
        self.batched_rows = 0
        self.padded_rows = 0
        self.sheds: Dict[str, int] = defaultdict(int)
        self.degrades: Dict[str, int] = defaultdict(int)
        self.errors = 0
        self.timeouts = 0
        self.peak_queue_depth = 0

    def record(self, kind: str, method: str, latency_s: float,
               cache_hit: bool) -> None:
        name = f"{kind}/{method}" if method else kind
        self.methods[name].record(latency_s, cache_hit)
        obsm.SERVE_REQUESTS.inc(kind=kind, method=method)
        obsm.SERVE_LATENCY.observe(latency_s, kind=kind, method=method)
        if cache_hit:
            obsm.SERVE_CACHE_HITS.inc(method=method)

    def record_batch(self, live: int, padded: int) -> None:
        self.batches += 1
        self.batched_rows += live
        self.padded_rows += padded
        obsm.SERVE_BATCHES.inc()
        obsm.SERVE_BATCH_ROWS.inc(live, state="live")
        obsm.SERVE_BATCH_ROWS.inc(padded - live, state="padded")

    def record_shed(self, reason: str) -> None:
        self.sheds[reason] += 1
        obsm.SERVE_SHEDS.inc(reason=reason)

    def record_degrade(self, action: str) -> None:
        self.degrades[action] += 1
        obsm.SERVE_DEGRADES.inc(action=action)

    def record_error(self) -> None:
        self.errors += 1
        obsm.SERVE_ERRORS.inc()

    def record_timeout(self) -> None:
        self.timeouts += 1
        obsm.SERVE_TIMEOUTS.inc()

    def record_queue_depth(self, depth: int) -> None:
        self.peak_queue_depth = max(self.peak_queue_depth, depth)
        obsm.SERVE_QUEUE_DEPTH.set(depth)
        obsm.SERVE_QUEUE_PEAK.set_max(depth)

    def requests(self) -> int:
        return sum(m.count for m in self.methods.values())

    def shed_count(self) -> int:
        return sum(self.sheds.values())

    def shed_rate(self) -> float:
        """Sheds / offered load (completions + sheds)."""
        offered = self.requests() + self.shed_count()
        return self.shed_count() / offered if offered else 0.0

    def snapshot(self) -> dict:
        return {
            "requests": self.requests(),
            "batches": self.batches,
            "mean_occupancy": (self.batched_rows / max(self.padded_rows, 1)),
            "sheds": dict(self.sheds),
            "shed_rate": self.shed_rate(),
            "degrades": dict(self.degrades),
            "errors": self.errors,
            "timeouts": self.timeouts,
            "peak_queue_depth": self.peak_queue_depth,
            "methods": {k: v.snapshot()
                        for k, v in sorted(self.methods.items())},
        }
