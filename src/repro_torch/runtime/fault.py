"""Fault-tolerance runtime: health monitoring, straggler detection, elastic
re-meshing, as ``repro.runtime.fault`` has them (host logic, no device).

On a real multi-pod deployment these hooks sit between the cluster manager
and the train loop; the logic (all testable on CPU) is:

  * HealthMonitor — per-step wall-times per host; flags stragglers
    (> ``threshold`` x the rolling median) and dead hosts (missed
    heartbeats).  Real deployments feed it from per-host heartbeat RPCs;
    the train driver feeds it its own step times, which also catches
    SMI-style slowdowns of the local host.
  * plan_remesh — given the healthy host set, picks the largest mesh the
    checkpoint can restore into (drop a pod, halve data parallelism, ...)
    — elastic scaling is "restore the last checkpoint into the new mesh",
    which the deterministic data stream (repro_torch.data) makes exact.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class HealthMonitor:
    window: int = 32
    straggler_factor: float = 2.0
    heartbeat_timeout_s: float = 60.0

    _times: Dict[int, deque] = field(default_factory=dict)
    _last_beat: Dict[int, float] = field(default_factory=dict)

    def record_step(self, host_id: int, seconds: float,
                    now: Optional[float] = None):
        self._times.setdefault(host_id, deque(maxlen=self.window)).append(seconds)
        self._last_beat[host_id] = time.monotonic() if now is None else now

    def median_step(self, host_id: int) -> Optional[float]:
        ts = self._times.get(host_id)
        if not ts:
            return None
        s = sorted(ts)
        return s[len(s) // 2]

    def stragglers(self) -> List[int]:
        """Hosts whose rolling median exceeds factor x fleet median."""
        meds = {h: self.median_step(h) for h in self._times}
        meds = {h: m for h, m in meds.items() if m is not None}
        if not meds:
            return []
        fleet = sorted(meds.values())[len(meds) // 2]
        return [h for h, m in meds.items()
                if m > self.straggler_factor * fleet]

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last_beat.items()
                if now - t > self.heartbeat_timeout_s]


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_hosts: Tuple[int, ...]
    note: str


def plan_remesh(total_hosts: int, healthy_hosts: Sequence[int],
                chips_per_host: int = 4,
                model_parallel: int = 16) -> ElasticPlan:
    """Largest (pod, data, model) mesh from the healthy hosts.

    Policy: model parallelism is fixed (param shards must fit); data
    parallelism shrinks to the largest power-of-two slice of healthy chips;
    a whole pod is dropped when fewer than half its hosts survive.
    """
    healthy = sorted(healthy_hosts)
    chips = len(healthy) * chips_per_host
    data = chips // model_parallel
    # largest power of two
    d2 = 1
    while d2 * 2 <= data:
        d2 *= 2
    dropped = tuple(h for h in range(total_hosts) if h not in healthy)
    if d2 >= 32:   # two pods still viable
        return ElasticPlan((2, d2 // 2, model_parallel),
                           ("pod", "data", "model"), dropped,
                           f"multi-pod, data {d2 // 2}/pod")
    return ElasticPlan((max(1, d2), model_parallel), ("data", "model"),
                       dropped, "degraded to single pod")
