"""The single injectable monotonic clock for every serving timestamp.

Deadlines, batcher delays, latency stats, and trace spans must all agree
about "now" or deadline decisions and trace timelines drift apart.  Every
component takes a ``clock`` callable defaulting to :func:`monotonic`;
tests and the load-replay harness inject a :class:`VirtualClock` and the
whole stack — spans included — runs on simulated time.
"""
from __future__ import annotations

import time

#: Default wall clock: monotonic seconds, arbitrary epoch.  The one
#: sanctioned ``time.*`` read for serving-path timestamps.
monotonic = time.monotonic

#: High-resolution timer for measurement loops (kernel profiling,
#: benchmark harnesses).  Same contract: monotonic seconds.
perf = time.perf_counter


class VirtualClock:
    """Deterministic manual-advance clock conforming to the ``clock``
    protocol (a zero-arg callable returning monotonic seconds)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot rewind a monotonic clock (dt={dt})")
        self.t += dt
        return self.t
