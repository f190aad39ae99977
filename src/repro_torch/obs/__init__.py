"""repro_torch.obs — observability for the port, as ``repro.obs`` has it:
metrics, per-request tracing and the one injectable clock.

  * :mod:`repro_torch.obs.registry` — typed counters / gauges /
    histograms with label sets, a strict-JSON snapshot, and
    Prometheus-style text exposition.  ``repro_torch.serve``'s stats,
    admission sheds/degrades and residual-cache events all record into ONE
    default registry, so :func:`snapshot` describes the whole process.
  * :mod:`repro_torch.obs.trace` — per-request spans with parent/child
    links, minted at admission and carried through batcher enqueue ->
    bucket dispatch -> engine -> residual-cache lookup, exported as Chrome
    trace-event JSON (Perfetto-loadable).
  * :mod:`repro_torch.obs.clock` — the single injectable monotonic clock
    every serving timestamp reads (``VirtualClock`` conforms), so traces
    and deadlines never disagree about "now".

ZERO-COST WHEN DISABLED: a server without a tracer uses the shared no-op
span (no allocation, no clock reads).  The kernel profiler
(``obs/profile.py``) and ``python -m repro.obs`` come with ROADMAP A9.
"""
from repro_torch.obs.clock import VirtualClock, monotonic, perf
from repro_torch.obs.jsonsafe import dump_strict, dumps_strict, sanitize
from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      default_registry, render_prometheus,
                                      reset, snapshot)
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, RequestTrace,
                                   Span, Tracer, integrity_errors,
                                   validate_chrome)

__all__ = [
    "VirtualClock", "monotonic", "perf",
    "dump_strict", "dumps_strict", "sanitize",
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "render_prometheus", "reset", "snapshot",
    "NULL_SPAN", "NULL_TRACER", "RequestTrace", "Span", "Tracer",
    "integrity_errors", "validate_chrome",
]
