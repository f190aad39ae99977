"""Well-known instrument catalog on the default registry.

Every layer records into these shared series, so one ``obs.snapshot()``
describes serve + plan + engine in a single document.  The names, kinds
and labels are ``repro.obs.metrics``'s; the plan-cache series count the
tuning cache's lookups and stores (:mod:`repro_torch.plan.cache`), and the
kernel series fills while the kernel profiler
(:mod:`repro_torch.obs.profile`) is on.
All instruments
are registered EAGERLY at import: a snapshot from a freshly started
process already names every series the system can produce (zero-valued),
which is what dashboards and the BENCH trend view key on.
"""
from __future__ import annotations

from repro_torch.obs.registry import default_registry

_R = default_registry()

# --- serve -----------------------------------------------------------------
SERVE_REQUESTS = _R.counter(
    "serve_requests_total",
    "completed responses by kind/method (method='' for predict)",
    ("kind", "method"))
SERVE_LATENCY = _R.histogram(
    "serve_request_latency_seconds",
    "arrival->response latency by kind/method",
    ("kind", "method"))
SERVE_CACHE_HITS = _R.counter(
    "serve_requests_cache_hits_total",
    "explain responses answered from the residual cache",
    ("method",))
SERVE_SHEDS = _R.counter(
    "serve_sheds_total",
    "admission refusals by typed reason",
    ("reason",))
SERVE_DEGRADES = _R.counter(
    "serve_degrades_total",
    "requests admitted in degraded form, by action",
    ("action",))
SERVE_ERRORS = _R.counter(
    "serve_errors_total",
    "per-request dispatch faults (isolated, not server crashes)")
SERVE_TIMEOUTS = _R.counter(
    "serve_dispatch_timeouts_total",
    "admitted requests that finished past their deadline")
SERVE_BATCHES = _R.counter(
    "serve_batches_total",
    "dispatched micro-batches")
SERVE_BATCH_ROWS = _R.counter(
    "serve_batch_rows_total",
    "dispatched batch rows by state (live vs pow2 padding)",
    ("state",))
SERVE_QUEUE_DEPTH = _R.gauge(
    "serve_queue_depth",
    "pending requests at last enqueue")
SERVE_QUEUE_PEAK = _R.gauge(
    "serve_queue_depth_peak",
    "high-water mark of pending requests")
SERVE_SERVICE_EST = _R.gauge(
    "serve_service_estimate_seconds",
    "admission EWMA per-request service estimate",
    ("cls",))

# --- residual cache --------------------------------------------------------
RESIDUAL_CACHE = _R.counter(
    "serve_residual_cache_events_total",
    "residual-mask cache traffic (hit/miss/store/eviction)",
    ("event",))
RESIDUAL_CACHE_BITS = _R.gauge(
    "serve_residual_cache_bits",
    "bits currently stored in the residual cache")

# --- plan ------------------------------------------------------------------
PLAN_CACHE_LOOKUPS = _R.counter(
    "plan_cache_lookups_total",
    "tuning-cache lookups by result",
    ("result",))
PLAN_CACHE_STORES = _R.counter(
    "plan_cache_stores_total",
    "tuning-cache entries written")

# --- engine ----------------------------------------------------------------
ENGINE_BUILDS = _R.counter(
    "engine_builds_total",
    "engine build-cache outcomes (build/hit/evict)",
    ("outcome",))

# --- kernels (the opt-in profiler, obs/profile.py) -------------------------
KERNEL_SECONDS = _R.histogram(
    "kernel_launch_seconds",
    "fenced wall time of eager kernel wrapper launches",
    ("family", "shape", "precision"))

# seed the series acceptance cares about, so a fresh snapshot names them
for _reason in ("queue_full", "rate_limit", "deadline", "expired"):
    SERVE_SHEDS.inc(0, reason=_reason)
for _action in ("topk_to_argmax", "reroute_precision"):
    SERVE_DEGRADES.inc(0, action=_action)
for _event in ("hit", "miss", "store", "eviction"):
    RESIDUAL_CACHE.inc(0, event=_event)
for _result in ("hit", "miss"):
    PLAN_CACHE_LOOKUPS.inc(0, result=_result)
for _outcome in ("build", "hit", "evict"):
    ENGINE_BUILDS.inc(0, outcome=_outcome)
