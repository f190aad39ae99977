"""Per-request spans with parent/child links + Chrome trace-event export.

A trace id is minted per request at admission; the server threads a
:class:`RequestTrace` through batcher enqueue -> bucket dispatch ->
engine -> residual-cache lookup, ending every span even on shed /
expired / errored paths.  :meth:`Tracer.save` writes Chrome trace-event
JSON (the ``{"traceEvents": [...]}`` form) loadable in Perfetto or
``chrome://tracing`` — each trace id renders as its own named track.

ZERO-COST WHEN DISABLED: a disabled tracer's ``start`` returns the
process-wide :data:`NULL_SPAN` whose ``end``/``annotate``/``child`` are
no-ops — no allocation, no clock read, no branch in caller code.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock as clock_lib
from repro_torch.obs import jsonsafe

_ALLOWED_PH = {"X", "M"}


class Span:
    __slots__ = ("_tracer", "name", "cat", "trace_id", "span_id",
                 "parent_id", "t0", "t1", "args")

    def __init__(self, tracer: "Tracer", name: str, cat: str, trace_id: str,
                 span_id: int, parent_id: Optional[int], t0: float,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = dict(args) if args else {}

    @property
    def enabled(self) -> bool:
        return True

    def annotate(self, **args: Any) -> "Span":
        self.args.update(args)
        return self

    def child(self, name: str, *, cat: str = "span",
              t0: Optional[float] = None,
              args: Optional[Dict[str, Any]] = None) -> "Span":
        return self._tracer.start(name, cat=cat, trace_id=self.trace_id,
                                  parent=self, t0=t0, args=args)

    def end(self, t: Optional[float] = None, **args: Any) -> None:
        if self.t1 is not None:      # idempotent: first end wins
            return
        self.t1 = self._tracer.clock() if t is None else t
        if self.t1 < self.t0:        # clamp clock skew, never negative dur
            self.t1 = self.t0
        if args:
            self.args.update(args)

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id!r}, "
                f"id={self.span_id}, t0={self.t0:.6f}, t1={self.t1})")


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()
    enabled = False
    name = cat = trace_id = ""
    span_id = parent_id = None
    t0 = 0.0
    t1 = 0.0
    duration = 0.0
    args: Dict[str, Any] = {}

    def annotate(self, **args: Any) -> "_NullSpan":
        return self

    def child(self, name: str, **kw: Any) -> "_NullSpan":
        return self

    def end(self, t: Optional[float] = None, **args: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class RequestTrace:
    """The per-request span bundle the server threads through dispatch."""

    __slots__ = ("root", "queued", "engine")

    def __init__(self, root):
        self.root = root
        self.queued = NULL_SPAN
        self.engine = NULL_SPAN


class Tracer:
    """Collects spans against one clock; bounded; exports Chrome JSON."""

    def __init__(self, clock=None, *, max_spans: int = 200_000,
                 enabled: bool = True):
        self.clock = clock if clock is not None else clock_lib.monotonic
        self.enabled = enabled
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.dropped = 0
        self._ids = itertools.count(1)

    def start(self, name: str, *, cat: str = "span",
              trace_id: Optional[str] = None, parent: Optional[Span] = None,
              t0: Optional[float] = None,
              args: Optional[Dict[str, Any]] = None):
        if not self.enabled:
            return NULL_SPAN
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return NULL_SPAN
        if parent is not None and parent.enabled:
            trace_id = parent.trace_id if trace_id is None else trace_id
            parent_id = parent.span_id
        else:
            parent_id = None
        span = Span(self, name, cat, trace_id or "", next(self._ids),
                    parent_id, self.clock() if t0 is None else t0, args)
        self.spans.append(span)
        return span

    def finish(self) -> None:
        """Terminate any still-open spans (marked incomplete)."""
        now = self.clock()
        for span in self.spans:
            if span.t1 is None:
                span.end(t=now, incomplete=True)

    def reset(self) -> None:
        self.spans.clear()
        self.dropped = 0
        self._ids = itertools.count(1)

    # --- export ------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (ts/dur in microseconds)."""
        events = []
        tids: Dict[str, int] = {}
        for span in self.spans:
            tid = tids.get(span.trace_id)
            if tid is None:
                tid = tids[span.trace_id] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": 1,
                               "tid": tid,
                               "args": {"name": span.trace_id or "untraced"}})
            t1 = span.t1 if span.t1 is not None else span.t0
            args = {k: v for k, v in span.args.items()}
            args["trace_id"] = span.trace_id
            args["span_id"] = span.span_id
            if span.parent_id is not None:
                args["parent_id"] = span.parent_id
            events.append({
                "ph": "X", "name": span.name, "cat": span.cat,
                "pid": 1, "tid": tid,
                "ts": round(span.t0 * 1e6, 3),
                "dur": round((t1 - span.t0) * 1e6, 3),
                "args": jsonsafe.sanitize(args),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def save(self, path: str) -> dict:
        obj = self.to_chrome()
        with open(path, "w") as f:
            jsonsafe.dump_strict(obj, f)
        return obj


class _NullTracer:
    """The disabled tracer: ``start`` hands back the shared no-op span."""

    enabled = False
    spans: List[Span] = []
    dropped = 0
    clock = staticmethod(clock_lib.monotonic)

    def start(self, name: str, **kw: Any) -> _NullSpan:
        return NULL_SPAN

    def finish(self) -> None:
        return None

    def reset(self) -> None:
        return None


NULL_TRACER = _NullTracer()


# --- validation -------------------------------------------------------------

def integrity_errors(spans: List[Span]) -> List[str]:
    """Structural checks over collected spans: every span terminated,
    parents exist, children nest inside their parent's [t0, t1] on the
    same trace id.  Returns human-readable problem strings (empty = ok)."""
    errors = []
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.t1 is None:
            errors.append(f"unterminated span {s!r}")
            continue
        if s.t1 < s.t0:
            errors.append(f"negative duration {s!r}")
        if s.parent_id is None:
            continue
        parent = by_id.get(s.parent_id)
        if parent is None:
            errors.append(f"dangling parent_id={s.parent_id} on {s!r}")
            continue
        if parent.trace_id != s.trace_id:
            errors.append(f"cross-trace parent on {s!r}")
        if s.t0 < parent.t0 - 1e-9:
            errors.append(f"child starts before parent: {s!r}")
        if parent.t1 is not None and s.t1 > parent.t1 + 1e-9:
            errors.append(f"child ends after parent: {s!r}")
    return errors


def validate_chrome(obj: Any) -> List[str]:
    """Schema-check a Chrome trace-event JSON object (the dict form)."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing top-level traceEvents array"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    ids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i}: missing name/pid/tid")
        if ph == "X":
            for fld in ("ts", "dur"):
                v = ev.get(fld)
                if not isinstance(v, (int, float)) or v != v:
                    problems.append(f"event {i}: non-numeric {fld}")
            if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
                problems.append(f"event {i}: negative dur")
            args = ev.get("args", {})
            sid = args.get("span_id")
            if sid is not None:
                ids.add(sid)
    for i, ev in enumerate(events):
        if isinstance(ev, dict) and ev.get("ph") == "X":
            pid = ev.get("args", {}).get("parent_id")
            if pid is not None and pid not in ids:
                problems.append(f"event {i}: dangling parent_id {pid}")
    return problems
