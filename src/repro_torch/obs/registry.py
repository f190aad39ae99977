"""Typed metrics registry: counters, gauges, histograms with label sets.

One process-wide default registry (module functions :func:`snapshot`,
:func:`render_prometheus`, :func:`reset`) collects series from every
layer — serve, plan cache, engine build cache, kernel profiler — so a
single ``obs.snapshot()`` describes the whole process.  Design points:

  * **Hot-path cost**: ``Counter.inc`` is one dict lookup + add;
    ``Histogram.observe`` adds a bisect into precomputed bucket bounds
    and a bounded-window append.  No locks (the serving loop is
    single-threaded by design), no string formatting until export.
  * **Label-cardinality guard**: each instrument accepts at most
    ``max_label_sets`` distinct label tuples; further novel tuples
    collapse into one reserved ``__overflow__`` series instead of
    growing memory without bound (a mis-labelled uid would otherwise
    mint a series per request).
  * **Strict JSON**: ``snapshot()`` round-trips through
    ``json.dumps(..., allow_nan=False)`` — empty-window percentiles are
    ``null``, never ``NaN``.
  * **Prometheus text exposition**: ``render_prometheus()`` emits the
    standard ``# HELP`` / ``# TYPE`` + ``name{label="v"} value`` format
    (histograms as cumulative ``_bucket`` / ``_sum`` / ``_count``).
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import jsonsafe

OVERFLOW = "__overflow__"

#: Log-spaced seconds buckets: 1us .. 10s, one decade apart.  Wide on
#: purpose — they cover kernel launches (us) through request latencies
#: (ms-s) with one shared shape.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(10.0 ** e for e in range(-6, 2))

_HIST_WINDOW = 1024   # per-series sliding window for percentile estimates


def percentile_of(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile; ``None`` (not NaN) on an empty window."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, max(0, int(round(
        (q / 100.0) * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 max_label_sets: int):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.max_label_sets = max_label_sets
        self.overflowed = 0          # novel label tuples collapsed
        self._cells: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        if key not in self._cells and len(self._cells) >= self.max_label_sets:
            self.overflowed += 1
            return (OVERFLOW,) * len(self.labelnames)
        return key

    def _new_cell(self):
        raise NotImplementedError

    def _cell(self, labels: Dict[str, object]):
        key = self._key(labels)
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = self._new_cell()
        return cell

    def reset(self) -> None:
        self._cells.clear()
        self.overflowed = 0

    def series(self):
        """Yield (labels-dict, cell) pairs in insertion order."""
        for key, cell in self._cells.items():
            yield dict(zip(self.labelnames, key)), cell


class Counter(_Instrument):
    kind = "counter"

    def _new_cell(self) -> list:
        return [0.0]

    def inc(self, n: float = 1.0, **labels) -> None:
        self._cell(labels)[0] += n

    def value(self, **labels) -> float:
        cell = self._cells.get(tuple(str(labels.get(n, ""))
                                     for n in self.labelnames))
        return cell[0] if cell else 0.0

    def total(self) -> float:
        return sum(c[0] for c in self._cells.values())

    def snapshot(self):
        return [{"labels": lbl, "value": cell[0]}
                for lbl, cell in self.series()]


class Gauge(_Instrument):
    kind = "gauge"

    def _new_cell(self) -> list:
        return [0.0]

    def set(self, v: float, **labels) -> None:
        self._cell(labels)[0] = v

    def set_max(self, v: float, **labels) -> None:
        cell = self._cell(labels)
        if v > cell[0]:
            cell[0] = v

    def value(self, **labels) -> float:
        cell = self._cells.get(tuple(str(labels.get(n, ""))
                                     for n in self.labelnames))
        return cell[0] if cell else 0.0

    def snapshot(self):
        return [{"labels": lbl, "value": cell[0]}
                for lbl, cell in self.series()]


class _HistCell:
    __slots__ = ("counts", "count", "sum", "min", "max", "window")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)      # +1 = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.window = deque(maxlen=_HIST_WINDOW)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help, labelnames, max_label_sets,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, max_label_sets)
        self.buckets = tuple(sorted(buckets))

    def _new_cell(self) -> _HistCell:
        return _HistCell(len(self.buckets))

    def observe(self, v: float, **labels) -> None:
        cell = self._cell(labels)
        cell.counts[bisect_left(self.buckets, v)] += 1
        cell.count += 1
        cell.sum += v
        if cell.min is None or v < cell.min:
            cell.min = v
        if cell.max is None or v > cell.max:
            cell.max = v
        cell.window.append(v)

    def snapshot(self):
        out = []
        for lbl, cell in self.series():
            win = sorted(cell.window)
            cum, buckets = 0, {}
            for le, n in zip(self.buckets, cell.counts):
                cum += n
                buckets[f"{le:g}"] = cum
            buckets["+Inf"] = cell.count
            out.append({
                "labels": lbl, "count": cell.count, "sum": cell.sum,
                "min": cell.min, "max": cell.max,
                "mean": (cell.sum / cell.count) if cell.count else None,
                "p50": percentile_of(win, 50),
                "p99": percentile_of(win, 99),
                "buckets": buckets,
            })
        return out


class Registry:
    """A namespace of instruments; idempotent registration."""

    def __init__(self, max_label_sets: int = 256):
        self.max_label_sets = max_label_sets
        self._instruments: Dict[str, _Instrument] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw):
        labelnames = tuple(labelnames)
        existing = self._instruments.get(name)
        if existing is not None:
            if type(existing) is not cls or existing.labelnames != labelnames:
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} with "
                    f"labels {labelnames} (was {existing.kind} "
                    f"{existing.labelnames})")
            return existing
        inst = cls(name, help, labelnames, self.max_label_sets, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def reset(self) -> None:
        """Zero every series (instruments stay registered)."""
        for inst in self._instruments.values():
            inst.reset()

    def snapshot(self, strict: bool = True) -> dict:
        snap = {
            name: {"kind": inst.kind, "help": inst.help,
                   "overflowed": inst.overflowed,
                   "series": inst.snapshot()}
            for name, inst in sorted(self._instruments.items())
        }
        if strict:                       # round-trip: NaN can never escape
            jsonsafe.dumps_strict(snap)
        return snap

    def render_prometheus(self) -> str:
        lines = []
        for name, inst in sorted(self._instruments.items()):
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for lbl, cell in inst.series():
                base = _fmt_labels(lbl)
                if inst.kind in ("counter", "gauge"):
                    lines.append(f"{name}{base} {cell[0]:g}")
                else:                               # histogram
                    cum = 0
                    for le, n in zip(inst.buckets, cell.counts):
                        cum += n
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(lbl, le=f'{le:g}')} {cum}")
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lbl, le='+Inf')} "
                        f"{cell.count}")
                    lines.append(f"{name}_sum{base} {cell.sum:g}")
                    lines.append(f"{name}_count{base} {cell.count}")
        return "\n".join(lines) + "\n"


def _fmt_labels(lbl: Dict[str, str], **extra: str) -> str:
    items = {**lbl, **extra}
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in items.items())
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def snapshot(strict: bool = True) -> dict:
    return _DEFAULT.snapshot(strict=strict)


def render_prometheus() -> str:
    return _DEFAULT.render_prometheus()


def reset() -> None:
    _DEFAULT.reset()
