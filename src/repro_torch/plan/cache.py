"""Persistent JSON tuning cache for the tile planner.

``repro.plan.cache``'s store, key and blob format: one JSON file
``{key: {"tile": [...], "family": ..., "measured_us": ...}}``, written
atomically (tmp + rename); a truncated, garbage or partly scribbled file
never takes the planner down (logged, the bad content dropped, the clean
state rewritten, planning proceeds as a recompute); ``hits`` / ``misses``
let callers assert that a warm build is a 100 % cache hit.  Entries of
the JAX package's profiles are the reference's, blob for blob, so each
package reads the other's.  An entry of the card's profile also names the
launch object's class (``"plan"``: ``ConvPlan``, ``VmmBwdMmaPlan``, ...,
or ``"splits"``) and records the rule's measured time (``rule_us``); its
tile may hold zeros (a general kernel's plan) and up to six ints.

Location: ``$REPRO_TORCH_PLAN_CACHE`` if set, else
``~/.cache/repro_torch/tileplans.json``: the two packages never rewrite
each other's file.  Lookups and stores count into the
``plan_cache_lookups_total`` / ``plan_cache_stores_total`` series.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

from repro_torch.obs import metrics as obsm

_ENV_VAR = "REPRO_TORCH_PLAN_CACHE"

#: Arity of the card's launch objects by the class name an entry records.
CARD_PLAN_ARITY = {"splits": 1, "ConvPlan": 4, "ConvMmaPlan": 4,
                   "ConvBwdPlan": 6, "ConvBwdMmaPlan": 6, "VmmMmaPlan": 2,
                   "VmmBwdPlan": 4, "VmmBwdMmaPlan": 5}

_log = logging.getLogger(__name__)


def default_cache_path() -> str:
    """``$REPRO_TORCH_PLAN_CACHE`` or
    ``~/.cache/repro_torch/tileplans.json``."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tileplans.json")


def cache_key(family: str, shapes: Sequence[int], dtype: str,
              precision: str, device: str) -> str:
    """The tuning-cache key: kernel family + every shape dim that reaches
    the tiling policy + numeric contract + planning target."""
    dims = "x".join(str(int(d)) for d in shapes)
    return f"{family}|{dims}|{dtype}|{precision}|{device}"


def _ints(tile, least: int) -> bool:
    return all(isinstance(t, int) and not isinstance(t, bool) and t >= least
               for t in tile)


class TuningCache:
    """Lazy-loading, write-through JSON store of planned/measured tiles."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, Any]] = None
        self.hits = 0
        self.misses = 0

    # -- storage -------------------------------------------------------------

    @property
    def data(self) -> Dict[str, Any]:
        if self._data is None:
            self._data = self._load()
        return self._data

    @staticmethod
    def valid_entry(entry: Any) -> bool:
        """Schema check for one cache entry: a dict whose ``tile`` is a
        short list of positive ints (ConvTile=1, VmmBwdTile/ScanTile=2,
        VmmTile=3), or, for an entry naming a card launch object
        (``"plan"``), that object's arity of non-negative ints.  Anything
        else is treated as absent, never decoded."""
        if not isinstance(entry, dict):
            return False
        tile = entry.get("tile")
        if not isinstance(tile, list):
            return False
        kind = entry.get("plan")
        if kind is not None:
            return (CARD_PLAN_ARITY.get(kind) == len(tile)
                    and _ints(tile, 0))
        return 1 <= len(tile) <= 3 and _ints(tile, 1)

    def _load(self) -> Dict[str, Any]:
        """Read the file; log-and-recover (atomic rewrite) on corruption."""
        try:
            with open(self.path) as f:
                raw = f.read()
        except FileNotFoundError:
            return {}
        except OSError as e:
            _log.warning("tuning cache %s unreadable (%s); replanning "
                         "without it", self.path, e)
            return {}
        try:
            loaded = json.loads(raw)
            if not isinstance(loaded, dict):
                raise ValueError(
                    f"top level is {type(loaded).__name__}, not an object")
        except ValueError as e:
            _log.warning("tuning cache %s is corrupt (%s); dropping it and "
                         "recomputing — rewriting a clean empty cache",
                         self.path, e)
            self._data = {}
            self._try_flush()
            return self._data
        bad = [k for k, v in loaded.items() if not self.valid_entry(v)]
        if bad:
            _log.warning("tuning cache %s: dropping %d malformed entr%s "
                         "(%s); keeping %d valid", self.path, len(bad),
                         "y" if len(bad) == 1 else "ies",
                         ", ".join(sorted(bad)[:3]), len(loaded) - len(bad))
            for k in bad:
                del loaded[k]
            self._data = loaded
            self._try_flush()
        return loaded

    def _try_flush(self) -> None:
        """Persist the cleaned state; failure to rewrite is only a log."""
        try:
            self._flush()
        except OSError as e:
            _log.warning("could not rewrite tuning cache %s: %s",
                         self.path, e)

    def _flush(self) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- the lookup contract -------------------------------------------------

    def lookup(self, key: str, *,
               require_measured: bool = False) -> Optional[Dict[str, Any]]:
        """Entry for ``key`` (counted as a hit), or None (a miss).

        ``require_measured=True`` treats an entry without a recorded
        ``measured_us`` as a miss — an analytic-only entry must not
        suppress a later autotuned (measuring) plan of the same key.
        Entries failing :meth:`valid_entry` are also misses.
        """
        entry = self.data.get(key)
        if entry is None or not self.valid_entry(entry) \
                or (require_measured and entry.get("measured_us") is None):
            self.misses += 1
            obsm.PLAN_CACHE_LOOKUPS.inc(result="miss")
            return None
        self.hits += 1
        obsm.PLAN_CACHE_LOOKUPS.inc(result="hit")
        return entry

    def store(self, key: str, entry: Dict[str, Any]) -> None:
        """Write-through insert: the JSON file is updated immediately.
        An unwritable path costs persistence, never the plan (logged)."""
        self.data[key] = entry
        obsm.PLAN_CACHE_STORES.inc()
        self._try_flush()

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        """Drop every entry (and the file's contents)."""
        self._data = {}
        self._flush()

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self):
        return (f"<TuningCache {self.path!r} entries={len(self)} "
                f"hits={self.hits} misses={self.misses}>")
