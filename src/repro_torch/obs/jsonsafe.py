"""Strict-JSON helpers for every snapshot the repo writes.

``json.dump`` happily emits ``NaN`` / ``Infinity`` — tokens that are NOT
JSON and break downstream parsers (Perfetto rejects the whole trace).
Empty-window percentiles used to leak ``float("nan")`` into BENCH files
this way.  All snapshot writers now go through :func:`dumps_strict` /
:func:`dump_strict` (``allow_nan=False`` — non-finite floats raise) after
:func:`sanitize` has mapped non-finite leaves to ``null``.
"""
from __future__ import annotations

import json
import math
from typing import Any, IO


def sanitize(obj: Any) -> Any:
    """Recursively replace non-finite floats with ``None`` (JSON null)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    return obj


def dumps_strict(obj: Any, **kwargs: Any) -> str:
    """``json.dumps`` that refuses non-finite floats outright."""
    kwargs.setdefault("allow_nan", False)
    return json.dumps(obj, **kwargs)


def dump_strict(obj: Any, fp: IO[str], **kwargs: Any) -> None:
    """Serialize with ``dumps_strict`` then write — the round-trip check
    happens before any bytes hit the file, so a non-finite leaf can never
    leave a half-written snapshot behind."""
    fp.write(dumps_strict(obj, **kwargs))
