"""LRU cache of bit-packed forward residuals, keyed by request id.

The paper's FPGA answers "why?" cheaply because the forward pass already
parked its ReLU sign bits (1 bit/elt) and max-pool argmax crumbs
(2 bits/window) in BRAM: an explanation is then ONLY the BP phase over those
masks (§III.F).  This module is the serving-time analogue — a *predict*
request stores its packed masks here, and a follow-up *explain* for the same
``uid`` (any pure-BP method, any target/top-K panel) skips the forward pass
entirely and goes straight to the fused seed-batched backward.

Entries are tiny by construction (the paper's 137x cut: 24.7 Kb vs 3.4 Mb
for the Table III CNN at batch 1), so thousands of in-flight explanations
fit where a handful of activation caches would; the cache still bounds
itself by entry count and reports its exact bit footprint.  An entry's
residual tensors own their storage (``adapters.slice_example`` copies each
example out of its batch), so the bits it reports are the bytes it holds
on the device, and evicting it frees them.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.obs import metrics as obsm


def leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def _leaf_bits(leaf) -> int:
    if hasattr(leaf, "element_size"):                  # torch.Tensor
        return 8 * leaf.numel() * leaf.element_size()
    return 8 * int(np.prod(leaf.shape)) * leaf.dtype.itemsize


def residual_bits(residuals: Any) -> int:
    """Exact stored-bit count of a residual tree (nested dict / list /
    tuple of tensors or arrays; packed uint8 = 8 b/elt).  Leaves without a
    dtype (``None`` sites, static shape ints) count nothing."""
    return sum(_leaf_bits(leaf) for leaf in leaves(residuals)
               if hasattr(leaf, "dtype"))


@dataclass
class CacheEntry:
    logits: Any          # [C] — the predicted logits (on the engine's device)
    residuals: Any       # packed masks/indices tree for ONE example
    rules: str           # rule set the forward stored masks under
    bits: int = 0
    # float32 host copy of ``logits``, made once per batch: argmax / top-K
    # targets resolve on the host without a device sync per request
    host_logits: Optional[np.ndarray] = None

    def __post_init__(self):
        if not self.bits:
            self.bits = residual_bits(self.residuals)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bits_stored: int = 0
    peak_bits: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate(),
                "bits_stored": self.bits_stored, "peak_bits": self.peak_bits}


class ResidualCache:
    """Bounded LRU: ``uid -> CacheEntry``; get() refreshes recency."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, uid: str) -> bool:
        return uid in self._entries

    def put(self, uid: str, entry: CacheEntry) -> None:
        if uid in self._entries:
            self.stats.bits_stored -= self._entries.pop(uid).bits
        self._entries[uid] = entry
        self.stats.bits_stored += entry.bits
        self.stats.peak_bits = max(self.stats.peak_bits,
                                   self.stats.bits_stored)
        obsm.RESIDUAL_CACHE.inc(event="store")
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            self.stats.bits_stored -= old.bits
            self.stats.evictions += 1
            obsm.RESIDUAL_CACHE.inc(event="eviction")
        obsm.RESIDUAL_CACHE_BITS.set(self.stats.bits_stored)

    def get(self, uid: str) -> Optional[CacheEntry]:
        entry = self._entries.get(uid)
        if entry is None:
            self.count_miss()
            return None
        self._entries.move_to_end(uid)
        self.stats.hits += 1
        obsm.RESIDUAL_CACHE.inc(event="hit")
        return entry

    def count_miss(self) -> None:
        """Account a miss decided outside :meth:`get` (e.g. a present but
        rules-incompatible entry the server declines to use)."""
        self.stats.misses += 1
        obsm.RESIDUAL_CACHE.inc(event="miss")

    def peek(self, uid: str) -> Optional[CacheEntry]:
        """Presence probe — no recency update, no hit/miss accounting."""
        return self._entries.get(uid)


def owned_bytes(cache: ResidualCache) -> int:
    """Bytes of the distinct storages the cache's residual tensors hold —
    equal to ``stats.bits_stored / 8`` when every entry owns its bytes."""
    seen = {}
    for entry in cache._entries.values():
        for leaf in leaves(entry.residuals):
            if hasattr(leaf, "untyped_storage"):
                st = leaf.untyped_storage()
                seen[(st.device.type, st.data_ptr())] = st.nbytes()
    return sum(seen.values())
