"""Heatmap-agreement metrics (paper §IV), as ``repro.core.fidelity`` has
them: rank-based, since a heatmap is read by which pixels dominate, not by
their magnitudes.

Every metric takes two same-shape arrays (NumPy arrays, or tensors on any
device and of any float type, bf16 included), flattens them in float64 and
returns a Python float.  Ties are handled as the JAX package does:
:func:`rankdata` averages the ranks of a tie group, :func:`topk_overlap`
takes ``np.argpartition``'s pick among values tied at the k-th.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flat(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64).reshape(-1)


def rankdata(a: np.ndarray) -> np.ndarray:
    """Ranks (1-based) with ties averaged — scipy-free ``rankdata``."""
    order = np.argsort(a, kind="stable")
    ranks = np.empty(a.size, np.float64)
    ranks[order] = np.arange(1, a.size + 1)
    sa = a[order]
    _, start, counts = np.unique(sa, return_index=True, return_counts=True)
    for s, c in zip(start, counts):
        if c > 1:
            ranks[order[s:s + c]] = ranks[order[s:s + c]].mean()
    return ranks


def spearman(a, b) -> float:
    """Spearman rank correlation in [-1, 1] (ties averaged)."""
    ra, rb = rankdata(_flat(a)), rankdata(_flat(b))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    if denom == 0.0:
        return 1.0 if np.array_equal(ra, rb) else 0.0
    return float((ra * rb).sum() / denom)


def topk_overlap(a, b, k: int) -> float:
    """|top-k(a) ∩ top-k(b)| / k — do the two maps highlight the same
    pixels?"""
    fa, fb = _flat(a), _flat(b)
    ta = set(np.argpartition(-fa, k - 1)[:k].tolist())
    tb = set(np.argpartition(-fb, k - 1)[:k].tolist())
    return len(ta & tb) / k


def sign_agreement(a, b) -> float:
    """Fraction of elements whose sign matches (zeros must match zeros)."""
    fa, fb = np.sign(_flat(a)), np.sign(_flat(b))
    return float((fa == fb).mean())


def compare(a, b, *, k: int = 32) -> Dict[str, float]:
    """All three metrics at once."""
    return {"spearman": spearman(a, b),
            "topk_overlap": topk_overlap(a, b, k),
            "sign_agreement": sign_agreement(a, b)}
