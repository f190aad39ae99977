"""Deterministic synthetic data pipelines, restart-safe by construction: a
copy of ``repro.data.synthetic`` (NumPy only, the same
``SeedSequence([seed, step, host_id])`` draws), so a batch of this package
equals the JAX package's bit for bit.

Every batch is a pure function of (seed, step, host_id), so after a failure
the driver resumes from the checkpointed step with zero data-state to
restore, and elastic re-sharding (host count changes) only re-partitions the
index space.  This is the multi-host pattern real pipelines (tf.data +
checkpointable iterators) approximate; a pure function needs no machinery.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def host_shard_bounds(global_batch: int, host_id: int, n_hosts: int) -> Tuple[int, int]:
    """Contiguous per-host slice of the global batch."""
    per = global_batch // n_hosts
    rem = global_batch % n_hosts
    lo = host_id * per + min(host_id, rem)
    return lo, lo + per + (1 if host_id < rem else 0)


@dataclass(frozen=True)
class TokenStream:
    """Synthetic LM token stream with a learnable structure.

    Tokens follow a noisy order-1 Markov chain (x_{t+1} = (a*x_t + b) % V with
    occasional resets), so cross-entropy genuinely decreases during training
    — enough signal to validate end-to-end optimization without real data.
    """
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> Dict:
        lo, hi = host_shard_bounds(self.global_batch, host_id, n_hosts)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        b = hi - lo
        a = 31 % self.vocab or 1
        c = 17 % self.vocab
        x = np.empty((b, self.seq_len + 1), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, size=b)
        for t in range(self.seq_len):
            nxt = (a * x[:, t] + c) % self.vocab
            flip = rng.random(b) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, size=b), nxt)
            x[:, t + 1] = nxt
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}


@dataclass(frozen=True)
class CifarLikeImages:
    """Class-conditional blob images, NHWC, 10 classes, 32x32x3.

    Class k places a bright gaussian blob at a class-specific location with
    class-specific color — learnable by the paper's CNN in a few hundred
    steps, and the attribution heatmap should light up the blob (the visual
    validation of paper Fig. 3).
    """
    hw: Tuple[int, int] = (32, 32)
    n_classes: int = 10
    seed: int = 0

    def blob_center(self, label: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.hw
        ang = 2 * np.pi * label / self.n_classes
        cy = h / 2 + (h / 3.2) * np.sin(ang)
        cx = w / 2 + (w / 3.2) * np.cos(ang)
        return cy, cx

    def batch_at(self, step: int, batch: int, host_id: int = 0,
                 n_hosts: int = 1) -> Dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 1, step, host_id]))
        h, w = self.hw
        label = rng.integers(0, self.n_classes, size=batch)
        img = rng.normal(0.0, 0.25, size=(batch, h, w, 3)).astype(np.float32)
        cy, cx = self.blob_center(label)
        yy = np.arange(h)[None, :, None]
        xx = np.arange(w)[None, None, :]
        d2 = (yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2
        blob = np.exp(-d2 / (2 * 2.5 ** 2)).astype(np.float32)
        color = np.stack([np.cos(2 * np.pi * label / self.n_classes) * 0.5 + 1.0,
                          np.sin(2 * np.pi * label / self.n_classes) * 0.5 + 1.0,
                          np.ones_like(label, np.float32) * 1.2], axis=-1)
        img += blob[..., None] * color[:, None, None, :].astype(np.float32)
        return {"image": img, "label": label.astype(np.int32)}
