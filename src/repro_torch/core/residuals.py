"""Residual-memory accounting: the paper's §V "Software" claim, as
``repro.core.residuals`` states it, and the bits the port actually stores.

For the Table III CNN the paper compares autodiff-style activation caching
(every intermediate activation at fp32: **3.4 Mb**) with its analytic BP,
which keeps only the 2-bit max-pool indices (8192 + 4096 windows) and the
one listed FC ReLU's 128-bit mask: ``(8192 + 4096) * 2 + 128 = 24_704``
bits, **24.7 Kb**, a **137x** cut.

:class:`Ledger` computes both sides from the shapes of one forward pass
(batch 1); :func:`paper_cnn_ledger` is the paper's Table III reading,
:func:`cnn_ledger` the same accounting for any ``CNNConfig`` (its conv
ReLUs too), and :func:`residual_bits` counts the bits of a residual dict of
``models.cnn.forward_with_residuals``, the packed tensors themselves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Ledger:
    """Shapes of every residual-bearing site in one forward pass (batch=1)."""
    activations: List[Tuple[int, ...]] = field(default_factory=list)
    relu_sites: List[Tuple[int, ...]] = field(default_factory=list)
    pool_sites: List[Tuple[int, ...]] = field(default_factory=list)
    smooth_sites: List[Tuple[int, ...]] = field(default_factory=list)

    @staticmethod
    def _n(shape) -> int:
        return int(np.prod(shape))

    # -- software baseline: cache every activation ------------------------
    def autodiff_bits(self, act_bits: int = 32) -> int:
        return sum(self._n(s) for s in self.activations) * act_bits

    # -- the paper's analytic policy (Table II) ----------------------------
    def analytic_bits(self, method: str = "saliency",
                      smooth_residual_bits: int = 8) -> int:
        bits = 0
        if method in ("saliency", "guided"):
            bits += sum(self._n(s) for s in self.relu_sites)     # 1 bit/elt
            bits += (sum(self._n(s) for s in self.smooth_sites)
                     * smooth_residual_bits)
        elif method == "deconvnet":
            bits += 0   # Table II: no ReLU mask; gradient-side rule only
        else:
            raise ValueError(method)
        bits += sum(self._n(s) for s in self.pool_sites) * 2     # 2 bit/window
        return bits

    def reduction(self, method: str = "saliency", act_bits: int = 32) -> float:
        a = self.analytic_bits(method)
        return self.autodiff_bits(act_bits) / max(a, 1)


def paper_cnn_ledger() -> Ledger:
    """Ledger for the exact Table III CNN (batch=1, CIFAR-10 input).

    Table III layer rows: Conv, Conv, MaxPool, Conv, Conv, MaxPool, FC,
    ReLU, FC.  The paper's 24.7 Kb figure corresponds to pooling indices
    at both pools plus the single listed ReLU's mask.
    """
    led = Ledger()
    led.activations = [
        (32, 32, 32),   # conv1 out
        (32, 32, 32),   # conv2 out
        (32, 16, 16),   # pool1 out
        (64, 16, 16),   # conv3 out
        (64, 16, 16),   # conv4 out
        (64, 8, 8),     # pool2 out
        (128,),         # fc1 out
        (10,),          # fc2 out
    ]
    led.relu_sites = [(128,)]                      # the one ReLU row
    led.pool_sites = [(32, 16, 16), (64, 8, 8)]    # pooled output shapes
    return led


def cnn_ledger(cfg) -> Ledger:
    """The same accounting for a ``models.cnn.CNNConfig`` (batch 1): every
    conv, pool and FC output cached at fp32 on the autodiff side; a 1-bit
    mask at each conv ReLU (where ``cfg.conv_relu``) and each hidden FC's,
    and 2 bits a pooled window.  ``cnn_ledger(TABLE_III_LITERAL)`` is
    :func:`paper_cnn_ledger`."""
    led = Ledger()
    h, w = cfg.in_hw
    for i, c in enumerate(cfg.channels):
        led.activations.append((c, h, w))
        if cfg.conv_relu:
            led.relu_sites.append((c, h, w))
        if (i + 1) % cfg.pool_every == 0:
            h, w = h // 2, w // 2
            led.activations.append((c, h, w))
            led.pool_sites.append((c, h, w))
    for f in cfg.fc:
        led.activations.append((f,))
        led.relu_sites.append((f,))
    led.activations.append((cfg.num_classes,))
    return led


def residual_bits(residuals) -> int:
    """Bits of the packed tensors of a residual dict
    (``models.cnn.forward_with_residuals``: masks and crumbs, every example
    of the batch); 0 for the sites that store nothing."""
    tensors = [t for pair in residuals["conv"] for t in pair]
    tensors += list(residuals["fc"])
    return sum(8 * t.numel() * t.element_size()
               for t in tensors if t is not None)


def kb(bits: int) -> float:
    return bits / 1e3


def mb(bits: int) -> float:
    return bits / 1e6
