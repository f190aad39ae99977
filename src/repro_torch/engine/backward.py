"""The backend protocol behind every attribution method.

The paper's accelerator has two phases: a forward pass that stores
bit-packed rectifier state, and a seed-driven backward pass replayed over
that state:

  * ``forward(x) -> (logits, residuals)``;
  * ``backward(residuals, seeds) -> rel``, ``seeds`` [S, *logits.shape], so
    K classes replay in ONE launch per layer sharing the stored residuals.

:class:`ManualSeedBatchedBackward` wraps the explicit closure pair of
:meth:`repro_torch.engine.spec.CNNModel.pair`.  PyTorch runs eagerly, so
there is no compile step to do once (the JAX package jits here).
"""
from __future__ import annotations

from typing import Callable


class ManualSeedBatchedBackward:
    """The explicit seed-batched pair (fused kernels).  Its residuals are
    bit-packed masks, replayable without the input."""

    def __init__(self, forward_fn: Callable, backward_fn: Callable):
        self.forward = forward_fn
        self.backward = backward_fn

    def __repr__(self):
        return "<ManualSeedBatchedBackward>"
