"""The backend protocol behind every attribution method.

The paper's accelerator has two phases: a forward pass that stores
bit-packed rectifier state, and a seed-driven backward pass replayed over
that state:

  * ``forward(x) -> (logits, residuals)``;
  * ``backward(residuals, seeds) -> rel``, ``seeds`` [S, *logits.shape], so
    K classes replay in ONE launch per layer sharing the stored residuals.

:class:`ManualSeedBatchedBackward` wraps the explicit closure pair of
:meth:`repro_torch.engine.spec.CNNModel.pair`.  :class:`VjpBackward`
derives the pair from autograd over a plain ``f(x) -> logits``.  PyTorch
runs eagerly, so there is no compile step to do once (the JAX package jits
here).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def vjp(f: Callable, x: torch.Tensor) -> Tuple[torch.Tensor, Callable]:
    """``jax.vjp`` for a tensor function: one forward of ``f`` with grad,
    returning ``(logits, vjp_fn)``; ``vjp_fn(seeds [S, *logits.shape])``
    returns ``[S, *x.shape]``, one backward pass per seed over the one
    retained graph (K backward passes, no extra forward, as ``jax.vmap`` of
    the vjp does).  The seeds enter in the logits' dtype (bf16 logits take
    bf16 seeds, as a JAX cotangent has its primal's dtype); the result has
    ``x``'s.  The kernels' backward Functions have no vmap rule, so the
    seeds are a loop, not ``is_grads_batched``."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = f(x)

    def vjp_fn(seeds):
        seeds = seeds.to(out.dtype)
        return torch.stack([
            torch.autograd.grad(out, x, seed, retain_graph=True)[0]
            for seed in seeds])

    return out.detach(), vjp_fn


class ManualSeedBatchedBackward:
    """The explicit seed-batched pair (fused kernels).  Its residuals are
    bit-packed masks, replayable without the input."""

    supports_replay = True

    def __init__(self, forward_fn: Callable, backward_fn: Callable):
        self.forward = forward_fn
        self.backward = backward_fn

    def __repr__(self):
        return "<ManualSeedBatchedBackward>"


class VjpBackward:
    """Autograd-derived pair over a plain ``f(x) -> logits``.

    ``forward`` returns the input as the residual; ``backward`` runs the
    forward again with grad, then one backward pass per seed.  The backend
    of every differentiable model without a manual pair (the reference CNN
    path, ``FnModel``), and the reference the manual pair is tested against.
    """

    supports_replay = False

    def __init__(self, f: Callable):
        self.f = f

    def forward(self, x):
        with torch.no_grad():
            return self.f(x), x

    def backward(self, x, seeds):
        _, vjp_fn = vjp(self.f, x)
        return vjp_fn(seeds)

    def __repr__(self):
        return f"<VjpBackward f={self.f!r}>"
