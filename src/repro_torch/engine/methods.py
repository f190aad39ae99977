"""Attribution method math — the paper's FP+BP dataflow (§II, Fig. 2), as
``repro.engine.methods`` has it.

Attribution is one forward pass plus one backward pass that carries
*activation* gradients from the chosen output logit back to the input,
with the parameters closed over and no weight gradient: autograd through
the rule-bound model (:func:`repro_torch.engine.backward.vjp`), where the
rules' Functions save only bit-packed masks.  :class:`repro_torch.engine.
Engine` binds these functions to its model.

Every entry point takes an optional ``backward=``: the MANUAL seed-batched
engine, where ``f(x)`` returns ``(logits, residuals)`` and
``backward(residuals, seeds)`` replays the BP over the stored masks, seeds
carrying a leading S axis.  That is how the true-int16 ``fxp16`` path runs
(integers have no gradient) and how a cache replays explanations without
the forward.  Inputs are tensors (the JAX package also takes pytrees);
the token methods come with the LM stack (ROADMAP A11).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.engine.backward import vjp

METHODS = ("saliency", "deconvnet", "guided")


def one_hot(idx: torch.Tensor, nc: int, like: torch.Tensor) -> torch.Tensor:
    """One-hot rows of ``like``'s dtype and device, by scatter (no host
    sync, unlike ``F.one_hot``'s range check on the card)."""
    out = torch.zeros(idx.shape + (nc,), dtype=like.dtype,
                      device=like.device)
    return out.scatter_(-1, idx[..., None], 1.0)


def output_seed(logits: torch.Tensor, target=None) -> torch.Tensor:
    """One-hot seed at the explained logit, shaped like ``logits``.

    ``target``: ints broadcastable to ``logits.shape[:-1]``, or None for the
    argmax class (the paper's "maximum output value at the last layer",
    §III.F).
    """
    if target is None:
        target = torch.argmax(logits, dim=-1)
    target = torch.as_tensor(target, device=logits.device).to(torch.int64)
    return one_hot(target.broadcast_to(logits.shape[:-1]),
                    logits.shape[-1], logits)


def _class_seeds(targets, logits):
    """[K] class ids -> seeds [K, *logits.shape]."""
    targets = torch.as_tensor(targets, device=logits.device).to(torch.int64)
    seeds = one_hot(targets, logits.shape[-1], logits)
    return seeds[:, None, :].expand((seeds.shape[0],) + logits.shape)


def attribute(f: Callable, x: torch.Tensor, *, target=None,
              return_logits: bool = True, backward=None):
    """Relevance of every element of ``x`` for the target logit of ``f(x)``.

    ``f`` has the attribution method bound.  ``backward`` selects the
    manual engine: ``f(x)`` then returns ``(logits, residuals)``.
    """
    if backward is not None:
        logits, residuals = f(x)
        rel = backward(residuals, output_seed(logits, target)[None])[0]
    else:
        logits, vjp_fn = vjp(f, x)
        rel = vjp_fn(output_seed(logits, target)[None])[0]
    return (logits, rel) if return_logits else rel


def attribute_classes(f: Callable, x: torch.Tensor, targets, *,
                      backward=None):
    """Relevance maps for the classes ``targets`` [K] from ONE forward:
    ``-> (logits, rel [K, ...])``.

    Default: one forward with grad, then K backward passes over it.  With
    ``backward`` (``f`` returning ``(logits, residuals)``): all K seeds in
    one seed-batched backward, every stored mask shared.
    """
    if backward is not None:
        logits, residuals = f(x)
        return logits, backward(residuals, _class_seeds(targets, logits))
    logits, vjp_fn = vjp(f, x)
    return logits, vjp_fn(_class_seeds(targets, logits))


def contrastive(f: Callable, x: torch.Tensor, target_a, target_b, *,
                backward=None):
    """Why class A rather than class B? — one BP seeded with e_A - e_B
    (gradient backprop is linear in the seed)."""
    if backward is not None:
        logits, residuals = f(x)
    else:
        logits, vjp_fn = vjp(f, x)
    seed = output_seed(logits, target_a) - output_seed(logits, target_b)
    if backward is not None:
        rel = backward(residuals, seed[None])[0]
    else:
        rel = vjp_fn(seed[None])[0]
    return logits, rel


def input_x_gradient(f: Callable, x: torch.Tensor, *, target=None,
                     backward=None):
    """Gradient . input — sign-aware refinement of the saliency map."""
    logits, rel = attribute(f, x, target=target, backward=backward)
    return logits, rel * x


def fold_batched_gradients(f: Callable, xs: torch.Tensor, target,
                           batch_shape, backward=None):
    """Saliency over S perturbed inputs ``xs [S, B, ...]`` in ONE FP+BP:
    the S axis folds into the batch (``[S*B, ...]``), so the stack shares
    one kernel launch per layer.  ``target`` broadcasts to ``batch_shape``
    (``logits.shape[:-1]`` of one un-stacked call).  Returns ``[S, B, ...]``.
    """
    s = xs.shape[0]
    folded = xs.reshape((s * xs.shape[1],) + tuple(xs.shape[2:]))
    batch_shape = tuple(batch_shape)
    tgt = torch.as_tensor(target, device=xs.device).broadcast_to(batch_shape)
    tgt = tgt[None].broadcast_to((s,) + batch_shape)
    tgt = tgt.reshape((s * batch_shape[0],) + batch_shape[1:])
    grads = attribute(f, folded, target=tgt, return_logits=False,
                      backward=backward)
    return grads.reshape((s, grads.shape[0] // s) + tuple(grads.shape[1:]))


def _stacked_gradients(f, xs, target, batch_shape, batched: bool,
                       backward=None):
    """A perturbation stack through the folded or the sequential form."""
    if batched:
        return fold_batched_gradients(f, xs, target, batch_shape, backward)
    return torch.stack([attribute(f, xa, target=target, return_logits=False,
                                  backward=backward) for xa in xs])


def _probe_logits(f: Callable, x, backward):
    """One forward without grad — under the manual engine ``f`` returns a
    pair."""
    with torch.no_grad():
        out = f(x)
    return out[0] if backward is not None else out


def integrated_gradients(f: Callable, x: torch.Tensor, *, baseline=None,
                         steps: int = 16, target=None, batched: bool = True,
                         backward=None):
    """Sundararajan et al. 2017 — Riemann sum (midpoints) of saliency along
    the straight path from ``baseline`` (zeros) to ``x``.  ``batched`` folds
    the steps axis into the batch: one FP+BP over ``[steps*B, ...]``."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    logits = _probe_logits(f, x, backward)
    if target is None:
        target = torch.argmax(logits, dim=-1)
    alphas = (torch.arange(steps, dtype=torch.float32, device=x.device)
              + 0.5) / steps
    alphas = alphas.reshape((steps,) + (1,) * x.dim())
    xs = (baseline + alphas * (x - baseline)).to(x.dtype)
    grads = _stacked_gradients(f, xs, target, logits.shape[:-1], batched,
                               backward)
    return logits, grads.mean(dim=0) * (x - baseline)


def smoothgrad(f: Callable, x: torch.Tensor, generator: torch.Generator, *,
               n: int = 8, sigma: float = 0.1, target=None,
               batched: bool = True, backward=None):
    """Smilkov et al. 2017 — saliency averaged over ``n`` Gaussian-perturbed
    inputs.  The noise comes from ``generator`` (on its own device, then
    moved to ``x``'s); the JAX key stream cannot be reproduced, so tests
    hold the method to the reference through :func:`fold_batched_gradients`
    on shared noise."""
    logits = _probe_logits(f, x, backward)
    if target is None:
        target = torch.argmax(logits, dim=-1)
    noise = torch.randn((n,) + tuple(x.shape), generator=generator,
                        device=generator.device, dtype=x.dtype)
    xs = x + sigma * noise.to(x.device)
    grads = _stacked_gradients(f, xs, target, logits.shape[:-1], batched,
                               backward)
    return logits, grads.mean(dim=0)


def _heatmap_leaf(rel: torch.Tensor, absolute: bool) -> torch.Tensor:
    r = rel.abs() if absolute else rel
    if r.dim() >= 3:           # NHWC -> NHW
        r = r.sum(dim=-1)
    dims = tuple(range(1, r.dim()))
    lo = r.amin(dim=dims, keepdim=True)
    hi = r.amax(dim=dims, keepdim=True)
    return (r - lo) / torch.clamp_min(hi - lo, 1e-12)


def heatmap(rel, *, absolute: bool = True):
    """Collapse relevance to per-example [H, W] heatmaps in [0, 1]; a dict
    of relevance tensors maps leaf by leaf."""
    if isinstance(rel, dict):
        return {k: _heatmap_leaf(v, absolute) for k, v in rel.items()}
    return _heatmap_leaf(rel, absolute)
