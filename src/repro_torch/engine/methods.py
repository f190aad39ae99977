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
the forward.  Inputs are tensors (the JAX package also takes pytrees).

The token methods (:func:`attribute_tokens`,
:func:`attribute_tokens_contrastive`) explain one position of an LM's
logits over its input embeddings; their ``backward=`` (the manual engine
of an fxp16 token stack) is not ported (ROADMAP A11b).
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


def top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest logits per row, in ``lax.top_k``'s
    order: descending in IEEE total order (+0 above -0), ties to the lower
    index.  ``torch.topk`` keeps no tie order, and ties are common on the
    fxp16 logits grid.  The f32 bits are mapped to int32 keys that sort in
    total order, then sorted stably."""
    bits = logits.to(torch.float32).contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    order = torch.sort(key, dim=-1, descending=True, stable=True)
    return order.indices[..., :k]


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


def _no_manual_token_backward(backward):
    if backward is not None:
        raise NotImplementedError(
            "backward= (the manual engine of an fxp16 token stack) is not "
            "ported yet (ROADMAP A11b); token methods run autograd")


def _token_seed(logits, position, seed_at):
    """Zeros shaped like ``logits`` [B, S, V] with ``seed_at`` [B, V] at
    ``position``."""
    seed = torch.zeros_like(logits)
    seed[:, position, :] = seed_at
    return seed


def _token_ids(t, at):
    """Token ids (ints, a tensor or an array) as int64 [B] on ``at``'s
    device."""
    return torch.as_tensor(t, device=at.device).to(torch.int64).broadcast_to(
        at.shape[:-1])


def _token_scores(rel, embeds):
    """The input-x-gradient reduction per token: ``sum_d rel * embed``."""
    return (rel.to(torch.float32) * embeds.to(torch.float32)).sum(dim=-1)


def attribute_tokens(f: Callable, embeds: torch.Tensor, *, position=-1,
                     target=None, backward=None):
    """LM attribution: relevance of input embeddings for one output token.

    ``f(embeds) -> logits [B, S, V]``.  Explains the logit of ``target``
    (or the argmax) at ``position``.  Returns (logits, relevance [B, S, D],
    per-token scores [B, S]) with scores = sum_d rel * embed (the "input x
    gradient" reduction).
    """
    _no_manual_token_backward(backward)
    logits, vjp_fn = vjp(f, embeds)
    at = logits[:, position, :]
    if target is None:
        target = torch.argmax(at, dim=-1)
    seed_at = one_hot(_token_ids(target, at), at.shape[-1], at)
    rel = vjp_fn(_token_seed(logits, position, seed_at)[None])[0]
    return logits, rel, _token_scores(rel, embeds)


def attribute_tokens_contrastive(f: Callable, embeds: torch.Tensor, *,
                                 position=-1, target_a=None, target_b=None,
                                 backward=None):
    """Token-level "why A rather than B?" — one BP with an e_A - e_B seed.

    Defaults: ``target_a`` is the argmax at ``position`` and ``target_b``
    the runner-up (``lax.top_k``'s tie order, :func:`top_k`); a given
    ``target_a`` (a sampled token) takes as ``target_b`` the top-2
    candidate that is not it.  Returns (logits, relevance, scores) as
    :func:`attribute_tokens`; by linearity of the BP in the seed the scores
    equal the difference of two single-target calls.
    """
    _no_manual_token_backward(backward)
    logits, vjp_fn = vjp(f, embeds)
    at = logits[:, position, :]
    idx2 = top_k(at, 2)
    target_a = _token_ids(idx2[:, 0] if target_a is None else target_a, at)
    if target_b is None:
        target_b = torch.where(target_a == idx2[:, 0], idx2[:, 1],
                               idx2[:, 0])
    target_b = _token_ids(target_b, at)
    seed_at = (one_hot(target_a, at.shape[-1], at)
               - one_hot(target_b, at.shape[-1], at))
    rel = vjp_fn(_token_seed(logits, position, seed_at)[None])[0]
    return logits, rel, _token_scores(rel, embeds)


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


def _noise(generator, n: int, x: torch.Tensor) -> torch.Tensor:
    """``[n, *x.shape]`` standard normal noise: from one generator, or, for
    a sequence of ``B`` generators, example ``i``'s ``[n, *x.shape[1:]]``
    from generator ``i`` (so a row's draw does not depend on its batch)."""
    def draw(gen, shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=x.dtype).to(x.device)

    if isinstance(generator, torch.Generator):
        return draw(generator, (n,) + tuple(x.shape))
    if len(generator) != x.shape[0]:
        raise ValueError(f"{len(generator)} generators for a batch of "
                         f"{x.shape[0]}")
    row = (n,) + tuple(x.shape[1:])
    return torch.stack([draw(g, row) for g in generator], dim=1)


def smoothgrad(f: Callable, x: torch.Tensor, generator, *, n: int = 8,
               sigma: float = 0.1, target=None, batched: bool = True,
               backward=None):
    """Smilkov et al. 2017 — saliency averaged over ``n`` Gaussian-perturbed
    inputs.  The noise comes from ``generator`` (on its own device, then
    moved to ``x``'s), or from a sequence of one generator per example
    (the serve layer's per-request seeds, as the JAX package folds a stack
    of per-example keys): each example then draws its own noise, whatever
    shares its batch.  The JAX key stream cannot be reproduced, so tests
    hold the method to the reference through :func:`fold_batched_gradients`
    on shared noise."""
    logits = _probe_logits(f, x, backward)
    if target is None:
        target = torch.argmax(logits, dim=-1)
    xs = x + sigma * _noise(generator, n, x)
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
