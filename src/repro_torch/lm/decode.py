"""Step-wise LM generation with per-generated-token attribution, as
``repro.lm.decode``.

Generate token by token (prefill, then decode steps over the cached keys,
values and mamba states), remembering per step what was picked and what
the runner-up was; then explain every generated token with one FP +
input-gradient BP over the final sequence.  The stack is causal, so the
seed at position ``p`` sends gradient only to positions ``<= p``: one
attribution step over the final sequence serves every generated token,
and the scores after the seed are exactly zero.  The per-token
contrastive mode ("why this token rather than the runner-up?") is a
single ``e_A - e_B`` seed.

Sampling draws from a ``torch.Generator`` (on the logits' device); its
stream is not JAX's, so only greedy decoding is reproducible against the
JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.engine import methods as engine_methods
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tf

TOKEN_MODES = steps_lib.TOKEN_MODES


@dataclass(frozen=True)
class DecodeResult:
    """One finished generation: the full sequence plus what attribution
    needs to explain each generated token."""

    tokens: torch.Tensor       # [B, prompt_len + T] int64, prompt included
    runners_up: torch.Tensor   # [B, T] int64: per-step second-best token
    prompt_len: int

    @property
    def generated(self) -> torch.Tensor:
        """The picked continuation [B, T]."""
        return self.tokens[:, self.prompt_len:]


def _pick(logits, temperature, generator, greedy: bool):
    """Next token (argmax, or a draw from ``softmax(logits / T)``) and the
    runner-up: the best token that is not the picked one.  ``logits``:
    [B, V].  Greedy ties go to the lower index, as ``lax.top_k`` orders
    them."""
    lg = logits.to(torch.float32)
    idx2 = engine_methods.top_k(lg, 2)
    if greedy:
        nxt = idx2[:, 0]
    else:
        probs = torch.softmax(lg / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    runner = torch.where(nxt == idx2[:, 0], idx2[:, 1], idx2[:, 0])
    return nxt, runner


@torch.no_grad()
def decode(params, cfg, prompt_tokens, *, max_new: int,
           temperature: float = 0.0, generator: torch.Generator = None,
           triangle_skip: bool = True) -> DecodeResult:
    """Generate ``max_new`` tokens step-wise; returns a :class:`DecodeResult`.

    ``temperature <= 0`` (or no ``generator``) decodes greedily; otherwise
    each step samples from ``softmax(logits / temperature)`` with
    ``generator``, which must live on the params' device.  The prompt
    moves to that device.  Any arch, tokens only (no frames, no patches),
    as the JAX package's ``decode``.
    """
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    device = tf.device_of(params)
    prompt = torch.as_tensor(prompt_tokens).to(device, torch.int64)
    b, s0 = prompt.shape
    greedy = temperature <= 0.0 or generator is None

    cache = tf.init_cache(cfg, b, s0 + max_new + 8, device=device)
    logits, cache = tf.prefill(params, cfg, {"tokens": prompt}, cache,
                               triangle_skip=triangle_skip)
    nxt, runner = _pick(logits[:, -1, :], temperature, generator, greedy)
    toks, runners = [nxt], [runner]
    for t in range(1, max_new):
        logits, cache = tf.decode_step(params, cfg, nxt[:, None], cache,
                                       s0 + t - 1)
        nxt, runner = _pick(logits[:, -1, :], temperature, generator,
                            greedy)
        toks.append(nxt)
        runners.append(runner)
    return DecodeResult(
        tokens=torch.cat([prompt, torch.stack(toks, dim=1)], dim=1),
        runners_up=torch.stack(runners, dim=1), prompt_len=s0)


def make_token_explain(cfg, method: str = "saliency", *,
                       mode: str = "contrastive", plan=None,
                       triangle_skip: bool = True):
    """One per-token attribution step for ``cfg``: ``(params, tokens
    [B, S], position, target_a, target_b, frames=None) -> scores [B, S]``.
    Causality makes this one step right for every generated position;
    ``target_b`` is ignored outside ``mode="contrastive"``; ``frames``
    feed an encoder-decoder's encoder.  The mamba and hybrid segments run
    the B13 kernel with ``plan``'s knobs (``steps.ssm_scan_tiles``; None:
    the unplanned launch)."""
    if mode not in TOKEN_MODES:
        raise ValueError(f"mode={mode!r} not in {TOKEN_MODES}")
    tiles = steps_lib.ssm_scan_tiles(cfg, plan)

    def explain(params, tokens, position, target_a, target_b, frames=None):
        h = tf.embed_inputs(params, cfg, {"tokens": tokens})

        def f(e):
            return tf.forward_from_embeddings(
                params, cfg, e, method=method, enc_frames=frames,
                triangle_skip=triangle_skip, scan_tiles=tiles)[0]

        if mode == "contrastive":
            _, _, scores = engine_methods.attribute_tokens_contrastive(
                f, h, position=position, target_a=target_a,
                target_b=target_b)
        else:
            _, rel, scores = engine_methods.attribute_tokens(
                f, h, position=position, target=target_a)
            if mode == "grad_norm":
                scores = rel.float().norm(dim=-1)
        return scores

    return explain


def explain_generated(params, cfg, result: DecodeResult, *,
                      method: str = "saliency",
                      mode: str = "contrastive",
                      plan=None, triangle_skip: bool = True,
                      frames=None) -> torch.Tensor:
    """Per-generated-token attribution over a finished decode.

    For generated token ``t`` the seed sits at the position whose logits
    produced it (``prompt_len - 1 + t``); in the contrastive mode
    ``target_a`` is the picked token and ``target_b`` its recorded
    runner-up.  Returns scores ``[B, T, S]`` (S: the full sequence;
    positions after the seed are exactly zero by causality).  ``plan``: a
    ``plan_lm`` TilePlan for the scan's knobs (None: unplanned);
    ``frames``: an encoder-decoder's source frames.
    """
    step = make_token_explain(cfg, method, mode=mode, plan=plan,
                              triangle_skip=triangle_skip)
    s0 = result.prompt_len
    n_gen = result.tokens.shape[1] - s0
    return torch.stack([
        step(params, result.tokens, s0 - 1 + t, result.tokens[:, s0 + t],
             result.runners_up[:, t], frames) for t in range(n_gen)], dim=1)
