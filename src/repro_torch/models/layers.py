"""Shared building blocks of the LM zoo, as far as the mamba stack calls
them (``repro.models.layers``): initializers, RMS/layer norm, the token
embedding and the LM head.  Attention, RoPE and the FFN come with
ROADMAP A11b.

Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` on the device the parameters live on.
"""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 on ``gen``'s device, then cast;
    ``scale`` defaults to ``sqrt(2 / (d_in + d_out))``."""
    s = scale if scale is not None else (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * s).to(dtype)


def norm_init(d: int, kind: str, device) -> dict:
    if kind == "layernorm":
        return {"w": torch.ones(d, device=device),
                "b": torch.zeros(d, device=device)}
    return {"w": torch.ones(d, device=device)}


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm (or layer norm) computed in f32, output in ``x``'s dtype."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["w"]
    return y.to(x.dtype)


def init_embed(gen: torch.Generator, cfg) -> dict:
    """Token table ``[padded_vocab, d]`` (and an untied head ``[d,
    padded_vocab]``) in the config's dtype."""
    v = cfg.padded_vocab
    p = {"table": dense_init(gen, v, cfg.d_model, cfg.torch_dtype,
                             scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, v, cfg.torch_dtype)
    return p


def embed(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token lookup ``[B, S] -> [B, S, d]`` (the JAX package's no-mesh
    ``take``)."""
    return p["table"][tokens]


class _GradCast(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the primal's dtype:
    the f32 logits otherwise send an f32 cotangent down a bf16 residual
    stream."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _grad_cast(x: torch.Tensor) -> torch.Tensor:
    return _GradCast.apply(x)


def lm_head(p, h: torch.Tensor, cfg) -> torch.Tensor:
    """``[B, S, d] -> f32 logits [B, S, vocab]``.

    The JAX package contracts bf16 operands with an f32 result
    (``preferred_element_type``); a bf16 ``torch.matmul`` would round the
    logits to bf16, so the operands are widened to f32 (exact) and
    multiplied in f32, with TF32 off as the port runs everywhere.
    """
    h = _grad_cast(h).to(torch.float32)
    if cfg.tie_embeddings:
        logits = h @ p["table"].to(torch.float32).T
    else:
        logits = h @ p["head"].to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:
        logits = logits[..., :cfg.vocab]
    return logits
