"""The LM backbone of the zoo, as ``repro.models.transformer`` — mamba
segments only (falcon-mamba-7b).

Layers are grouped into homogeneous segments (``cfg.layer_plan()``) whose
parameters carry a leading layer axis, the JAX package's tree exactly
(``params_from_jax`` is a copy); :func:`_run_segments` walks each segment's
layers in a Python loop where the JAX package runs ``lax.scan``.  Any block
kind other than ``"mamba"``, an encoder or a modality frontend raises
:class:`NotImplementedError` naming ROADMAP A11b.

Entry points:
  init(cfg, generator=, device=)                    -> params
  forward(params, cfg, batch, method=...)           -> (logits, aux)
  forward_from_embeddings(params, cfg, h, ...)      -> (logits, aux)
  init_cache(cfg, batch, capacity, device=)         -> cache
  prefill(params, cfg, batch, cache)                -> (logits, cache)
  decode_step(params, cfg, tokens, cache, pos)      -> (logits, cache)

Mamba caches are O(1) per layer: the f32 state ``h`` and the conv window.
The JAX package's ``remat`` and ``triangle_skip`` knobs (checkpointing and
attention) have nothing to act on here and are not taken.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.engine.spec import resolve_device
from repro_torch.models import layers, mamba
from repro_torch.models.config import ModelConfig

_A11B = "ROADMAP A11b"


def _check_ported(cfg: ModelConfig) -> None:
    for kind, _, _ in cfg.layer_plan():
        if kind != "mamba":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"({_A11B}: attention, RoPE, FFN, MoE, hybrid)")
    if cfg.enc_layers:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder stacks are "
                                  f"not ported yet ({_A11B})")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} "
                                  f"is not ported yet ({_A11B})")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _init_segment(gen, cfg, count: int) -> dict:
    """``count`` mamba blocks stacked on a leading layer axis, filled layer
    by layer (one layer's draws beside the stack, never two stacks)."""
    first = {"norm1": layers.norm_init(cfg.d_model, cfg.norm, gen.device),
             "mixer": mamba.init_mamba(gen, cfg)}
    seg = _tree_map(lambda t: t.new_empty((count,) + tuple(t.shape)), first)
    for i in range(count):
        blk = first if i == 0 else {
            "norm1": layers.norm_init(cfg.d_model, cfg.norm, gen.device),
            "mixer": mamba.init_mamba(gen, cfg)}
        _tree_map2(lambda dst, src, i=i: dst[i].copy_(src), seg, blk)
    return seg


def init(cfg: ModelConfig, *, generator: torch.Generator = None,
         device=None) -> Dict:
    """Random parameters on ``device`` (None: the card), drawn from
    ``generator`` (default: seed 0 on that device), which must live there.
    Matrices in the config's dtype; norms, ``A_log``, ``D`` and
    ``dt_bias`` in f32."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    params = {"embed": layers.init_embed(gen, cfg),
              "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dev)}
    params["segments"] = [_init_segment(gen, cfg, count)
                          for _, count, _ in cfg.layer_plan()]
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_map2(fn, a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _tree_map2(fn, x, y)
    else:
        fn(a, b)


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(params_np, device="cpu") -> Dict:
    """The JAX package's params tree (leaves as NumPy arrays, bf16 as
    ``ml_dtypes.bfloat16``) -> this package's: the same tree, per-segment
    leading layer axis included, bit for bit."""
    return _tree_map(lambda a: _from_numpy(a, device), params_np)


def params_to(params, device) -> Dict:
    """Params tree moved to ``device`` (no copy where already there)."""
    return _tree_map(lambda t: t.to(device), params)


def device_of(params) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# one layer, the stack
# ---------------------------------------------------------------------------


def _block(p, x, cfg, kind: str, *, method: str, cache=None, pos=None,
           scan_tile=None):
    """One layer. Returns (x, new_cache_slice)."""
    if kind != "mamba":
        raise NotImplementedError(f"block kind {kind!r} ({_A11B})")
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    out, new_state = mamba.mamba_core(p["mixer"], h, cfg, method,
                                      state=cache, pos=pos,
                                      scan_tile=scan_tile)
    return x + out, new_state


def _layer(tree, i):
    return _tree_map(lambda t: t[i], tree)


def _run_segments(params, cfg, x, *, method, caches=None, pos=None,
                  scan_tiles=None):
    """Walk each segment's layers; returns (x, new_caches | None).

    ``scan_tiles`` is an optional per-SEGMENT dict ``{si: (d_tile,
    chunk)}`` routing that segment's scans through the B13 kernel.
    """
    _check_ported(cfg)
    new_caches = [] if caches is not None else None
    for si, (kind, count, _) in enumerate(cfg.layer_plan()):
        seg_p = params["segments"][si]
        seg_c = caches[si] if caches is not None else None
        tile = scan_tiles.get(si) if scan_tiles else None
        states = []
        for i in range(count):
            x, nc = _block(_layer(seg_p, i), x, cfg, kind, method=method,
                           cache=_layer(seg_c, i) if seg_c else None,
                           pos=pos, scan_tile=tile)
            states.append(nc)
        if new_caches is not None:
            new_caches.append({k: torch.stack([st[k] for st in states])
                               for k in states[0]})
    return x, new_caches


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch: Dict, method="autodiff"):
    """``{"tokens": [B, S]} -> [B, S, d]`` embeddings."""
    _check_ported(cfg)
    return layers.embed(params["embed"], batch["tokens"], cfg)


def forward_from_embeddings(params, cfg: ModelConfig, h, *,
                            method="autodiff", scan_tiles=None):
    """Backbone from embeddings -> (logits [B,S,vocab] f32, aux).  The
    attribution entry.  ``scan_tiles`` routes the mamba segments through
    the B13 kernel (``{segment: (d_tile, chunk)}``); None keeps the chunked
    scan.  ``aux`` is the JAX package's MoE loss slot, 0 here."""
    x, _ = _run_segments(params, cfg, h.to(cfg.torch_dtype), method=method,
                         scan_tiles=scan_tiles)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = layers.lm_head(params["embed"], x, cfg)
    return logits, torch.zeros((), device=logits.device)


def forward(params, cfg: ModelConfig, batch: Dict, *, method="autodiff"):
    """Training/eval forward: (logits, aux)."""
    h = embed_inputs(params, cfg, batch, method)
    return forward_from_embeddings(params, cfg, h, method=method)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               src_len: int = 0, *, device=None):
    """Per-segment cache (f32 ssm state, conv window in the config's
    dtype) on ``device`` (None: the card).  ``capacity`` sizes attention
    caches, which mamba has none of."""
    _check_ported(cfg)
    dev = resolve_device(device)
    caches = []
    for _, count, _ in cfg.layer_plan():
        caches.append({
            "h": torch.zeros((count, batch, cfg.d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((count, batch, cfg.ssm_conv - 1,
                                 cfg.d_inner), dtype=cfg.torch_dtype,
                                device=dev),
        })
    return caches


def prefill(params, cfg: ModelConfig, batch: Dict, cache, *,
            method="autodiff"):
    """Fill caches from a full prompt; returns (last-position logits
    [B, 1, vocab], cache)."""
    h = embed_inputs(params, cfg, batch, method).to(cfg.torch_dtype)
    x, new_caches = _run_segments(params, cfg, h, method=method,
                                  caches=cache)
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return layers.lm_head(params["embed"], x, cfg), new_caches


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *,
                method="autodiff"):
    """One decode step: tokens [B, 1] at position ``pos``."""
    h = layers.embed(params["embed"], tokens, cfg)
    x, new_caches = _run_segments(params, cfg, h, method=method,
                                  caches=cache, pos=pos)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x, cfg), new_caches
