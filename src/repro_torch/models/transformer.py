"""The LM backbone of the zoo, as ``repro.models.transformer``: every block
kind (dense attention + FFN, attention + MoE, mamba, hybrid attention ||
SSM), the encoder stack of the encoder-decoder (audio) configs and the
patch prefix of the vlm configs.

Layers are grouped into homogeneous segments (``cfg.layer_plan()``) whose
parameters carry a leading layer axis, the JAX package's tree exactly
(``params_from_jax`` is a copy); :func:`_run_segments` walks each segment's
layers in a Python loop where the JAX package runs ``lax.scan``.

Entry points:
  init(cfg, generator=, device=)                    -> params
  forward(params, cfg, batch, method=...)           -> (logits, aux)
  forward_from_embeddings(params, cfg, h, ...)      -> (logits, aux)
  init_cache(cfg, batch, capacity, src_len, device=) -> cache
  prefill(params, cfg, batch, cache)                -> (logits, cache)
  decode_step(params, cfg, tokens, cache, pos)      -> (logits, cache)

Caches are per-segment trees with a leading layer axis: fused
``[B, T, Kv*hd]`` keys and values (``ck`` / ``cv``: the encoder's
projected keys and values, cached once at prefill), the mamba layers' f32
state ``h`` and conv window; a hybrid segment holds ``{"attn", "ssm"}``.
The JAX package's ``remat`` knob (checkpointing) has nothing to act on
here and is not taken.

Under an active mesh whose "model" axis has several ranks every entry
point runs on the rank's parameter slices (``dist.params.shard_params``)
and caches (``init_cache(..., mesh=)``); the layers do the model-axis
collectives (``models/layers.py``, ``mamba.py``, ``moe.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.dist import sharding as shd
from repro_torch.engine.spec import resolve_device
from repro_torch.models import layers, mamba, moe
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves, tree_map

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _init_block(gen, cfg: ModelConfig, kind: str, cross: bool = False):
    dev = gen.device
    p = {"norm1": layers.norm_init(cfg.d_model, cfg.norm, dev)}
    if kind == "mamba":
        p["mixer"] = mamba.init_mamba(gen, cfg)
        return p
    p["attn"] = layers.init_attention(gen, cfg)
    if kind == "hybrid":
        p["ssm"] = mamba.init_mamba(gen, cfg)
        p["norm_attn"] = layers.norm_init(cfg.d_model, cfg.norm, dev)
        p["norm_ssm"] = layers.norm_init(cfg.d_model, cfg.norm, dev)
    p["norm2"] = layers.norm_init(cfg.d_model, cfg.norm, dev)
    p["ffn"] = (moe.init_moe(gen, cfg) if kind == "moe"
                else layers.init_ffn(gen, cfg))
    if cross:
        p["cross"] = layers.init_attention(gen, cfg)
        p["norm_cross"] = layers.norm_init(cfg.d_model, cfg.norm, dev)
    return p


def _init_segment(gen, cfg, kind: str, count: int, cross: bool = False):
    """``count`` blocks stacked on a leading layer axis, filled layer by
    layer (one layer's draws beside the stack, never two stacks)."""
    first = _init_block(gen, cfg, kind, cross)
    seg = tree_map(lambda t: t.new_empty((count,) + tuple(t.shape)), first)
    for i in range(count):
        blk = first if i == 0 else _init_block(gen, cfg, kind, cross)
        for dst, src in zip(leaves(seg), leaves(blk)):
            dst[i].copy_(src)
    return seg


def init(cfg: ModelConfig, *, generator: torch.Generator = None,
         device=None) -> Dict:
    """Random parameters on ``device`` (None: the card), drawn from
    ``generator`` (default: seed 0 on that device), which must live there.
    Matrices in the config's dtype; norms, the router, ``A_log``, ``D``
    and ``dt_bias`` in f32."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    params = {"embed": layers.init_embed(gen, cfg),
              "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dev)}
    params["segments"] = [
        _init_segment(gen, cfg, kind, count, cross=cfg.enc_layers > 0)
        for kind, count, _ in cfg.layer_plan()]
    if cfg.enc_layers:
        params["encoder"] = _init_segment(gen, cfg, "dense", cfg.enc_layers)
        params["enc_norm"] = layers.norm_init(cfg.d_model, cfg.norm, dev)
    return params


def _stack(trees):
    """Per-layer trees -> one tree with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(params_np, device="cpu") -> Dict:
    """The JAX package's params tree (leaves as NumPy arrays, bf16 as
    ``ml_dtypes.bfloat16``) -> this package's: the same tree, per-segment
    leading layer axis and encoder included, bit for bit."""
    return tree_map(lambda a: _from_numpy(a, device), params_np)


def params_to(params, device) -> Dict:
    """Params tree moved to ``device`` (no copy where already there)."""
    return tree_map(lambda t: t.to(device), params)


def device_of(params) -> torch.device:
    return params["embed"]["table"].device


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


def _cross_attend(p, x, cfg, cache, enc_out, method):
    """Cross-attention on the encoder's keys and values, projected per
    layer from ``enc_out`` (training, prefill) or read from the cache
    (decode).  Returns (delta_x, (ck, cv))."""
    hc = layers.apply_norm(p["norm_cross"], x, cfg.norm)
    if enc_out is not None:
        src = shd.copy_to_model(enc_out)
        ck, cv = src @ p["cross"]["wk"], src @ p["cross"]["wv"]
    else:
        ck, cv = cache["ck"], cache["cv"]
    c = layers.attention(p["cross"], hc, cfg, rope_cs=None, causal=False,
                         kv_override=(ck, cv), method=method)
    return c, (ck, cv)


def _block(p, x, cfg, kind: str, *, rope_cs=None, window: int = 0,
           method: str = "autodiff", cache=None, pos=None, enc_out=None,
           causal=True, triangle_skip=True, scan_tile=None):
    """One layer. Returns (x, new_cache_slice, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    new_cache = cache

    if kind == "mamba":
        out, new_state = mamba.mamba_core(p["mixer"], h, cfg, method,
                                          state=cache, pos=pos,
                                          scan_tile=scan_tile)
        return x + out, new_state, aux

    attn_kw = dict(rope_cs=rope_cs, causal=causal, window=window, pos=pos,
                   method=method, triangle_skip=triangle_skip)
    if kind == "hybrid":
        attn_cache = cache["attn"] if cache is not None else None
        ssm_state = cache["ssm"] if cache is not None else None
        a = layers.attention(p["attn"], h, cfg, cache=attn_cache, **attn_kw)
        if attn_cache is not None:
            a, attn_cache = a
        sout, ssm_state = mamba.mamba_core(p["ssm"], h, cfg, method,
                                           state=ssm_state, pos=pos,
                                           scan_tile=scan_tile)
        # hymba: the mean of the per-branch-normalized outputs
        mix = 0.5 * (layers.apply_norm(p["norm_attn"], a, cfg.norm)
                     + layers.apply_norm(p["norm_ssm"], sout, cfg.norm))
        x = x + mix
        if cache is not None:
            new_cache = {"attn": attn_cache, "ssm": ssm_state}
    else:
        self_cache = (None if cache is None
                      else {"k": cache["k"], "v": cache["v"]})
        a = layers.attention(p["attn"], h, cfg, cache=self_cache, **attn_kw)
        if self_cache is not None:
            a, self_cache = a
        x = x + a
        if cache is not None:
            new_cache = dict(cache, **self_cache)

    if "cross" in p and (enc_out is not None or
                         (cache is not None and "ck" in cache)):
        c, (ck, cv) = _cross_attend(p, x, cfg, cache, enc_out, method)
        x = x + c
        if cache is not None and "ck" in cache:
            new_cache = dict(new_cache, ck=ck.to(cache["ck"].dtype),
                             cv=cv.to(cache["cv"].dtype))

    h2 = layers.apply_norm(p["norm2"], x, cfg.norm)
    if kind == "moe":
        f, aux = moe.moe_ffn(p["ffn"], h2, cfg, method)
    else:
        f = layers.ffn(p["ffn"], h2, cfg, method)
    return x + f, new_cache, aux


def _unstack(tree, count: int):
    """The ``count`` per-layer trees of a stacked (dict) tree, each leaf
    split by one ``unbind``: under autograd its backward stacks the
    layers' gradients once, where indexing layer by layer would add
    ``count`` full-size zero-padded gradients into each stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(count)]
    return list(tree.unbind(0))


def _run_segments(params, cfg, x, *, rope_cs=None, method="autodiff",
                  caches=None, pos=None, enc_out=None, causal=True,
                  triangle_skip=True, scan_tiles=None):
    """Walk each segment's layers; returns (x, new_caches | None, aux).

    ``scan_tiles`` is an optional per-SEGMENT dict ``{si: (d_tile,
    chunk)}`` routing that segment's scans (mamba, hybrid) through the B13
    kernel; the window of each segment is its ``layer_plan`` entry's.
    """
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for si, (kind, count, window) in enumerate(cfg.layer_plan()):
        seg_p = _unstack(params["segments"][si], count)
        seg_c = (_unstack(caches[si], count) if caches is not None
                 else None)
        tile = scan_tiles.get(si) if scan_tiles else None
        states = []
        for i in range(count):
            x, nc, aux = _block(
                seg_p[i], x, cfg, kind, rope_cs=rope_cs,
                window=window, method=method,
                cache=seg_c[i] if seg_c is not None else None,
                pos=pos, enc_out=enc_out, causal=causal,
                triangle_skip=triangle_skip, scan_tile=tile)
            aux_total = aux_total + aux
            states.append(nc)
        if new_caches is not None:
            new_caches.append(_stack(states))
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# embeddings / frontends (precomputed modality embeddings)
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch: Dict, method="autodiff"):
    """The input dict -> backbone embeddings.

    dense / moe / ssm / hybrid: ``{"tokens": [B, S]}`` -> [B, S, d];
    vlm: ``{"tokens": [B, S-P], "patches": [B, P, d]}`` -> the patches then
    the tokens' embeddings; audio: the decoder tokens (the frames go to
    :func:`encode`)."""
    te = layers.embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "patches" and "patches" in batch:
        return torch.cat([batch["patches"].to(te.dtype), te], dim=1)
    return te


def _rope(cfg, s: int, device):
    return layers.rope_tables(torch.arange(s, device=device), cfg.hd,
                              cfg.rope_theta)


def encode(params, cfg, frames, method="autodiff"):
    """Bidirectional encoder over frame embeddings -> [B, S_src, d]."""
    x = frames.to(cfg.torch_dtype)
    rope_cs = _rope(cfg, x.shape[1], x.device)
    for lp in _unstack(params["encoder"], cfg.enc_layers):
        h = layers.apply_norm(lp["norm1"], x, cfg.norm)
        x = x + layers.attention(lp["attn"], h, cfg, rope_cs=rope_cs,
                                 causal=False, method=method)
        h2 = layers.apply_norm(lp["norm2"], x, cfg.norm)
        x = x + layers.ffn(lp["ffn"], h2, cfg, method)
    return layers.apply_norm(params["enc_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def forward_from_embeddings(params, cfg: ModelConfig, h, *,
                            method="autodiff", enc_frames=None, causal=True,
                            triangle_skip=True, scan_tiles=None):
    """Backbone from embeddings -> (logits [B,S,vocab] f32, aux).  The
    attribution entry.  ``enc_frames`` feed the encoder (encoder-decoder
    configs); ``scan_tiles`` routes the mamba / hybrid segments through
    the B13 kernel (``{segment: (d_tile, chunk)}``); None keeps the
    chunked scan.  ``aux`` is the MoE load-balancing loss (0 without
    MoE)."""
    h = h.to(cfg.torch_dtype)
    rope_cs = _rope(cfg, h.shape[1], h.device)
    enc_out = None
    if cfg.enc_layers and enc_frames is not None:
        enc_out = encode(params, cfg, enc_frames, method)
    x, _, aux = _run_segments(params, cfg, h, rope_cs=rope_cs, method=method,
                              enc_out=enc_out, causal=causal,
                              triangle_skip=triangle_skip,
                              scan_tiles=scan_tiles)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x, cfg), aux


def forward(params, cfg: ModelConfig, batch: Dict, *, method="autodiff",
            triangle_skip=True):
    """Training/eval forward: (logits, aux)."""
    h = embed_inputs(params, cfg, batch, method)
    enc_frames = batch.get("frames") if cfg.enc_layers else None
    return forward_from_embeddings(params, cfg, h, method=method,
                                   enc_frames=enc_frames,
                                   triangle_skip=triangle_skip)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               src_len: int = 0, *, device=None, mesh=None):
    """Per-segment cache (fused kv in the config's dtype; f32 ssm state,
    conv window in the config's dtype) on ``device`` (None: the card).
    ``capacity`` sizes the self-attention caches, ``src_len`` the
    encoder-decoder's cross ``ck`` / ``cv``.

    ``mesh``: this rank's cache, the batch-sharded placement of
    ``launch.steps.cache_shardings``: its rows of the ``batch`` over the
    batch axes and its block of the fused ``Kv*hd`` and ``d_inner`` axes
    over "model".  A batch smaller than the data-parallel size would shard
    the cache's T axis instead (sequence-parallel decode, ROADMAP A12d),
    which is refused."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    ways = shd.model_ways(mesh)
    if mesh is not None:
        _, _, dp = shd.batch_group(mesh)
        if batch < dp:
            raise NotImplementedError(
                f"a batch of {batch} under {dp} data-parallel ranks shards "
                f"the cache's T axis (sequence-parallel decode, ROADMAP "
                f"A12d)")
        lo, hi = shd.local_rows(mesh, batch)
        batch = hi - lo
    kv, di = cfg.n_kv * cfg.hd // ways, cfg.d_inner // ways
    caches = []
    for kind, count, _ in cfg.layer_plan():
        kv_shape = (count, batch, capacity, kv)
        attn_c = {"k": torch.zeros(kv_shape, dtype=dt, device=dev),
                  "v": torch.zeros(kv_shape, dtype=dt, device=dev)}
        if cfg.enc_layers and src_len:
            cross_shape = (count, batch, src_len, kv)
            attn_c["ck"] = torch.zeros(cross_shape, dtype=dt, device=dev)
            attn_c["cv"] = torch.zeros(cross_shape, dtype=dt, device=dev)
        ssm_c = {
            "h": torch.zeros((count, batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((count, batch, cfg.ssm_conv - 1, di),
                                dtype=dt, device=dev)}
        if kind == "mamba":
            caches.append(ssm_c)
        elif kind == "hybrid":
            caches.append({"attn": attn_c, "ssm": ssm_c})
        else:
            caches.append(attn_c)
    return caches


def prefill(params, cfg: ModelConfig, batch: Dict, cache, *,
            method="autodiff", triangle_skip=True):
    """Fill caches from a full prompt (and, with ``batch["frames"]``, the
    cross ``ck`` / ``cv``); returns (last-position logits [B, 1, vocab],
    cache)."""
    h = embed_inputs(params, cfg, batch, method).to(cfg.torch_dtype)
    rope_cs = _rope(cfg, h.shape[1], h.device)
    enc_out = None
    if cfg.enc_layers and "frames" in batch:
        enc_out = encode(params, cfg, batch["frames"], method)
    x, new_caches, _ = _run_segments(params, cfg, h, rope_cs=rope_cs,
                                     method=method, caches=cache,
                                     enc_out=enc_out,
                                     triangle_skip=triangle_skip)
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return layers.lm_head(params["embed"], x, cfg), new_caches


def decode_step(params, cfg: ModelConfig, tokens, cache, pos, *,
                method="autodiff"):
    """One decode step: tokens [B, 1] at position ``pos`` (an int); the
    RoPE tables come from ``pos``."""
    h = layers.embed(params["embed"], tokens, cfg)
    x, new_caches, _ = _run_segments(params, cfg, h, rope_cs=(),
                                     method=method, caches=cache, pos=pos)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return layers.lm_head(params["embed"], x, cfg), new_caches
