"""Shared building blocks of the LM zoo, as ``repro.models.layers`` has
them: initializers, RMS/layer norm, RoPE, grouped-query attention in all
its modes, the FFN, the token embedding and the LM head.

Parameters are plain dicts of tensors; initializers draw from an explicit
``torch.Generator`` on the device the parameters live on.  Every
nonlinearity goes through :func:`repro_torch.core.rules.act`, so the
attribution method reaches every backbone.

Attention runs in three shapes, as in the JAX package:

* full: the scores materialized (short sequences);
* chunked: an online softmax over KV chunks with f32 running statistics,
  a static ``triangle_skip`` of fully masked causal chunks and the static
  band of a sliding window (long sequences); the last chunk of a ragged
  length is padded with masked keys;
* decode: one query token against the fused ``[B, T, Kv*hd]`` cache,
  contracted per KV head group (the cache is never repeated).

On a mesh whose "model" axis has several ranks (the active mesh of
:func:`repro_torch.dist.sharding.use_mesh`), each rank holds its slice of
the parameters (:func:`repro_torch.dist.params.shard_params`) and the
layers run Megatron-style: the FFN's ``w1`` / ``w3`` column-parallel and
``w2`` row-parallel then summed over the model group; the attention's
q / k / v column-parallel, each rank computing whole heads and ``wo``
row-parallel then summed (:class:`_Heads`); the table d-sharded (a local
lookup, then gathered along d); the head V-sharded (the tied table
resharded from d to V), the logits gathered whole.  The residual stream is
the same on every rank.  With one rank on that axis every function runs
the single-device code.

Where the JAX package contracts bf16 operands into a kept f32 result
(``preferred_element_type``: the scores, ``p @ v``, the chunked
accumulator, the logits), the operands are widened to f32, which is
exact, and multiplied in f32 with TF32 off.  Masked scores are ``-1e30``
before an f32 softmax, so masked keys get exactly 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import rules
from repro_torch.dist import sharding as shd


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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [S] -> (cos, sin), each [S, head_dim / 2] in f32, on the
    positions' device."""
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                        device=positions.device)
                           / head_dim))
    ang = positions.to(f32)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] rotated by (cos, sin) [S, D/2] (the tables rounded to
    x's dtype, the rotation in x's dtype, halves not interleaved)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg,
                   d_model: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    hd, hq, kv = cfg.hd, cfg.n_heads, cfg.n_kv
    dt = cfg.torch_dtype
    p = {"wq": dense_init(gen, d, hq * hd, dt),
         "wk": dense_init(gen, d, kv * hd, dt),
         "wv": dense_init(gen, d, kv * hd, dt),
         "wo": dense_init(gen, hq * hd, d, dt)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros(n * hd, dtype=dt, device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _mask(q_pos, k_pos, causal: bool, window: int):
    """[S, T] bool of the keys each query sees (None: all of them)."""
    mask = None
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        w = k_pos[None, :] > q_pos[:, None] - window
        mask = w if mask is None else mask & w
    return mask


def _masked(s: torch.Tensor, mask) -> torch.Tensor:
    """Scores with the keys outside ``mask`` (broadcast over the leading
    axes) set to -1e30."""
    if mask is None:
        return s
    return torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                           device=s.device))


def _sdpa_grouped(q, k, v, *, q_pos, k_pos, causal: bool, window: int):
    """Decode sdpa: q [B, 1, Kv, G, hd] against the un-repeated cache
    k / v [B, T, Kv, hd], contracted per KV head group, so each cache byte
    is read once."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", _f32(q), _f32(k)) * scale
    s = _masked(s, _mask(q_pos, k_pos, causal, window))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", _f32(p.to(v.dtype)), _f32(v))
    return o.to(v.dtype)


def _head_layout(q, k4, v4, g: int, first: int = 0):
    """KV heads repeated to the query-head count (``g`` consecutive copies
    each, query head j reading KV head j // g).  ``first``: the offset of
    ``q``'s first head in the repeated heads of ``k4`` (a model rank's
    heads may start inside a group)."""
    if g > 1:
        k4 = torch.repeat_interleave(k4, g, dim=2)
        v4 = torch.repeat_interleave(v4, g, dim=2)
    if first or k4.shape[2] != q.shape[2]:
        k4 = k4.narrow(2, first, q.shape[2])
        v4 = v4.narrow(2, first, q.shape[2])
    return q, k4, v4


def _whole(t: torch.Tensor, sizes=None) -> torch.Tensor:
    """Every model rank's columns of ``t`` gathered, for work that differs
    by rank: the cotangent is summed over the ranks before each keeps its
    columns (a reduce-scatter)."""
    return shd.copy_to_model(shd.gather_from_model(t, -1, sizes=sizes))


class _Heads:
    """The heads one model rank of ``ways`` computes (all of them at one
    way).

    ``wq``'s column block gives rank r the heads ``[r hq / w, (r+1) hq /
    w)`` when ``w`` divides ``hq``; else the columns are gathered into
    whole heads and the rank takes ``host_shard_bounds(hq, r, w)`` of them
    (``q_whole``), and its attention output is gathered back (uneven) for
    its ``wo`` row block.  The rank's KV heads ``[k0, k1)`` are those its
    query heads read; its ``wk`` / ``wv`` columns hold exactly them when
    ``w`` divides both head counts, else the columns are gathered
    (``kv_whole``: fewer KV heads than ways, or query heads split).  The
    cache keeps the rank's column block of the fused ``Kv*hd`` axis
    either way (``cache_shardings``' "model")."""

    def __init__(self, cfg):
        hq, kvh = cfg.n_heads, cfg.n_kv
        _, coord, ways = shd.model_group(shd.current_mesh())
        self.hd, self.g, self.coord = cfg.hd, hq // kvh, coord
        self.q_whole = ways > 1 and hq % ways != 0
        self.kv_whole = ways > 1 and (self.q_whole or kvh % ways != 0)
        if self.q_whole:
            self.sizes = tuple(n * cfg.hd for n in shd.even_sizes(hq, ways))
            self.h0 = sum(self.sizes[:coord]) // cfg.hd
            self.h1 = self.h0 + self.sizes[coord] // cfg.hd
        else:
            self.h0, self.h1 = coord * hq // ways, (coord + 1) * hq // ways
        self.k0, self.k1 = self.h0 // self.g, -(-self.h1 // self.g)
        self.nkv = kvh if self.kv_whole else self.k1 - self.k0
        self.col0 = coord * kvh * cfg.hd // ways     # the cache's columns
        self.cols = kvh * cfg.hd // ways

    @property
    def nq(self) -> int:
        return self.h1 - self.h0

    def q_cols(self, q2):
        """The rank's query heads' columns."""
        if not self.q_whole:
            return q2
        return _whole(q2).narrow(-1, self.h0 * self.hd, self.nq * self.hd)

    def kv_cols(self, t2):
        """The KV columns the rank holds: its own, or all heads'."""
        return _whole(t2) if self.kv_whole else t2

    def needed(self, k4):
        """The KV heads ``[k0, k1)`` of the held heads ``k4``."""
        if not self.kv_whole:
            return k4
        return k4.narrow(2, self.k0, self.k1 - self.k0)

    def own(self, t2):
        """The rank's cache columns of the held fused ``t2``."""
        return t2.narrow(-1, self.col0, self.cols) if self.kv_whole else t2

    def cached(self, c):
        """The held fused KV columns from the rank's cache block."""
        return shd.gather_from_model(c, -1) if self.kv_whole else c

    def out(self, o2, wo):
        """``o2 [B, S, nq*hd] @ wo`` summed over the model group."""
        if self.q_whole:
            o2 = _whole(o2, self.sizes).narrow(
                -1, self.coord * wo.shape[0], wo.shape[0])
        return shd.reduce_from_model(o2 @ wo)


def _sdpa_full(q, k, v, *, q_pos, k_pos, causal: bool, window: int):
    """q [B, S, N, hd], k / v [B, T, N, hd] (KV already repeated to N
    heads): the scores materialized in f32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsnh,btnh->bnst", _f32(q), _f32(k)) * scale
    s = _masked(s, _mask(q_pos, k_pos, causal, window))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnst,btnh->bsnh", _f32(p.to(v.dtype)), _f32(v))
    return o.to(v.dtype)


def _sdpa_chunked(q, k, v, *, q_pos, k_pos, causal: bool, window: int,
                  qc: int, kc: int, triangle_skip: bool):
    """Flash-style double-chunked attention: an online softmax over KV
    chunks with f32 running statistics, q [B, S, N, hd] and k / v
    [B, T, N, hd] (KV repeated to N heads).

    The query chunks are a Python loop, so ``triangle_skip`` statically
    skips the KV chunks a causal query chunk cannot see (only for the
    full-sequence pass, where q_pos == k_pos == arange(S)), and a sliding
    window computes only its static band.  Where T is not a multiple of
    ``kc`` the last chunk is padded with masked keys (scores -1e30, values
    0), so every key counts once at every length; the JAX package clamps
    that chunk's start instead and counts some keys twice (ROADMAP C).
    """
    b, sq, nh, hd = q.shape
    t = k.shape[1]
    nq = -(-sq // qc)
    scale = hd ** -0.5
    outs = []
    for i in range(nq):
        q0, q1 = i * qc, min((i + 1) * qc, sq)
        qb, qp = _f32(q[:, q0:q1]), q_pos[q0:q1]
        t_lo = 0
        if triangle_skip and causal and t == sq:
            t_hi = min(t, (i + 1) * qc)
            if window > 0:
                t_lo = max(0, (q0 - window) // kc * kc)
        else:
            t_hi = t
        t_hi = max(t_lo + kc, t_hi)
        nk = -(-(t_hi - t_lo) // kc)
        m = torch.full((b, nh, q1 - q0), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, nh, q1 - q0, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            a0 = t_lo + j * kc
            a1 = min(a0 + kc, t)
            s = torch.einsum("bqnh,btnh->bnqt", qb,
                             _f32(k[:, a0:a1])) * scale
            s = _masked(s, _mask(qp, k_pos[a0:a1], causal, window))
            vc = _f32(v[:, a0:a1])
            if a1 - a0 < kc:                 # masked padding keys
                s = F.pad(s, (0, kc - (a1 - a0)), value=-1e30)
                vc = F.pad(vc, (0, 0, 0, 0, 0, kc - (a1 - a0)))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            l = l * corr + e.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bnqt,btnh->bnqh",
                                                       e, vc)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.permute(0, 2, 1, 3).to(v.dtype))
    return torch.cat(outs, dim=1)


def attention(p, x, cfg, *, rope_cs=None, causal=True, window=0,
              cache=None, pos=None, kv_override=None, method="autodiff",
              chunked=None, triangle_skip=True):
    """GQA attention, all modes: ``x [B, S, d] -> [B, S, d]`` (and the new
    cache where one is given).

    ``cache``: ``{"k", "v": [B, Tcap, Kv*hd]}`` (fused layout; a model
    rank's column block of it).  With
    ``pos`` (an int) it runs the decode step: this step's keys and values
    are written at ``pos`` and the queries read the whole cache; without,
    the full-sequence pass fills the cache from 0 (prefill).
    ``kv_override``: ``(k2, v2)`` ``[B, T, Kv*hd]`` of a cross-attention
    source (a model rank's columns).
    ``rope_cs``: ``(cos, sin)`` of the full sequence, or in decode any
    non-None value (the tables are built from ``pos``).  ``chunked``
    forces the chunked or the full sdpa (None: chunked from
    ``cfg.attn_chunk_threshold`` tokens on).  ``method`` is unused: the
    attention has no rectifier."""
    b, s, _ = x.shape
    hd, g = cfg.hd, cfg.n_heads // cfg.n_kv
    heads = _Heads(cfg)
    x = shd.copy_to_model(x)

    q2 = x @ p["wq"]
    if "bq" in p:
        q2 = q2 + p["bq"]
    q = _split_heads(heads.q_cols(q2), heads.nq, hd)
    if kv_override is None:
        k2, v2 = x @ p["wk"], x @ p["wv"]
        if "bk" in p:
            k2, v2 = k2 + p["bk"], v2 + p["bv"]
    else:
        k2, v2 = kv_override
    k4 = _split_heads(heads.kv_cols(k2), heads.nkv, hd)
    v4 = _split_heads(heads.kv_cols(v2), heads.nkv, hd)

    new_cache = cache
    if cache is not None and pos is not None:
        # decode: this step's fused kv at pos, the queries read the cache
        q_pos = pos + torch.arange(s, device=x.device)
        if rope_cs is not None:
            cq, sq_ = rope_tables(q_pos, hd, cfg.rope_theta)
            q = apply_rope(q, cq, sq_)
            if kv_override is None:
                k4 = apply_rope(k4, cq, sq_)   # the cache keeps rotated keys
        if kv_override is None:
            ck = torch.slice_scatter(
                cache["k"], heads.own(k4.reshape(b, s, heads.nkv * hd)).to(
                    cache["k"].dtype), dim=1, start=pos, end=pos + s)
            cv = torch.slice_scatter(
                cache["v"], heads.own(v4.reshape(b, s, heads.nkv * hd)).to(
                    cache["v"].dtype), dim=1, start=pos, end=pos + s)
            new_cache = {"k": ck, "v": cv}
        else:
            ck, cv = cache["k"], cache["v"]
        ck, cv = heads.cached(ck), heads.cached(cv)
        tcap = ck.shape[1]
        kc = heads.needed(ck.reshape(b, tcap, heads.nkv, hd))
        vc = heads.needed(cv.reshape(b, tcap, heads.nkv, hd))
        if heads.h0 % g or heads.h1 % g:    # the rank's heads split a group
            _, kc, vc = _head_layout(q, kc, vc, g, heads.h0 - heads.k0 * g)
            qg = q.reshape(b, s, heads.nq, 1, hd)
        else:
            qg = q.reshape(b, s, heads.k1 - heads.k0, g, hd)
        o = _sdpa_grouped(qg, kc, vc, q_pos=q_pos,
                          k_pos=torch.arange(tcap, device=x.device),
                          causal=causal, window=window)
    else:
        # full sequence (prefill fills the cache from 0)
        if rope_cs is not None:
            cos, sin = rope_cs
            q = apply_rope(q, cos, sin)
            if kv_override is None:
                k4 = apply_rope(k4, cos, sin)
        if cache is not None:
            new_cache = {
                name: torch.slice_scatter(
                    cache[name], heads.own(t4.reshape(
                        b, s, heads.nkv * hd)).to(cache[name].dtype),
                    dim=1, start=0, end=s)
                for name, t4 in (("k", k4), ("v", v4))}
        t = k4.shape[1]
        q_pos = torch.arange(s, device=x.device)
        k_pos = torch.arange(t, device=x.device)
        qh, kh, vh = _head_layout(q, heads.needed(k4), heads.needed(v4), g,
                                  heads.h0 - heads.k0 * g)
        use_chunked = (chunked if chunked is not None
                       else s >= cfg.attn_chunk_threshold)
        if use_chunked:
            o = _sdpa_chunked(qh, kh, vh, q_pos=q_pos, k_pos=k_pos,
                              causal=causal, window=window,
                              qc=min(cfg.attn_chunk, s),
                              kc=min(cfg.attn_chunk, t),
                              triangle_skip=triangle_skip)
        else:
            o = _sdpa_full(qh, kh, vh, q_pos=q_pos, k_pos=k_pos,
                           causal=causal, window=window)

    out = heads.out(o.reshape(b, s, heads.nq * hd), p["wo"])
    if cache is not None:
        return out, new_cache
    return out


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg, d_ff: Optional[int] = None) -> dict:
    dff = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    p = {"w1": dense_init(gen, cfg.d_model, dff, dt),
         "w2": dense_init(gen, dff, cfg.d_model, dt)}
    if cfg.ffn_gated:
        p["w3"] = dense_init(gen, cfg.d_model, dff, dt)
    return p


def ffn(p, x, cfg, method="autodiff"):
    """``act(x W1) [* x W3] W2``, the activation through ``rules.act``
    (seamless's ReLU: the paper's 1-bit mask); on the model axis ``W1`` /
    ``W3`` column-parallel and ``W2`` row-parallel, summed over the
    group."""
    x = shd.copy_to_model(x)
    h = rules.act(x @ p["w1"], cfg.act, method, cfg.residual_policy,
                  row_max=shd.max_over_model)
    if cfg.ffn_gated:
        h = h * (x @ p["w3"])
    return shd.reduce_from_model(h @ p["w2"])


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


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
    ``take``); on the model axis a local lookup in the rank's d columns,
    gathered along d."""
    return shd.gather_from_model(p["table"][tokens], -1)


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
    multiplied in f32, with TF32 off as the port runs everywhere.  On the
    model axis each rank computes its V columns (the tied table, d-sharded
    for the lookup, is resharded to V: gathered along d, then the rank's
    rows), and the logits are gathered whole.
    """
    h = shd.copy_to_model(_grad_cast(h).to(torch.float32))
    if cfg.tie_embeddings:
        table = shd.slice_to_model(shd.gather_from_model(p["table"], -1), 0)
        logits = h @ table.to(torch.float32).T
    else:
        logits = h @ p["head"].to(torch.float32)
    logits = shd.gather_from_model(logits, -1)
    if cfg.padded_vocab != cfg.vocab:
        logits = logits[..., :cfg.vocab]
    return logits
