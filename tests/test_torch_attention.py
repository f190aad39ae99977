"""The port's RoPE and attention (``repro_torch.models.layers``) against
``repro.models.layers`` (CPU), on NumPy inputs from a seed.

* RoPE: the tables within 2 f32 ulps of ``repro``'s (``pow`` and ``cos``
  / ``sin`` may round differently), the rotation on the same tables
  bitwise (f32 and bf16, one rounding per operation in both);
* ``_head_layout``'s repeat, and ``_sdpa_full``, ``_sdpa_grouped`` and
  ``_sdpa_chunked`` (causal and bidirectional, windows 0 and 24, triangle
  skip on and off, GQA groups 1, 2 and 5) within 1e-6 of max|ref| in f32
  (the same f32 arithmetic summed in another order) and 1e-2 in bf16;
* ``attention``: a decode step by step (and a prefill then decode steps)
  equal to the full sequence's rows within 1e-5 of max, with and without
  RoPE and a window, QKV bias included;
* chunked attention at S = 40, chunks of 16 (not a multiple): within 1e-6
  of full attention, values and gradients, where ``repro``'s chunked
  attention is off by more than 0.1 of max (its last chunk starts at 24,
  not 32, and counts keys 24-31 twice: ROADMAP C); at S = 64, a multiple
  of both chunks, within 1e-6 of ``repro``'s chunked attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig

B, HD = 2, 16


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(a, dtype="float32"):
    """One NumPy array as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))
    return j, t


def _qkv(seed, s, t, nq, nkv, dtype="float32"):
    rs = np.random.RandomState(seed)
    q = _both(rs.randn(B, s, nq, HD), dtype)
    k = _both(rs.randn(B, t, nkv, HD), dtype)
    v = _both(rs.randn(B, t, nkv, HD), dtype)
    return q, k, v


# -- RoPE ---------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("hd", [16, 64])
def test_rope_tables_match(theta, hd):
    pos = np.arange(64)
    jc, js = jl.rope_tables(jnp.asarray(pos), hd, theta)
    tc, ts = tl.rope_tables(torch.from_numpy(pos), hd, theta)
    assert tc.dtype == ts.dtype == torch.float32
    assert tuple(tc.shape) == (64, hd // 2)
    for got, want in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=2 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_is_bitwise_on_the_same_tables(dtype):
    c, s = tl.rope_tables(torch.arange(12), HD, 1e4)
    x = np.random.RandomState(0).randn(B, 12, 3, HD)
    jx, tx = _both(x, dtype)
    got = tl.apply_rope(tx, c, s)
    want = jl.apply_rope(jx, jnp.asarray(c.numpy()), jnp.asarray(s.numpy()))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


# -- the three sdpa shapes ----------------------------------------------------


@pytest.mark.parametrize("g", [1, 2, 5])
def test_head_layout_repeats_kv_heads(g):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, 8, 8, 2 * g, 2)
    want = jl._head_layout(jq, jk, jv, g)
    got = tl._head_layout(tq, tk, tv, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


SDPA = [(g, causal, window) for g in (1, 2, 5) for causal in (True, False)
        for window in (0, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,causal,window", SDPA)
def test_sdpa_full_matches(g, causal, window, dtype):
    s = 40
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, s, 2 * g, 2, dtype)
    pos = np.arange(s)
    want = jl._sdpa_full(*jl._head_layout(jq, jk, jv, g),
                         q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                         causal=causal, window=window)
    got = tl._sdpa_full(*tl._head_layout(tq, tk, tv, g),
                        q_pos=torch.from_numpy(pos),
                        k_pos=torch.from_numpy(pos), causal=causal,
                        window=window)
    assert got.dtype == tv.dtype
    assert _err(got, want) <= (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,causal,window", SDPA)
def test_sdpa_grouped_matches(g, causal, window, dtype):
    """One query token at position 29 against a 40-slot cache of 2 KV
    heads."""
    t, kvh = 40, 2
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, t, kvh * g, kvh, dtype)
    qp, kp = np.array([29]), np.arange(t)
    want = jl._sdpa_grouped(jq.reshape(B, 1, kvh, g, HD), jk, jv,
                            q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp),
                            causal=causal, window=window)
    got = tl._sdpa_grouped(tq.reshape(B, 1, kvh, g, HD), tk, tv,
                           q_pos=torch.from_numpy(qp),
                           k_pos=torch.from_numpy(kp), causal=causal,
                           window=window)
    assert _err(got, want) <= (1e-6 if dtype == "float32" else 1e-2)
    # the grouped contraction is the repeated layout's full sdpa, one row
    full = tl._sdpa_full(*tl._head_layout(tq, tk, tv, g),
                         q_pos=torch.from_numpy(qp),
                         k_pos=torch.from_numpy(kp), causal=causal,
                         window=window)
    assert _err(got.reshape(full.shape), full) <= (
        1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("g,causal,window", SDPA)
def test_sdpa_chunked_matches_at_multiples(g, causal, window, skip):
    """S = 64, query chunks of 32 and key chunks of 16: ``repro``'s
    chunked attention and the port's compute the same sums."""
    s = 64
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, s, s, 2 * g, 2)
    pos = np.arange(s)
    kw = dict(causal=causal, window=window, qc=32, kc=16, triangle_skip=skip)
    want = jl._sdpa_chunked(*jl._head_layout(jq, jk, jv, g),
                            q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                            **kw)
    got = tl._sdpa_chunked(*tl._head_layout(tq, tk, tv, g),
                           q_pos=torch.from_numpy(pos),
                           k_pos=torch.from_numpy(pos), **kw)
    assert _err(got, want) <= 1e-6
    full = tl._sdpa_full(*tl._head_layout(tq, tk, tv, g),
                         q_pos=torch.from_numpy(pos),
                         k_pos=torch.from_numpy(pos), causal=causal,
                         window=window)
    assert _err(got, full) <= 1e-6


# -- chunked attention at a ragged length -------------------------------------


@pytest.mark.parametrize("causal,skip", [(True, False), (True, True),
                                         (False, True)])
def test_chunked_is_full_at_a_ragged_length(causal, skip):
    """S = 40 with chunks of 16: the last key chunk is padded with masked
    keys, so the port equals full attention (values and input gradients);
    ``repro`` clamps that chunk's start to 24 and counts keys 24-31
    twice."""
    s = 40
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, s, s, 4, 4)
    pos = np.arange(s)
    kw = dict(causal=causal, window=0, qc=16, kc=16, triangle_skip=skip)
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    tpos = torch.from_numpy(pos)
    got = tl._sdpa_chunked(tq, tk, tv, q_pos=tpos, k_pos=tpos, **kw)
    full = tl._sdpa_full(tq, tk, tv, q_pos=tpos, k_pos=tpos, causal=causal,
                         window=0)
    assert _err(got, full) <= 1e-6
    seed = torch.from_numpy(np.random.RandomState(5).randn(*got.shape)
                            .astype(np.float32))
    g_chunk = torch.autograd.grad(got, (tq, tk, tv), seed)
    g_full = torch.autograd.grad(full, (tq, tk, tv), seed)
    for a, b in zip(g_chunk, g_full):
        assert _err(a, b) <= 1e-5
    jpos = jnp.asarray(pos)
    jfull = jl._sdpa_full(jq, jk, jv, q_pos=jpos, k_pos=jpos, causal=causal,
                          window=0)
    assert _err(full, jfull) <= 1e-6
    jchunk = jl._sdpa_chunked(jq, jk, jv, q_pos=jpos, k_pos=jpos, **kw)
    assert _err(jchunk, jfull) > 0.1        # the reference's fault


def test_attention_chunked_flag_at_a_ragged_length():
    """``attention(chunked=True)`` through the public entry, with RoPE and
    GQA, equals ``chunked=False`` at S = 40 and chunk 16."""
    cfg = ModelConfig(n_heads=4, n_kv=2, d_model=32, head_dim=8,
                      attn_chunk=16, dtype="float32")
    p = tl.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(B, 40, 32, generator=torch.Generator().manual_seed(1))
    rope = tl.rope_tables(torch.arange(40), cfg.hd, cfg.rope_theta)
    outs = [tl.attention(p, x, cfg, rope_cs=rope, chunked=c)
            for c in (True, False)]
    assert _err(*outs) <= 1e-6


# -- attention, all modes -----------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("rope", [True, False])
def test_decode_steps_equal_the_full_sequence(rope, window):
    """Prefill of the first 4 tokens, then one decode step a token, equal
    to the full sequence's rows; ``repro``'s decode agrees."""
    kw = dict(n_heads=4, n_kv=2, d_model=32, head_dim=8, qkv_bias=True,
              dtype="float32")
    cfg = ModelConfig(**kw)
    jp = jl.init_attention(jax.random.PRNGKey(0), JConfig(**kw))
    jp = dict(jp, bq=jp["bq"] + 0.1, bk=jp["bk"] - 0.2, bv=jp["bv"] + 0.3)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    s, cap, pre = 12, 16, 4
    x = np.random.RandomState(6).randn(B, s, 32).astype(np.float32)
    tx = torch.from_numpy(x)
    rope_cs = tl.rope_tables(torch.arange(s), cfg.hd, cfg.rope_theta)
    full = tl.attention(p, tx, cfg, rope_cs=rope_cs if rope else None,
                        window=window)
    jrope = tuple(jnp.asarray(t.numpy()) for t in rope_cs)
    jfull = jl.attention(jp, jnp.asarray(x), cfg,
                         rope_cs=jrope if rope else None, window=window)
    assert _err(full, jfull) <= 1e-5
    zeros = torch.zeros(B, cap, cfg.n_kv * cfg.hd)
    pre_rope = tuple(t[:pre] for t in rope_cs) if rope else None
    out, cache = tl.attention(p, tx[:, :pre], cfg, rope_cs=pre_rope,
                              window=window,
                              cache={"k": zeros, "v": zeros.clone()})
    rows = [out]
    jcache = {"k": jnp.zeros((B, cap, 16)), "v": jnp.zeros((B, cap, 16))}
    _, jcache = jl.attention(jp, jnp.asarray(x[:, :pre]), cfg,
                             rope_cs=tuple(t[:pre] for t in jrope)
                             if rope else None, window=window, cache=jcache)
    for pos in range(pre, s):
        o, cache = tl.attention(p, tx[:, pos:pos + 1], cfg,
                                rope_cs=() if rope else None, window=window,
                                cache=cache, pos=pos)
        jo, jcache = jl.attention(jp, jnp.asarray(x[:, pos:pos + 1]), cfg,
                                  rope_cs=() if rope else None,
                                  window=window, cache=jcache,
                                  pos=jnp.asarray(pos, jnp.int32))
        assert _err(o, jo) <= 1e-5
        rows.append(o)
    assert _err(torch.cat(rows, dim=1), full) <= 1e-5
    assert _err(cache["k"], jcache["k"]) <= 1e-6
    assert bool((cache["k"][:, s:] == 0).all())
