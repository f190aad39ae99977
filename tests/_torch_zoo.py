"""Shared set-up of the LM zoo parity tests (``tests/test_torch_lm_zoo_*``):
one SMOKE config built in both packages from the same parameters, the
reference's forwards, and ``repro``'s MoE with its capacity fault corrected.

The bf16 references run under ``jax.disable_jit()``, one primitive at a
time (``lax.scan`` unrolled in Python): compiled, XLA fuses elementwise
chains and rounds to bf16 less often than per operation (up to 1.5e-2 of
max|logit| on hymba), while op by op the port's bf16 stack is within
1e-3 of it (hymba and moonshot within 2e-7).  Scores are held relative to the reference's max |score|, but for
moonshot's bf16 ixg and contrastive scores (``Zoo(terms_scale=True)``):
those are signed sums over d of bf16 products that cancel (max Σ_d
|rel·e| far above max |score|), so one bf16 rounding step apart anywhere
in the backward moves them by several % of max |score|.  Each of
moonshot's blocks is bitwise ``repro``'s, forward and backward, but for
the MoE's gate cotangent (a bf16 sum over d, which XLA's CPU backend
accumulates in another order than torch), and the embedding gradient is
within the logits' 1e-2 of max |rel| (``test_embedding_gradient_matches``
in ``tests/test_torch_lm_zoo_moe_bf16.py``), yet relative to max |score|
the ixg and contrastive sums differ by up to 5.9e-2.  Their 5e-2 is
therefore relative to max Σ_d |rel·e|, the scale that bounds a sum's
rounding error.

``repro``'s MoE sends a dropped assignment to its expert's slot 0, where
the duplicate scatter can overwrite the first kept token (ROADMAP C);
:func:`first_c_moe_ffn` is
that function with the dropped assignments sent out of range
(``mode="drop"``), the first-C rule the module's docstring states and the
port keeps.  Where no expert overflows the two are the same function.  Its
expert products widen bf16 operands to f32 before the einsum: XLA's CPU
backend has no bf16 x bf16 -> f32 dot with batch dimensions at all (so
``repro``'s own bf16 MoE does not run here), and the widening is exact,
so the f32 products and sums are those ``preferred_element_type`` asks
for.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import rules as jrules
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import transformer as tf

TOL = {"float32": dict(logits=1e-5, scores=1e-4),
       "bfloat16": dict(logits=1e-2, scores=5e-2)}
METHODS = ("saliency", "deconvnet", "guided")
MODES = ("ixg", "grad_norm", "contrastive")
PROMPT, NEW, SRC = 12, 3, 10


def npf(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def rel_err(got, want):
    got, want = npf(got), npf(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close(got, want, tol, scale=None):
    """``|got - want| <= tol * scale`` everywhere; ``scale`` defaults to
    max |want|."""
    got, want = npf(got), npf(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = float(np.abs(got - want).max() / scale)
    assert err <= tol, (err, tol)


def first_c_moe_ffn(p, x, cfg, method="autodiff"):
    """``repro.models.moe.moe_ffn`` on one shard, a dropped assignment
    written nowhere."""
    b, s, d = x.shape
    xt = x.reshape(1, b * s, d)
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    c = jmoe._capacity(t, cfg)
    logits = jnp.einsum("xtd,de->xte", xt.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    me = jnp.mean(probs, axis=(0, 1))
    ce = jnp.mean(jax.nn.one_hot(expert_ids[..., 0], e, dtype=jnp.float32),
                  axis=(0, 1))
    aux = cfg.router_aux_coef * e * jnp.sum(me * ce)
    tk = t * k
    flat_ids = expert_ids.reshape(1, tk)
    flat_gate = gate_vals.reshape(1, tk)
    flat_tok = jnp.repeat(jnp.arange(t), k)[None]
    order = jnp.argsort(flat_ids, axis=-1)
    s_ids = jnp.take_along_axis(flat_ids, order, axis=-1)
    s_tok = jnp.take_along_axis(flat_tok, order, axis=-1)
    s_gate = jnp.take_along_axis(flat_gate, order, axis=-1)
    counts = jnp.sum(jax.nn.one_hot(flat_ids, e, dtype=jnp.int32), axis=1)
    start = jnp.cumsum(counts, axis=-1) - counts
    pos_in_e = jnp.arange(tk)[None] - jnp.take_along_axis(start, s_ids,
                                                          axis=-1)
    keep = pos_in_e < c
    slot = jnp.where(keep, s_ids * c + pos_in_e, e * c)    # out of range
    rows = jnp.zeros((1, 1), jnp.int32)
    tok_slots = jnp.full((1, e * c), t, jnp.int32).at[rows, slot].set(
        s_tok.astype(jnp.int32), mode="drop")
    gate_slots = jnp.zeros((1, e * c), jnp.float32).at[rows, slot].set(
        s_gate, mode="drop")
    xpad = jnp.concatenate([xt, jnp.zeros((1, 1, d), xt.dtype)], axis=1)
    xe = jnp.take_along_axis(xpad, tok_slots[..., None], axis=1)
    xe = xe.reshape(1, e, c, d)
    def expert(spec, a, w):
        a = jlayers._grad_cast(a)
        return jnp.einsum(spec, a.astype(jnp.float32),
                          w.astype(jnp.float32)).astype(xe.dtype)

    h = jrules.act(expert("xecd,edf->xecf", xe, p["w1"]), cfg.act, method,
                   cfg.residual_policy)
    if cfg.ffn_gated:
        h = h * expert("xecd,edf->xecf", xe, p["w3"])
    y = expert("xecf,efd->xecd", h, p["w2"])
    yw = y.reshape(1, e * c, d) * gate_slots[..., None].astype(y.dtype)
    out = jnp.zeros((1, t + 1, d), yw.dtype).at[rows, tok_slots].add(
        yw, mode="drop")
    out = out[:, :t].reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + jlayers.ffn(p["shared"], x, cfg, method)
    return out, aux


@contextlib.contextmanager
def reference(dtype="float32"):
    """``repro``'s transformer running :func:`first_c_moe_ffn`, and in
    bf16 one primitive at a time."""
    real = jmoe.moe_ffn
    jmoe.moe_ffn = first_c_moe_ffn
    try:
        if dtype == "bfloat16":
            with jax.disable_jit():
                yield
        else:
            yield
    finally:
        jmoe.moe_ffn = real


class Zoo:
    """One arch's SMOKE config (``dtype`` overridden) in both packages, the
    same parameters, and a NumPy batch: tokens, plus the vlm's patches or
    the encoder-decoder's frames."""

    def __init__(self, arch, dtype, terms_scale=False):
        self.arch, self.dtype, self.terms_scale = arch, dtype, terms_scale
        self.jcfg = jconfigs.get_smoke(arch).with_(dtype=dtype)
        self.cfg = configs.get_smoke(arch).with_(dtype=dtype)
        self.jp = jtf.init(jax.random.PRNGKey(0), self.jcfg)
        self.p = tf.params_from_jax(jax.tree.map(np.asarray, self.jp))
        rs = np.random.RandomState(1)
        self.toks = rs.randint(0, self.cfg.vocab, (2, PROMPT))
        self.extra = {}
        if self.cfg.frontend == "patches":
            self.extra["patches"] = rs.randn(
                2, self.cfg.n_patches, self.cfg.d_model).astype(np.float32)
        if self.cfg.enc_layers:
            self.extra["frames"] = rs.randn(
                2, SRC, self.cfg.d_model).astype(np.float32)
        self.tol = TOL[dtype]

    def jbatch(self, toks=None):
        b = {"tokens": jnp.asarray(self.toks if toks is None else toks)}
        b.update({k: jnp.asarray(v) for k, v in self.extra.items()})
        return b

    def batch(self, toks=None):
        t = self.toks if toks is None else toks
        b = {"tokens": torch.as_tensor(np.asarray(t))}
        b.update({k: torch.from_numpy(v) for k, v in self.extra.items()})
        return b

    def reference(self):
        return reference(self.dtype)

    def jax_scores(self, tokens, method, extra=None):
        """One ``jax.vjp`` of ``repro``'s rule-bound forward from the
        embeddings of ``tokens`` (``extra``: patches / frames).  Returns
        ``(embeddings, logits, scores_fn)``: ``scores_fn(position,
        target_a, target_b, mode)`` seeds one position as ``repro``'s
        token methods do and reduces as ``make_token_explain`` does."""
        jb = {"tokens": jnp.asarray(tokens)}
        jb.update({k: jnp.asarray(v) for k, v in (extra or {}).items()})
        h = jtf.embed_inputs(self.jp, self.jcfg, jb)
        frames = jb.get("frames")
        logits, vjp_fn = jax.vjp(lambda e: jtf.forward_from_embeddings(
            self.jp, self.jcfg, e, method=method, enc_frames=frames,
            remat=False)[0], h)

        def scores_fn(position, ta, tb, mode, with_scale=False):
            def oh(t):
                return jax.nn.one_hot(jnp.asarray(t), logits.shape[-1],
                                      dtype=logits.dtype)
            seed_at = oh(ta) - oh(tb) if mode == "contrastive" else oh(ta)
            seed = jnp.zeros_like(logits).at[:, position, :].set(seed_at)
            (rel,) = vjp_fn(seed)
            rel = rel.astype(jnp.float32)
            if mode == "grad_norm":
                scores = jnp.linalg.norm(rel, axis=-1)
                scale = jnp.abs(scores).max()
            else:
                terms = rel * h.astype(jnp.float32)
                scores = jnp.sum(terms, axis=-1)
                scale = jnp.abs(terms).sum(axis=-1).max()
            return (scores, float(scale)) if with_scale else scores

        return h, logits, scores_fn

    def score_scale(self, scores, scale):
        """The scale a score comparison is relative to: max |scores|, or
        with ``terms_scale`` the terms' magnitude sum ``scale`` (see the
        module docstring)."""
        return scale if self.terms_scale else float(
            np.abs(npf(scores)).max())


# ---------------------------------------------------------------------------
# the tests every zoo file runs on its ``zoo`` fixture (a :class:`Zoo`)
# ---------------------------------------------------------------------------


def _leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda v: isinstance(v, torch.Tensor))


def test_params_from_jax_and_init(zoo):
    """``params_from_jax`` copies every leaf bit for bit (stacked segments,
    encoder, MoE experts); ``init`` draws the same tree on the CPU."""
    jleaves, tleaves = _leaves(zoo.jp), _leaves(zoo.p)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(npf(t), npf(j))
    p = tf.init(zoo.cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    want = jax.tree.map(lambda v: (v.shape, str(v.dtype)), zoo.jp)
    got = jax.tree.map(lambda v: (tuple(v.shape),
                                  str(v.dtype).split(".")[-1]), p,
                       is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)


def test_forward_logits_match(zoo):
    with zoo.reference():
        want, jaux = jtf.forward(zoo.jp, zoo.jcfg, zoo.jbatch())
    got, aux = tf.forward(zoo.p, zoo.cfg, zoo.batch())
    assert got.dtype == torch.float32
    close(got, want, zoo.tol["logits"])
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    if not zoo.cfg.n_experts:
        assert float(aux) == 0.0


def test_prefill_and_decode_step_match(zoo):
    """``prefill`` (frames fill the cross ``ck`` / ``cv``, patches lead the
    sequence) then one ``decode_step`` against ``repro``'s, caches
    included; without MoE (whose capacity depends on the token count) also
    against the port's full forward of the longer sequence."""
    cfg, b = zoo.cfg, zoo.toks.shape[0]
    src = SRC if cfg.enc_layers else 0
    s = PROMPT + (cfg.n_patches if cfg.frontend == "patches" else 0)
    cap = s + 4
    with zoo.reference():
        jc = jtf.init_cache(zoo.jcfg, b, cap, src_len=src)
        jl, jc = jtf.prefill(zoo.jp, zoo.jcfg, zoo.jbatch(), jc)
        nxt = np.argmax(npf(jl[:, -1]), axis=-1)[:, None]
        jl2, jc2 = jtf.decode_step(zoo.jp, zoo.jcfg, jnp.asarray(nxt), jc,
                                   jnp.asarray(s, jnp.int32))
    tc = tf.init_cache(cfg, b, cap, src_len=src, device="cpu")
    tl, tc = tf.prefill(zoo.p, cfg, zoo.batch(), tc)
    close(tl, jl, zoo.tol["logits"])
    tl2, tc2 = tf.decode_step(zoo.p, cfg, torch.from_numpy(nxt), tc, s)
    close(tl2, jl2, zoo.tol["logits"])
    jcl, tcl = _leaves(jc2), _leaves(tc2)
    assert len(jcl) == len(tcl)
    for j, t in zip(jcl, tcl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        if np.abs(npf(j)).max() > 0:
            close(t, j, zoo.tol["logits"])
    if cfg.enc_layers:
        assert any("ck" in c for c in tc2)
    if not cfg.n_experts:
        longer = zoo.batch(np.concatenate([zoo.toks, nxt], axis=1))
        full = tf.forward(zoo.p, cfg, longer)[0][:, -1]
        close(tl2[:, -1], full, zoo.tol["logits"])


def test_greedy_decode_tokens_match(zoo):
    from repro import lm as jlm
    from repro_torch import lm
    with zoo.reference():
        want = jlm.decode(zoo.jp, zoo.jcfg, jnp.asarray(zoo.toks),
                          max_new=NEW + 1)
    got = lm.decode(zoo.p, zoo.cfg, torch.from_numpy(zoo.toks),
                    max_new=NEW + 1)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.runners_up.numpy(),
                                  np.asarray(want.runners_up))


def jax_grid(zoo):
    """``repro``'s last-position logits and scores for every method x mode
    (targets: the argmax, and the runner-up for contrastive)."""
    grid = {}
    with zoo.reference():
        for method in METHODS:
            _, logits, scores_fn = zoo.jax_scores(zoo.toks, method,
                                                  zoo.extra)
            at = logits[:, -1].astype(jnp.float32)
            _, idx2 = jax.lax.top_k(at, 2)
            grid["logits"] = at
            for mode in MODES:
                scores, scale = scores_fn(-1, idx2[:, 0], idx2[:, 1], mode,
                                          with_scale=True)
                grid[method, mode] = scores
                grid[method, mode, "scale"] = zoo.score_scale(scores, scale)
    return grid


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_attribute_step_matches(zoo, grid, method, mode):
    from repro_torch.launch import steps
    logits, scores = steps.make_attribute_step(zoo.cfg, method, mode=mode)(
        zoo.p, zoo.batch())
    close(logits, grid["logits"], zoo.tol["logits"])
    close(scores, grid[method, mode], zoo.tol["scores"],
          grid[method, mode, "scale"])


def test_explain_generated_causal_zeros(zoo):
    """Per-generated-token contrastive scores against ``repro``'s seeds on
    the same decoded sequence (frames on the explain, tokens only in the
    decode, as ``repro.lm``); the scores after each seed exactly 0."""
    from repro_torch import lm
    frames = {k: v for k, v in zoo.extra.items() if k == "frames"}
    res = lm.decode(zoo.p, zoo.cfg, torch.from_numpy(zoo.toks), max_new=NEW)
    got = lm.explain_generated(
        zoo.p, zoo.cfg, res,
        frames=torch.from_numpy(frames["frames"]) if frames else None)
    assert tuple(got.shape) == (2, NEW, PROMPT + NEW)
    toks, runners = res.tokens.numpy(), res.runners_up.numpy()
    with zoo.reference():
        scores_fn = zoo.jax_scores(toks, "saliency", frames)[2]
        pairs = [scores_fn(PROMPT - 1 + t, toks[:, PROMPT + t],
                           runners[:, t], "contrastive", with_scale=True)
                 for t in range(NEW)]
    want = jnp.stack([w for w, _ in pairs], axis=1)
    close(got, want, zoo.tol["scores"],
          zoo.score_scale(want, max(sc for _, sc in pairs)))
    for t in range(NEW):
        assert bool((got[:, t, PROMPT + t:] == 0).all())
        assert bool((got[:, t, :PROMPT + t] != 0).any())


def test_engine_explain_tokens(zoo, grid):
    """``Engine.explain_tokens`` over ``LMModel`` (the batch's patches /
    frames moved with the tokens) is the attribution step."""
    from repro_torch.engine import EngineSpec, LMModel, build
    eng = build(EngineSpec(LMModel(zoo.p, zoo.cfg, device="cpu"),
                           method="guided"))
    batch = {"tokens": zoo.toks, **zoo.extra}
    logits, scores = eng.explain_tokens(batch, mode="contrastive")
    close(logits, grid["logits"], zoo.tol["logits"])
    close(scores, grid["guided", "contrastive"], zoo.tol["scores"],
          grid["guided", "contrastive", "scale"])
