"""The falcon-mamba token-attribution slice of repro_torch against the JAX
package (CPU), at ``SMOKE`` and at ``SMOKE.with_(dtype="bfloat16")``.

The same parameters (``repro``'s ``transformer.init``, copied by
``params_from_jax``) and the same NumPy tokens go through both packages:

* the config and the parameter tree (bitwise), the forward logits through
  the B13 route (``scan_tiles``) and the chunked route, ``prefill`` /
  ``decode_step``, greedy ``decode`` (tokens and runners-up equal);
* per-token scores: ``explain_generated``, ``make_token_explain`` in all
  three modes x saliency / deconvnet / guided, ``Engine.explain_tokens``;
* exact causal zeros, contrastive = ixg(a) - ixg(b), and what the port
  refuses (the other archs: ``tests/test_torch_lm_zoo_*.py``).

Tolerances (relative to the reference's max |value|):

* f32: logits 1e-5 and scores 1e-4 — the same f32 arithmetic summed in
  another order (measured ~6e-7 and ~7e-6);
* bf16: logits 1e-2 and scores 5e-2.  The port rounds to bf16 after every
  operation, as the JAX package does eagerly (one eager layer is bitwise),
  but ``jax.jit`` fuses elementwise chains and rounds less often (~1e-3 to
  4e-3 on the logits), and the two autodiff systems round the bf16
  cotangents at different places in the backward (~2e-2 on the scores).

The port's scores always come from its B13 route.  ``repro``'s public
entry points (``explain_generated``, ``Engine.explain_tokens``) run its
B13 route in interpret mode; the mode x method grid runs ``repro``'s
chunked route (``scan_tiles=None``), the same function, for time.
``repro``'s own LM attribution fails under bf16 on the B13 route: its
``ref.selective_scan`` returns y in f32 whatever x is, so the backward's
cotangent (bf16, from the kernel's output) does not fit the vjp (ROADMAP
queue C); in bf16 every reference is therefore the chunked route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import engine as jengine
from repro import lm as jlm
from repro.engine import methods as jmethods
from repro.models import config as jconfig
from repro.models import transformer as jtf
from repro_torch import configs, lm
from repro_torch.engine import EngineSpec, LMModel, build
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

ARCH = "falcon-mamba-7b"
METHODS = ("saliency", "deconvnet", "guided")
MODES = ("ixg", "grad_norm", "contrastive")
TOL = {"float32": dict(logits=1e-5, scores=1e-4),
       "bfloat16": dict(logits=1e-2, scores=5e-2)}
PROMPT, NEW = 12, 3


class Setup:
    def __init__(self, dtype):
        self.dtype = dtype
        self.jcfg = jconfigs.get_smoke(ARCH).with_(dtype=dtype)
        self.cfg = configs.get_smoke(ARCH).with_(dtype=dtype)
        self.jp = jtf.init(jax.random.PRNGKey(0), self.jcfg)
        self.p = tf.params_from_jax(jax.tree.map(np.asarray, self.jp))
        self.toks = np.random.RandomState(1).randint(
            0, self.cfg.vocab, (2, PROMPT))
        self.tol = TOL[dtype]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    return Setup(request.param)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _jax_vjp(s, tokens, method):
    """One ``jax.vjp`` of ``repro``'s rule-bound forward on its chunked
    route (the same function as its B13 route, which ``repro``'s own
    ``test_mamba_core_pallas_path_matches_xla_path`` holds, at a fraction
    of the interpret-mode Pallas cost; the public entry points run the B13
    route in f32).  Returns ``(embeddings, logits, scores_fn)``:
    ``scores_fn(position, target_a, target_b, mode)`` seeds one position as
    ``repro.engine.methods.attribute_tokens[_contrastive]`` do and reduces
    as ``make_token_explain`` does, so several seeds share one forward."""
    h = jtf.embed_inputs(s.jp, s.jcfg, {"tokens": jnp.asarray(tokens)})
    logits, vjp_fn = jax.vjp(lambda e: jtf.forward_from_embeddings(
        s.jp, s.jcfg, e, method=method, remat=False)[0], h)

    def scores_fn(position, ta, tb, mode):
        def oh(t):
            return jax.nn.one_hot(jnp.asarray(t), logits.shape[-1],
                                  dtype=logits.dtype)
        seed_at = oh(ta) - oh(tb) if mode == "contrastive" else oh(ta)
        seed = jnp.zeros_like(logits).at[:, position, :].set(seed_at)
        (rel,) = vjp_fn(seed)
        rel = rel.astype(jnp.float32)
        if mode == "grad_norm":
            return jnp.linalg.norm(rel, axis=-1)
        return jnp.sum(rel * h.astype(jnp.float32), axis=-1)

    return h, logits, scores_fn


# -- config and parameters ---------------------------------------------------


def test_configs_match_repro():
    for name in ("FULL", "SMOKE"):
        want = getattr(jconfigs, "get" if name == "FULL" else "get_smoke")(
            ARCH)
        got = (configs.get if name == "FULL" else configs.get_smoke)(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = configs.get(ARCH)
    assert (full.d_inner, full.dtr, full.padded_vocab) == (8192, 256, 65024)
    assert full.torch_dtype == torch.bfloat16
    assert full.segments() == (("mamba", 64),)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_zoo_config_is_representable(arch):
    """Each config of the zoo, rebuilt in the port, plans and counts as
    the JAX package's."""
    want = jconfigs.get(arch)
    got = ModelConfig(**dataclasses.asdict(want))
    for prop in ("layer_plan", "segments", "param_count",
                 "active_param_count"):
        assert getattr(got, prop)() == getattr(want, prop)()
    for prop in ("hd", "d_inner", "dtr", "padded_vocab", "attention_free",
                 "sub_quadratic"):
        assert getattr(got, prop) == getattr(want, prop)
    assert got.with_(n_layers=2) == ModelConfig(
        **dataclasses.asdict(want.with_(n_layers=2)))
    assert isinstance(want, jconfig.ModelConfig)


def test_params_from_jax_is_a_bitwise_copy(setup):
    jleaves = jax.tree_util.tree_leaves(setup.jp)
    tleaves = jax.tree_util.tree_leaves(
        setup.p, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert len(jleaves) == len(tleaves) == 2 + 1 + 9 + 1
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j))


def test_init_draws_the_reference_tree_on_the_cpu(setup):
    p = tf.init(setup.cfg, generator=torch.Generator().manual_seed(3),
                device="cpu")
    want = jax.tree.map(lambda v: (v.shape, str(v.dtype)), setup.jp)
    got = jax.tree.map(lambda v: (tuple(v.shape),
                                  str(v.dtype).split(".")[-1]), p,
                       is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    layer = p["segments"][0]["mixer"]
    assert torch.equal(layer["A_log"][0], layer["A_log"][1])
    assert not torch.equal(layer["in_proj"][0], layer["in_proj"][1])


# -- forward, prefill, decode ------------------------------------------------


@pytest.mark.parametrize("route", ["kernel", "chunked"])
def test_forward_logits_match(setup, route):
    tiles = steps.ssm_scan_tiles(setup.cfg) if route == "kernel" else None
    jh = jtf.embed_inputs(setup.jp, setup.jcfg,
                          {"tokens": jnp.asarray(setup.toks)})
    th = tf.embed_inputs(setup.p, setup.cfg,
                         {"tokens": torch.from_numpy(setup.toks)})
    np.testing.assert_array_equal(_np(th), _np(jh))
    want = jax.jit(lambda p, h: jtf.forward_from_embeddings(
        p, setup.jcfg, h, scan_tiles=tiles)[0])(setup.jp, jh)
    got = tf.forward_from_embeddings(setup.p, setup.cfg, th,
                                     scan_tiles=tiles)[0]
    assert got.dtype == torch.float32
    _close(got, want, setup.tol["logits"])
    full = tf.forward(setup.p, setup.cfg,
                      {"tokens": torch.from_numpy(setup.toks)})[0]
    _close(full, want, setup.tol["logits"])


def test_prefill_and_decode_step_match(setup):
    b = setup.toks.shape[0]
    jc = jtf.init_cache(setup.jcfg, b, PROMPT + 4)
    jl, jc = jtf.prefill(setup.jp, setup.jcfg,
                         {"tokens": jnp.asarray(setup.toks)}, jc)
    tc = tf.init_cache(setup.cfg, b, PROMPT + 4, device="cpu")
    tl, tc = tf.prefill(setup.p, setup.cfg,
                        {"tokens": torch.from_numpy(setup.toks)}, tc)
    _close(tl, jl, setup.tol["logits"])
    nxt = np.argmax(np.asarray(jl[:, -1]), axis=-1)[:, None]
    jl2, jc2 = jtf.decode_step(setup.jp, setup.jcfg, jnp.asarray(nxt), jc,
                               jnp.asarray(PROMPT, jnp.int32))
    tl2, tc2 = tf.decode_step(setup.p, setup.cfg, torch.from_numpy(nxt), tc,
                              PROMPT)
    _close(tl2, jl2, setup.tol["logits"])
    for key in ("h", "conv"):
        assert tc2[0][key].dtype == (torch.float32 if key == "h"
                                     else setup.cfg.torch_dtype)
        _close(tc2[0][key], jc2[0][key], setup.tol["logits"])


def test_greedy_decode_tokens_match(setup):
    want = jlm.decode(setup.jp, setup.jcfg, jnp.asarray(setup.toks),
                      max_new=NEW + 2)
    got = lm.decode(setup.p, setup.cfg, torch.from_numpy(setup.toks),
                    max_new=NEW + 2)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.runners_up.numpy(),
                                  np.asarray(want.runners_up))
    assert got.prompt_len == PROMPT and got.generated.shape == (2, NEW + 2)
    again = lm.decode(setup.p, setup.cfg, setup.toks, max_new=NEW + 2)
    assert torch.equal(again.tokens, got.tokens)


def test_sampled_decode_follows_its_generator(setup):
    def run(seed):
        return lm.decode(setup.p, setup.cfg, setup.toks, max_new=4,
                         temperature=0.8,
                         generator=torch.Generator().manual_seed(seed))
    a, b = run(3), run(3)
    assert torch.equal(a.tokens, b.tokens)
    assert bool((a.generated != a.runners_up).all())
    with pytest.raises(ValueError):
        lm.decode(setup.p, setup.cfg, setup.toks, max_new=0)


# -- per-token attribution -----------------------------------------------------


@pytest.fixture(scope="module")
def decoded(setup):
    return lm.decode(setup.p, setup.cfg, setup.toks, max_new=NEW)


def test_explain_generated_matches(setup, decoded):
    got = lm.explain_generated(setup.p, setup.cfg, decoded)
    s_full = PROMPT + NEW
    assert tuple(got.shape) == (2, NEW, s_full)
    toks = decoded.tokens.numpy()
    if setup.dtype == "float32":        # the public entry point itself
        r = jlm.DecodeResult(tokens=jnp.asarray(toks, jnp.int32),
                             runners_up=jnp.asarray(decoded.runners_up),
                             prompt_len=PROMPT)
        want = jlm.explain_generated(setup.jp, setup.jcfg, r)
    else:
        scores_fn = _jax_vjp(setup, toks, "saliency")[2]
        want = jnp.stack([scores_fn(
            PROMPT - 1 + t, toks[:, PROMPT + t],
            decoded.runners_up[:, t].numpy(), "contrastive")
            for t in range(NEW)], axis=1)
    _close(got, want, setup.tol["scores"])
    for t in range(NEW):                # exact causal zeros
        assert bool((got[:, t, PROMPT + t:] == 0).all())
        assert bool((got[:, t, :PROMPT + t] != 0).any())


@pytest.fixture(scope="module")
def jax_grid(setup, decoded):
    """``repro``'s scores of generated token 1 for every method x mode."""
    toks = decoded.tokens.numpy()
    ta, tb = toks[:, PROMPT + 1], decoded.runners_up[:, 1].numpy()
    grid = {}
    for method in METHODS:
        scores_fn = _jax_vjp(setup, toks, method)[2]
        for mode in MODES:
            grid[method, mode] = scores_fn(PROMPT, ta, tb, mode)
    return grid


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_token_explain_matches(setup, decoded, jax_grid, method, mode):
    toks = decoded.tokens
    pos = PROMPT                        # explains generated token 1
    ta, tb = toks[:, pos + 1], decoded.runners_up[:, 1]
    got = lm.make_token_explain(setup.cfg, method, mode=mode)(
        setup.p, toks, pos, ta, tb)
    _close(got, jax_grid[method, mode], setup.tol["scores"])
    assert bool((got[:, pos + 1:] == 0).all())


def test_contrastive_is_the_ixg_difference(setup, decoded):
    toks, pos = decoded.tokens, PROMPT
    ta, tb = toks[:, pos + 1], decoded.runners_up[:, 1]
    ixg = lm.make_token_explain(setup.cfg, mode="ixg")
    con = lm.make_token_explain(setup.cfg, mode="contrastive")(
        setup.p, toks, pos, ta, tb)
    diff = ixg(setup.p, toks, pos, ta, None) - ixg(setup.p, toks, pos, tb,
                                                   None)
    _close(con, diff, 1e-5 if setup.dtype == "float32" else 5e-2)


@pytest.mark.parametrize("mode", MODES)
def test_engine_explain_tokens_matches(setup, mode):
    eng = build(EngineSpec(LMModel(setup.p, setup.cfg, device="cpu"),
                           method="guided"))
    assert build(EngineSpec(LMModel(setup.p, setup.cfg, device="cpu"),
                            method="guided")) is eng      # params by id
    logits, scores = eng.explain_tokens({"tokens": setup.toks}, mode=mode)
    assert tuple(logits.shape) == (2, setup.cfg.vocab)
    if setup.dtype == "float32":
        jeng = jengine.build(jengine.EngineSpec(
            model=jengine.LMModel(setup.jp, setup.jcfg), method="guided"))
        jlogits, jscores = jeng.explain_tokens(
            {"tokens": jnp.asarray(setup.toks)}, mode=mode)
        _close(logits, jlogits, setup.tol["logits"])
    else:
        f = lambda e: jtf.forward_from_embeddings(    # noqa: E731
            setup.jp, setup.jcfg, e, method="guided")[0]
        h = jtf.embed_inputs(setup.jp, setup.jcfg,
                             {"tokens": jnp.asarray(setup.toks)})
        if mode == "contrastive":
            _, _, jscores = jmethods.attribute_tokens_contrastive(f, h)
        else:
            _, rel, jscores = jmethods.attribute_tokens(f, h)
            if mode == "grad_norm":
                jscores = jnp.linalg.norm(rel.astype(jnp.float32), axis=-1)
        # the last position's logits of the same forward
        _close(logits, jtf.forward_from_embeddings(
            setup.jp, setup.jcfg, h)[0][:, -1], setup.tol["logits"])
    _close(scores, jscores, setup.tol["scores"])


# -- what the port refuses ------------------------------------------------------


def test_unported_knobs_and_handles_raise(setup):
    """What the port refuses.  fxp16 needs a seed-batched pair, which no
    LM has: the spec builds and its backend resolution raises the JAX
    package's ValueError, in both packages (``repro``'s build then goes
    on to run the LM's own dtype; the port's build raises)."""
    p, cfg = setup.p, setup.cfg
    spec = EngineSpec(LMModel(p, cfg, device="cpu"), precision="fxp16")
    jspec = jengine.EngineSpec(jengine.LMModel(setup.jp, setup.jcfg),
                               precision="fxp16")
    for s in (spec, jspec):
        with pytest.raises(ValueError, match="seed-batched pair"):
            s.resolve_backward()
    with pytest.raises(ValueError, match="seed-batched pair"):
        build(spec)
    with pytest.raises(ValueError, match="gradient rule set"):
        build(EngineSpec(LMModel(p, cfg, device="cpu"), method="occlusion"))
    # an LM engine on a mesh device builds unsharded, as repro's does
    eng = build(EngineSpec(LMModel(p, cfg, device="cpu"),
                           device="mesh:edge-small:2"))
    assert eng.n_shards == 1 and eng.mesh is None
    with pytest.raises(ValueError, match="mode"):
        lm.make_token_explain(cfg, mode="nope")
    from repro_torch.engine import CNNModel
    from repro_torch.models import cnn
    ccfg = cnn.CNNConfig(in_hw=(8, 8), channels=(4, 4), fc=(8,),
                         num_classes=4)
    ceng = build(EngineSpec(CNNModel(cnn.init(torch.Generator(), ccfg),
                                     ccfg, device="cpu")))
    with pytest.raises(ValueError, match="LMModel"):
        ceng.explain_tokens({"tokens": setup.toks})


def test_bf16_lm_adapter_matches_repro(setup, monkeypatch):
    """``precision="bf16"`` on an LM, as the JAX package takes it: the spec
    resolves to vjp and the step runs the LM's own dtype (its config's),
    so the bf16 adapter's explains are bitwise the f32 engine's; on the
    float32 config they match ``repro.lm.LMAdapter(precision="bf16")``
    (its bf16 LM explain fails on its B13 route: ROADMAP C).  fxp16: the
    port's adapter raises the ValueError of the backend resolution."""
    from repro_torch.engine import spec as spec_mod
    real = spec_mod.resolve_device
    monkeypatch.setattr(spec_mod, "resolve_device",
                        lambda d: real("cpu" if d is None else d))
    ad = lm.LMAdapter(setup.p, setup.cfg, precision="bf16")
    jad = jlm.LMAdapter(setup.jp, setup.jcfg, precision="bf16")
    assert ad.precision == jad.precision == "bf16"
    assert ad.engine.spec.resolve_backward() == \
        jad.engine.spec.resolve_backward() == "vjp"
    assert ad.with_precision("f32").precision == "f32"
    f32 = build(EngineSpec(LMModel(setup.p, setup.cfg, device="cpu")))
    batch = {"tokens": setup.toks}
    logits, scores = ad.engine.explain_tokens(batch)
    for a, b in zip((logits, scores), f32.explain_tokens(batch)):
        assert torch.equal(a, b)
    if setup.dtype == "float32":
        jlogits, jscores = jad.engine.explain_tokens(
            {"tokens": jnp.asarray(setup.toks)})
        _close(logits, jlogits, setup.tol["logits"])
        _close(scores, jscores, setup.tol["scores"])
    with pytest.raises(ValueError, match="seed-batched pair"):
        lm.LMAdapter(setup.p, setup.cfg, precision="fxp16")


def test_lm_model_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        assert LMModel(setup.p, setup.cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        LMModel(setup.p, setup.cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init(setup.cfg)
