"""The vjp engine, the composite methods and AdamW of repro_torch against
the JAX package (CPU), and the paper's memory claim on the autograd path.

* backend resolution as ``repro.engine.spec`` resolves it;
* explain (argmax and top-k) through ``backward="vjp"`` on the fused
  kernel blocks, on the reference ops (``use_pallas=False``) and through
  an ``FnModel`` over the standalone kernel ops, against the JAX engine of
  the same spec: logits within 1e-5 * max, relevance within 1e-4 * max;
* ``attribute_classes``, ``ig``, ``input_x_gradient``, ``contrastive`` and
  ``fold_batched_gradients`` against the JAX engine and methods, on the
  vjp and the seed-batched engine (whose f32 composites run autograd
  through the fused blocks) and under fxp16 (manual ``backward=``);
  ``smoothgrad`` on noise drawn from a ``torch.Generator``, held against
  the JAX fold of the same noisy inputs;
* under ``saved_tensors_hooks``, a saliency vjp explain through either
  kernel branch saves no float tensor besides the weights, and exactly
  the packed mask and crumb bytes of ``forward_with_residuals``;
* two AdamW steps (and the clip and schedule helpers) against
  ``repro.optim``, rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import optim as joptim
from repro.engine import methods as jmethods
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch import optim
from repro_torch.core import attribution
from repro_torch.engine import (CNNModel, EngineSpec, FnModel, TopK, build,
                                methods)
from repro_torch.models import cnn

KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)
METHODS = ("saliency", "deconvnet", "guided")
KINDS = ("fused", "reference", "fn")
LOGIT_TOL, REL_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def setup():
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(3, 8, 8, 3).astype(np.float32)
    tengine.clear_cache()
    yield jparams, params, x
    tengine.clear_cache()


def _models(kind, jparams, params):
    """The same model handle in each package."""
    if kind == "fn":
        def tmake(m):
            return lambda v: cnn.apply(params, v, CFG, method=m,
                                       use_pallas=True, fused=False)

        def jmake(m):
            return lambda v: jcnn.apply(jparams, v, JCFG, method=m,
                                        use_pallas=True, fused=False)

        return FnModel(tmake, device="cpu"), jengine.FnModel(jmake)
    up = kind == "fused"
    return (CNNModel(params, CFG, use_pallas=up, device="cpu"),
            jengine.CNNModel(jparams, JCFG, use_pallas=up))


def _engines(setup, kind, **spec):
    jparams, params, _ = setup
    tm, jm = _models(kind, jparams, params)
    if kind == "fused":
        spec.setdefault("backward", "vjp")
    jspec = {k: (jengine.TopK(v.k) if isinstance(v, TopK) else v)
             for k, v in spec.items()}
    return build(EngineSpec(tm, **spec)), jengine.build(
        jengine.EngineSpec(jm, **jspec))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- backend resolution --------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backward", ["auto", "vjp", "seed_batched"])
def test_backend_resolution_matches_reference(setup, kind, backward):
    jparams, params, _ = setup
    tm, jm = _models(kind, jparams, params)
    tspec = EngineSpec(tm, backward=backward)
    jspec = jengine.EngineSpec(jm, backward=backward)
    assert tspec.resolve_backward() == jspec.resolve_backward()
    if tspec.resolve_backward() == "seed_batched" and not tm.has_pair:
        with pytest.raises(ValueError, match="no seed-batched pair"):
            build(tspec)
    else:
        eng = build(tspec)
        assert eng.supports_replay == (tspec.resolve_backward()
                                       == "seed_batched")


def test_fxp16_needs_the_pair(setup):
    jparams, params, _ = setup
    for kind in ("reference", "fn"):
        tm, _ = _models(kind, jparams, params)
        with pytest.raises(ValueError):
            build(EngineSpec(tm, precision="fxp16"))
    with pytest.raises(ValueError, match="integer arithmetic"):
        EngineSpec(_models("fused", jparams, params)[0], precision="fxp16",
                   backward="vjp")


def test_use_pallas_is_part_of_the_spec(setup):
    _, params, _ = setup
    a = build(EngineSpec(CNNModel(params, CFG, device="cpu")))
    b = build(EngineSpec(CNNModel(params, CFG, use_pallas=False,
                                  device="cpu")))
    assert a is not b
    assert build(EngineSpec(CNNModel(params, CFG, device="cpu"))) is a


# -- explain through the vjp backend -------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_vjp_explain_matches_jax_engine(setup, kind, method):
    x = setup[2]
    teng, jeng = _engines(setup, kind, method=method, targets=TopK(2))
    assert not teng.supports_replay and not jeng.supports_replay
    tl, trel = teng.explain(x)
    jl, jrel = jeng.explain(jnp.asarray(x))
    assert tuple(trel.shape) == jrel.shape == (2, 3, 8, 8, 3)
    _close(tl, jl, LOGIT_TOL)
    _close(trel, jrel, REL_TOL)
    tl, trel = teng.explain(x, target=[1, 0, 2])       # scalar fan-out
    jl, jrel = jeng.explain(jnp.asarray(x), target=jnp.asarray([1, 0, 2]))
    _close(trel, jrel, REL_TOL)


@pytest.mark.parametrize("method", METHODS)
def test_vjp_on_the_fused_blocks_equals_the_seed_batched_pair(setup, method):
    _, params, x = setup
    model = CNNModel(params, CFG, device="cpu")
    pair = build(EngineSpec(model, method=method, targets=TopK(3)))
    vjp = build(EngineSpec(model, method=method, targets=TopK(3),
                           backward="vjp"))
    pl, prel = pair.explain(x)
    vl, vrel = vjp.explain(x)
    assert torch.equal(pl, vl)
    _close(vrel, prel.numpy(), LOGIT_TOL)
    # the two-phase form: the "residuals" are the input, replayed
    logits, rel, res = vjp.predict_then_explain(x)
    seeds, _ = vjp._seeds(logits, None, 3)
    assert torch.equal(vjp.replay(res, seeds), rel)
    assert torch.equal(vjp.predict(x), logits)


# -- composite methods ---------------------------------------------------------


@pytest.mark.parametrize("backward", ["vjp", "seed_batched"])
def test_composites_match_jax_engine(setup, backward):
    x = setup[2]
    teng, jeng = _engines(setup, "fused", method="guided", backward=backward)
    jx = jnp.asarray(x)
    tl, trel = teng.attribute_classes(x, [0, 3])
    jl, jrel = jeng.attribute_classes(jx, jnp.asarray([0, 3]))
    _close(tl, jl, LOGIT_TOL)
    _close(trel, jrel, REL_TOL)
    for batched in (True, False):
        _, tig = teng.ig(x, steps=4, batched=batched)
        _, jig = jeng.ig(jx, steps=4, batched=batched)
        _close(tig, jig, REL_TOL)
    _, tixg = teng.input_x_gradient(x, target=2)
    _, jixg = jeng.input_x_gradient(jx, target=jnp.full((3,), 2))
    _close(tixg, jixg, REL_TOL)
    _, tc = teng.contrastive(x, 1, 4)      # JAX takes per-example targets
    _, jc = jeng.contrastive(jx, jnp.full((3,), 1), jnp.full((3,), 4))
    _close(tc, jc, REL_TOL)


def test_smoothgrad_and_fold_match_jax_on_shared_noise(setup):
    x = setup[2]
    teng, jeng = _engines(setup, "fused", method="saliency")
    n, sigma = 3, 0.2
    _, sg = teng.smoothgrad(x, torch.Generator().manual_seed(7), n=n,
                            sigma=sigma)
    noise = torch.randn((n,) + x.shape, generator=torch.Generator()
                        .manual_seed(7))
    xs = (torch.from_numpy(x) + sigma * noise).numpy().copy()
    target = np.array(jnp.argmax(jeng.predict(jnp.asarray(x)), -1))
    jgrads = jmethods.fold_batched_gradients(
        jeng.model_fn, jnp.asarray(xs), jnp.asarray(target), (3,))
    tgrads = methods.fold_batched_gradients(
        teng.model_fn, torch.from_numpy(xs), torch.from_numpy(target), (3,))
    _close(tgrads, jgrads, REL_TOL)
    _close(sg, np.asarray(jgrads).mean(axis=0), REL_TOL)
    _, seq = teng.smoothgrad(x, torch.Generator().manual_seed(7), n=n,
                             sigma=sigma, batched=False)
    _close(seq, sg.numpy(), LOGIT_TOL)


def test_fxp16_composites_ride_the_manual_pair(setup):
    x = setup[2]
    teng, jeng = _engines(setup, "fused", method="saliency",
                          precision="fxp16", backward="auto")
    assert teng.composite_backward is not None
    jx = jnp.asarray(x)
    _, tig = teng.ig(x, steps=3)
    _, jig = jeng.ig(jx, steps=3)
    _close(tig, jig, 1e-6)
    tl, tc = teng.contrastive(x, 0, 1)
    jl, jc = jeng.contrastive(jx, jnp.zeros(3, jnp.int32),
                              jnp.ones(3, jnp.int32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_free_functions_and_heatmap(setup):
    jparams, params, x = setup

    def f(v):
        return cnn.apply(params, v, CFG, method="saliency", use_pallas=True)

    def jf(v):
        return jcnn.apply(jparams, v, JCFG, method="saliency",
                          use_pallas=True)

    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tl, trel = attribution.attribute(f, tx)
    jl, jrel = jmethods.attribute(jf, jx)
    _close(trel, jrel, REL_TOL)
    np.testing.assert_array_equal(
        methods.output_seed(tl).numpy(),
        np.asarray(jmethods.output_seed(jnp.asarray(tl.numpy()))))
    _close(methods.heatmap(trel), jmethods.heatmap(jrel), REL_TOL)
    hm = methods.heatmap({"a": trel, "b": -trel}, absolute=False)
    assert set(hm) == {"a", "b"} and tuple(hm["a"].shape) == (3, 8, 8)


# -- the memory claim ----------------------------------------------------------


def _saved_during(fn):
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        fn()
    return saved


@pytest.mark.parametrize("kind", ["fused", "fn"])
def test_vjp_explain_saves_only_packed_state(setup, kind):
    """Paper §V: the backward pass needs the 1-bit masks and 2-bit crumbs,
    not the activations.  Parameters closed over (no grad), the graph of a
    saliency explain holds the weights and exactly the packed bytes that
    ``forward_with_residuals`` stores."""
    jparams, params, x = setup
    tm, _ = _models(kind, jparams, params)
    eng = build(EngineSpec(tm, method="saliency", backward="vjp"))
    saved = _saved_during(lambda: eng.explain(x))
    weights = {t.data_ptr() for q in params["conv"] + params["fc"]
               for t in q.values()}
    state = [t for t in saved if t.data_ptr() not in weights]
    assert state and all(t.dtype == torch.uint8 for t in state)
    _, res = cnn.forward_with_residuals(params, torch.from_numpy(x), CFG,
                                        "saliency")
    packed = [t for m, i in res["conv"] for t in (m, i) if t is not None]
    packed += [m for m in res["fc"] if m is not None]
    assert sum(t.numel() for t in state) == sum(t.numel() for t in packed)


# -- AdamW ---------------------------------------------------------------------


def test_two_adamw_steps_match_reference():
    rs = np.random.RandomState(3)
    tree = {"conv": [{"w": rs.randn(3, 3, 2, 4), "b": rs.randn(4)}],
            "fc": [{"w": rs.randn(8, 5), "b": rs.randn(5)}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: (rs.randn(*a.shape) * 0.1)
                          .astype(np.float32), tree) for _ in range(2)]

    def t(tr):
        return jax.tree.map(torch.from_numpy, tr)

    jp, js = jax.tree.map(jnp.asarray, tree), joptim.adamw_init(tree)
    tp, ts = t(tree), optim.adamw_init(t(tree))
    for step, g in enumerate(grads):
        lr = joptim.cosine_schedule(jnp.asarray(step + 1), peak_lr=1e-2,
                                    warmup_steps=1, total_steps=4)
        tlr = optim.cosine_schedule(torch.tensor(step + 1), peak_lr=1e-2,
                                    warmup_steps=1, total_steps=4)
        np.testing.assert_allclose(tlr.numpy(), np.asarray(lr), rtol=1e-6)
        jg, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                               0.5)
        tg, tnorm = optim.clip_by_global_norm(t(g), 0.5)
        np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm),
                                   rtol=1e-6)
        jp, js = joptim.adamw_update(jg, js, jp, lr=lr)
        tp, ts = optim.adamw_update(tg, ts, tp, lr=tlr)
    assert int(ts.step) == int(js.step) == 2
    for got, want in zip(jax.tree.leaves(jax.tree.map(
            lambda a: a.numpy(), (tp, ts.mu, ts.nu))),
            jax.tree.leaves((jp, js.mu, js.nu))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
