"""repro_torch.engine against repro.engine: build cache, target fan-out,
batch padding, replay, and the knobs the port does not run yet.

Fan-out and padding are held against the JAX engine's own helpers on the
same logits and arrays, and one padded top-K explain end to end against
the JAX engine on the same NumPy inputs.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch.engine import (CNNModel, EngineSpec, Fixed, FnModel,
                                TopK, build)
from repro_torch.models import cnn

KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)


@pytest.fixture(scope="module")
def setup():
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(3, 8, 8, 3).astype(np.float32)
    tengine.clear_cache()
    yield jparams, params, x
    tengine.clear_cache()


def spec_for(params, **kw):
    kw.setdefault("model", CNNModel(params, CFG, device="cpu"))
    return EngineSpec(**kw)


# -- build cache -------------------------------------------------------------


def test_equal_specs_share_one_engine(setup):
    _, params, _ = setup
    a = build(spec_for(params, method="guided", targets=TopK(2)))
    b = build(spec_for(params, method="guided", targets=TopK(2)))
    assert a is b


@pytest.mark.parametrize("change", [
    dict(method="deconvnet"), dict(targets=TopK(3)), dict(targets=Fixed(1)),
    dict(batch=4), dict(backward="seed_batched"),
])
def test_changing_a_spec_field_rebuilds(setup, change):
    _, params, _ = setup
    spec = spec_for(params)
    assert build(replace(spec, **change)) is not build(spec)


def test_model_identity_not_value_drives_the_cache(setup):
    _, params, _ = setup
    same = build(spec_for(params))
    assert build(spec_for(params)) is same
    copy = {k: [dict(p) for p in v] for k, v in params.items()}
    assert build(spec_for(copy)) is not same


def test_clear_cache_forces_fresh_build(setup):
    _, params, _ = setup
    a = build(spec_for(params))
    assert tengine.cache_size() >= 1
    tengine.clear_cache()
    assert tengine.cache_size() == 0
    assert build(spec_for(params)) is not a


# -- fan-out and padding vs the JAX engine's helpers -------------------------


@pytest.mark.parametrize("target,topk", [(None, None), (2, None),
                                         ([0, 3, 1], None), (None, 3)])
def test_seeds_match_reference(setup, target, topk):
    jparams, params, _ = setup
    logits = np.random.RandomState(4).randn(3, 10).astype(np.float32)
    jeng = jengine.Engine(jengine.EngineSpec(jengine.CNNModel(jparams, JCFG)))
    teng = build(spec_for(params))
    js, jsq = jeng._seeds(jnp.asarray(logits), target, topk)
    ts, tsq = teng._seeds(torch.from_numpy(logits), target, topk)
    assert jsq == tsq
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _targets(kind, *args):
    """The same target policy in each package's own classes."""
    return getattr(tengine, kind)(*args), getattr(jengine, kind)(*args)


@pytest.mark.parametrize("targets,call", [
    (("Argmax",), {}), (("Fixed", 2), {}), (("TopK", 3), {}),
    (("Argmax",), {"topk": 2}), (("TopK", 2), {"target": 1}),
])
def test_fanout_resolution_matches_reference(setup, targets, call):
    jparams, params, _ = setup
    tt, jt = _targets(*targets)
    jeng = jengine.Engine(jengine.EngineSpec(
        jengine.CNNModel(jparams, JCFG), targets=jt))
    teng = build(spec_for(params, targets=tt))
    assert teng._fanout(call.get("target"), call.get("topk")) == \
        jeng._fanout(call.get("target"), call.get("topk"))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_padding_matches_reference(setup, n):
    jparams, params, x = setup
    xs = np.concatenate([x, x])[:n]
    jeng = jengine.Engine(jengine.EngineSpec(
        jengine.CNNModel(jparams, JCFG), batch=4))
    teng = build(spec_for(params, batch=4))
    jx, jlive = jeng._pad(jnp.asarray(xs))
    tx, tlive = teng._pad(torch.from_numpy(xs))
    assert jlive == tlive == n
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    t = np.arange(n)
    np.testing.assert_array_equal(teng._pad_target(t, tlive).numpy(),
                                  np.asarray(jeng._pad_target(t, jlive)))
    np.testing.assert_array_equal(teng._unpad(tx, tlive).numpy(), xs)
    with pytest.raises(ValueError):
        teng._pad(torch.zeros(5, 8, 8, 3))


@pytest.mark.parametrize("grid", [True, False])
def test_topk_seeds_follow_lax_top_k_tie_order(setup, grid):
    """Ties (common on the fxp16 logits grid of 2^-8) and signed zeros go
    in ``jax.lax.top_k``'s order: lower index first, +0 above -0."""
    jparams, params, _ = setup
    rs = np.random.RandomState(12)
    if grid:
        logits = (rs.randint(-6, 7, size=(64, 10)) / 256.0)
    else:
        logits = rs.choice([-1.5, -0.0, 0.0, 2.0], size=(64, 10))
    logits = logits.astype(np.float32)
    jeng = jengine.Engine(jengine.EngineSpec(jengine.CNNModel(jparams, JCFG)))
    teng = build(spec_for(params))
    for k in (1, 3, 10):
        js, _ = jeng._seeds(jnp.asarray(logits), None, k)
        ts, _ = teng._seeds(torch.from_numpy(logits), None, k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_padded_topk_explain_matches_jax_engine(setup):
    jparams, params, x = setup
    jl, jrel = jengine.build(jengine.EngineSpec(
        jengine.CNNModel(jparams, JCFG), method="guided",
        targets=jengine.TopK(2), batch=4)).explain(jnp.asarray(x))
    tl, trel = build(spec_for(params, method="guided", targets=TopK(2),
                              batch=4)).explain(x)
    assert tuple(trel.shape) == jrel.shape == (2, 3, 8, 8, 3)
    jl, jrel = np.asarray(jl), np.asarray(jrel)
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    assert np.abs(trel.numpy() - jrel).max() <= 1e-4 * np.abs(jrel).max()


# -- the two phases ------------------------------------------------------------


def test_replay_equals_cold_explain_bitwise(setup):
    _, params, x = setup
    eng = build(spec_for(params, method="saliency"))
    logits, rel, res = eng.predict_then_explain(x)
    assert torch.equal(eng.predict(x), logits)
    other = (torch.argmax(logits, -1) + 1) % CFG.num_classes
    seeds = torch.nn.functional.one_hot(other, CFG.num_classes).float()
    replayed = eng.replay(res, seeds[None])[0]
    _, cold = eng.explain(x, target=other)
    assert torch.equal(replayed, cold)
    assert not torch.equal(replayed, rel)


# -- what the port does not run yet ------------------------------------------


def _fn_model_bf16(params, jparams):
    """An FnModel over the reference ops in bf16, in each package."""
    return (FnModel(lambda m: lambda v: cnn.apply(
        params, v, CFG, method=m, precision="bf16"), device="cpu"),
        jengine.FnModel(lambda m: lambda v: jcnn.apply(
            jparams, v, JCFG, method=m, precision="bf16")))


@pytest.mark.parametrize("kw,item", [
    # bf16 under vjp (ROADMAP A6d) is ported: it runs and matches repro
    (dict(precision="bf16", backward="vjp"), "A6"),
    # a model with no seed-batched pair resolves to vjp
    (dict(precision="bf16", model="fn"), "A6"),
    (dict(model=object()), "A11"),
    # the tile planner's knobs run (tests/test_torch_plan_engine.py); a
    # mesh of several shards builds a data-parallel engine (A12b), here on
    # the one rank of a process without a group
    (dict(device="mesh:edge-small:4"), "A12"),
])
def test_unported_knobs_raise(setup, kw, item):
    jparams, params, x = setup
    kw = dict(kw)
    if item == "A12":
        eng = build(spec_for(params, **kw))
        base = build(spec_for(params, device="edge-small"))
        assert eng.n_shards == 4 and eng.mesh.size == 1
        for a, b in zip(eng.explain(x), base.explain(x)):
            assert torch.equal(a, b)
        return
    if item != "A6":
        with pytest.raises(NotImplementedError, match=item):
            spec_for(params, **kw)
        return
    jmodel = jengine.CNNModel(jparams, JCFG)
    if kw.get("model") == "fn":
        kw["model"], jmodel = _fn_model_bf16(params, jparams)
    spec = spec_for(params, **kw)
    jspec = jengine.EngineSpec(jmodel, **{k: v for k, v in kw.items()
                                          if k != "model"})
    assert spec.resolve_backward() == jspec.resolve_backward() == "vjp"
    logits, rel = build(spec).explain(x)
    jlogits, jrel = jengine.build(jspec).explain(jnp.asarray(x))
    assert logits.dtype == torch.bfloat16 and rel.dtype == torch.float32
    assert jlogits.dtype == jnp.bfloat16 and jrel.dtype == jnp.float32
    for t, j in ((logits, jlogits), (rel, jrel)):
        j = np.asarray(j.astype(jnp.float32))
        assert np.abs(t.float().numpy() - j).max() <= 2.0 ** -6 * \
            np.abs(j).max()


def test_bad_values_still_raise_value_error(setup):
    _, params, _ = setup
    for kw in (dict(method="nope"), dict(precision="f64"),
               dict(backward="nope"), dict(batch=0)):
        with pytest.raises(ValueError):
            spec_for(params, **kw)


def test_model_without_cuda_refuses_to_run_on_cpu(setup, monkeypatch):
    _, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNModel(params, CFG)
    with pytest.raises(RuntimeError):
        CNNModel(params, CFG, device="cuda")
    assert CNNModel(params, CFG, device="cpu").device == torch.device("cpu")
