"""repro_torch.perturb against repro.perturb on the CPU: the masks, the fold
and its scores, the three explainers in the three precisions,
``Engine.perturb``, the spec, and the serve explainers.

Both packages run on the same parameters (``repro``'s ``cnn.init``, copied
by ``params_from_jax``) and the same NumPy inputs at the tiny config of
``tests/test_perturb.py`` (8x8 inputs, channels (4, 4), FC 16, N = 8);
``repro``'s Pallas path runs in interpret mode, as its own tests run it.
A torch generator cannot replay a JAX key, so the stochastic methods are
held to the reference on its own ``MaskSet``s (``masks=``), moved byte for
byte, and the port's generators are checked statistically.  Tolerances,
relative to the reference's max |value|:

  * occlusion masks: byte for byte; LIME masks densify exactly;
  * RISE ``dense()``: within 1e-6 absolute (the bilinear upsample as the
    product of per-axis weight matrices, summed in another order than
    ``jax.image.resize``: observed 2.4e-7);
  * f32: logits and occlusion / RISE heat 1e-5, LIME heat 1e-4 (a ridge
    solve by another LU);
  * bf16: 2^-6 (``tests/test_torch_cnn_bf16.py``'s bound);
  * fxp16: logits and per-mask scores bitwise, occlusion and RISE heat
    bitwise (RISE on the reference's dense masks, as one unit in the last
    place of a mask can flip a rounding of the int16 input), LIME heat
    1e-4 (the solve).

``Engine.perturb``: the fold against the sequential path bitwise under
fxp16; under f32 and bf16 within 1e-5 / 2^-6 (on the card the FC forward
splits K by the batch, so a fold of N x B rows sums FC0 in another order
than B rows: ROADMAP C).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro import engine as jengine
from repro import perturb as jperturb
from repro.models import cnn as jcnn
import repro_torch.serve as tserve
from repro_torch import engine as tengine
from repro_torch import perturb
from repro_torch.engine import CNNModel, EngineSpec, FnModel, build, methods
from repro_torch.models import cnn

ROOT = Path(__file__).resolve().parents[1]
KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)
HW = (8, 8)
N = 8
OPTS = {"occlusion": dict(window=2, stride=2), "lime": dict(cells=4),
        "rise": dict(grid=3)}
PRECISIONS = ("f32", "bf16", "fxp16")
TOL = {"f32": 1e-5, "bf16": 2.0 ** -6, "fxp16": 0.0}


@pytest.fixture(scope="module")
def setup():
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    tengine.clear_cache()
    yield jparams, params, x
    tengine.clear_cache()


def engines(setup, precision, method="occlusion", **kw):
    jparams, params, _ = setup
    jeng = jengine.build(jengine.EngineSpec(
        model=jengine.CNNModel(jparams, JCFG), method=method,
        precision=precision, **kw))
    teng = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                            method=method, precision=precision, **kw))
    return jeng, teng


def host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def close(got, want, tol, what=""):
    got, want = host(got), host(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def port_masks(ms) -> perturb.MaskSet:
    """A reference MaskSet as the port's, byte for byte."""
    return perturb.MaskSet(
        kind=ms.kind, packed=torch.from_numpy(np.array(ms.packed)),
        n_cells=ms.n_cells, grid=ms.grid, hw=ms.hw,
        shifts=(None if ms.shifts is None
                else torch.from_numpy(np.array(ms.shifts))))


def ref_masks(method, key=3, n=N, hw=HW):
    if method == "occlusion":
        return jperturb.occlusion_masks(hw, **OPTS[method])
    fn = getattr(jperturb, f"{method}_masks")
    return fn(jax.random.PRNGKey(key), n, hw, **OPTS[method])


# -- masks --------------------------------------------------------------------


@pytest.mark.parametrize("hw,window,stride", [((8, 8), 2, 2), ((8, 8), 3, 1),
                                              ((32, 32), 4, 2),
                                              ((28, 20), 5, None)])
def test_occlusion_masks_equal_repro_byte_for_byte(hw, window, stride):
    want = jperturb.occlusion_masks(hw, window=window, stride=stride)
    got = perturb.occlusion_masks(hw, window=window, stride=stride)
    assert got.packed.dtype == torch.uint8
    assert np.array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert (got.n_cells, got.grid, got.hw, got.n_masks, got.nbytes) == (
        want.n_cells, want.grid, want.hw, want.n_masks, want.nbytes)
    assert np.array_equal(got.dense().numpy(), np.asarray(want.dense()))
    assert perturb.occlusion_positions(
        hw, window=window, stride=stride or window) == \
        jperturb.occlusion_positions(hw, window=window,
                                     stride=stride or window)


def test_occlusion_and_lime_refuse_bad_geometry():
    with pytest.raises(ValueError, match="exceeds"):
        perturb.occlusion_masks(HW, window=9)
    with pytest.raises(ValueError, match="divisible"):
        perturb.lime_masks(torch.Generator().manual_seed(0), N, HW, cells=3)


@pytest.mark.parametrize("method", ["lime", "rise"])
def test_reference_masksets_move_byte_for_byte(method):
    ms = ref_masks(method)
    got = port_masks(ms)
    assert got.n_masks == ms.n_masks and got.nbytes == ms.nbytes
    assert np.array_equal(got.cells().numpy(), np.asarray(ms.cells()))
    if method == "lime":
        assert np.array_equal(got.dense().numpy(), np.asarray(ms.dense()))
    # batched: a stack of per-example sets keeps its leading axis
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    fn = getattr(jperturb, f"{method}_masks")
    stack = fn(keys, N, HW, **OPTS[method])
    assert np.array_equal(port_masks(stack).cells().numpy(),
                          np.asarray(stack.cells()))


@pytest.mark.parametrize("hw,grid", [((32, 32), 7), ((32, 32), 5),
                                     ((28, 28), 7), ((8, 8), 3),
                                     ((32, 32), 4)])
def test_rise_dense_within_bound_of_repro(hw, grid):
    ms = jperturb.rise_masks(jax.random.PRNGKey(0), 64, hw, grid=grid)
    want = np.asarray(ms.dense())
    got = port_masks(ms).dense().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("method", ["lime", "rise"])
def test_generators_draw_the_reference_distribution(method):
    """The torch draws: Bernoulli rate, shift range, determinism per
    seed, another seed other masks, one set per example."""
    n, cells, grid, p = 2048, 8, 7, 0.3
    hw = (32, 32)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        if method == "lime":
            return perturb.lime_masks(g, n, hw, cells=cells)
        return perturb.rise_masks(g, n, hw, grid=grid, p=p)

    a, b, c = draw(1), draw(1), draw(2)
    rate = 0.5 if method == "lime" else p
    bits = a.cells().float()
    sd = (rate * (1 - rate) / bits.numel()) ** 0.5
    assert abs(bits.mean().item() - rate) < 5 * sd
    assert torch.equal(a.packed, b.packed)
    assert not torch.equal(a.packed, c.packed)
    assert a.packed.dtype == torch.uint8
    assert a.packed.shape == (n, -(-a.n_cells // 8))
    if method == "rise":
        assert torch.equal(a.shifts, b.shifts)
        assert a.shifts.dtype == torch.int32 and a.shifts.shape == (n, 2)
        ch = -(-32 // grid)
        for axis in (0, 1):
            assert set(a.shifts[:, axis].tolist()) == set(range(ch))
        d = a.dense()
        assert d.min() >= 0 and d.max() <= 1
        assert ((d > 0) & (d < 1)).any()
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 1)]
    fn = getattr(perturb, f"{method}_masks")
    opts = dict(cells=cells) if method == "lime" else dict(grid=grid, p=p)
    per = fn(gens, n, hw, **opts)
    assert per.packed.shape == (3, n, a.packed.shape[-1])
    assert torch.equal(per.packed[0], a.packed)
    assert torch.equal(per.packed[1], c.packed)
    assert torch.equal(per.packed[2], a.packed)
    assert per.dense().shape == (3, n, 32, 32)


def test_keys_and_generators():
    assert perturb.key_batch_size(7) is None
    assert perturb.key_batch_size(torch.Generator()) is None
    assert perturb.key_batch_size(torch.tensor(3)) is None
    assert perturb.key_batch_size([1, 2, 3]) == 3
    assert perturb.key_batch_size(np.arange(4)) == 4
    g = perturb.generators(5, "cpu")
    assert isinstance(g, torch.Generator)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator()
                                  .manual_seed(5)))
    gs = perturb.generators([5, 6], "cpu")
    assert len(gs) == 2 and all(isinstance(x, torch.Generator) for x in gs)
    own = torch.Generator().manual_seed(9)
    assert perturb.generators(own, "cpu") is own
    # pad rows draw under the first key, and a generator is copied so the
    # first row's draws do not move
    assert perturb.pad_keys([4, 5], 4) == [4, 5, 4, 4]
    padded = perturb.pad_keys([own], 2)
    assert padded[0] is own and padded[1] is not own
    assert torch.equal(torch.rand(3, generator=padded[0]),
                       torch.rand(3, generator=padded[1]))
    from repro_torch.serve import registry
    assert registry.generators is perturb.generators


def test_n_masks_matches_the_reference():
    for method, opts in (("occlusion", dict(window=2, stride=2)),
                         ("occlusion", dict(window=4, stride=None)),
                         ("lime", dict(n_samples=N)), ("rise", {})):
        assert perturb.n_masks(method, (32, 32), **opts) == \
            jperturb.n_masks(method, (32, 32), **opts)
    assert perturb.PERTURB_DEFAULTS == jperturb.PERTURB_DEFAULTS


# -- perturb_scores -----------------------------------------------------------


def _linear(pkg_w):
    def f(v):
        return v.sum(-1).reshape(v.shape[0], -1) @ pkg_w
    return f


@pytest.mark.parametrize("select", ["logit", "prob"])
def test_perturb_scores_batched_equals_sequential_and_repro(select):
    w = np.random.RandomState(7).randn(64, 5).astype(np.float32)
    x = np.random.RandomState(8).randn(2, 8, 8, 3).astype(np.float32)
    ms = ref_masks("occlusion")
    lb, tb, sb = perturb.perturb_scores(_linear(torch.from_numpy(w)),
                                        torch.from_numpy(x), port_masks(ms),
                                        select=select, batched=True)
    ls, ts, ss = perturb.perturb_scores(_linear(torch.from_numpy(w)),
                                        torch.from_numpy(x), port_masks(ms),
                                        select=select, batched=False)
    assert sb.shape == (16, 2) and sb.dtype == torch.float32
    assert torch.equal(sb, ss) and torch.equal(lb, ls) and torch.equal(tb, ts)
    jl, jt, js = jperturb.perturb_scores(_linear(jnp.asarray(w)),
                                         jnp.asarray(x), ms, select=select)
    assert np.array_equal(tb.numpy(), np.asarray(jt))
    close(sb, js, 1e-6)
    with pytest.raises(ValueError, match="select"):
        perturb.perturb_scores(_linear(torch.from_numpy(w)),
                               torch.from_numpy(x), port_masks(ms),
                               select="nope")


def test_masked_fold_blends_the_baseline_and_rounds_integers():
    x = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    dense = torch.rand(5, 4, 4, generator=torch.Generator().manual_seed(1))
    from repro_torch.perturb.scores import _masked_fold
    from repro.perturb.scores import _masked_fold as j_masked_fold
    for baseline in (None, 0.5):
        got = _masked_fold(x, dense, baseline)
        want = j_masked_fold(jnp.asarray(x.numpy()),
                             jnp.asarray(dense.numpy()), baseline)
        assert got.shape == (5, 2, 4, 4, 3)
        assert np.array_equal(got.numpy(), np.asarray(want))
    per_example = torch.rand(2, 5, 4, 4,
                             generator=torch.Generator().manual_seed(2))
    got = _masked_fold(x, per_example, None)
    assert got.shape == (5, 2, 4, 4, 3) and got[1].is_contiguous()
    assert np.array_equal(got.numpy(), np.asarray(j_masked_fold(
        jnp.asarray(x.numpy()), jnp.asarray(per_example.numpy()), None)))
    xi = (x * 256).to(torch.int16)
    got = _masked_fold(xi, dense, None)
    want = j_masked_fold(jnp.asarray(xi.numpy()), jnp.asarray(dense.numpy()),
                         None)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["occlusion", "lime", "rise"])
def test_fxp16_scores_bitwise_on_the_same_masks(setup, method):
    jeng, teng = engines(setup, "fxp16")
    x = setup[2]
    dense = np.array(ref_masks(method).dense())
    select = "prob" if method == "rise" else "logit"
    jl, jt, js = jperturb.perturb_scores(jeng._fold_forward(), jnp.asarray(x),
                                         jnp.asarray(dense), select=select)
    tl, tt, ts = perturb.perturb_scores(teng._fold_forward(),
                                        torch.from_numpy(x),
                                        torch.from_numpy(dense),
                                        select=select)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    if select == "logit":
        assert np.array_equal(ts.numpy(), np.asarray(js))
    else:     # the int16 logits bitwise; softmax in f32 by each library
        close(ts, js, 1e-6)


# -- the three explainers against the reference -------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", ["occlusion", "lime", "rise"])
def test_explainers_match_repro(setup, precision, method):
    jeng, teng = engines(setup, precision)
    x = setup[2]
    ms = ref_masks(method)
    kw = dict(OPTS[method], masks=ms)
    tkw = dict(OPTS[method], masks=port_masks(ms))
    if method == "rise" and precision == "fxp16":
        tkw["masks"] = torch.from_numpy(np.array(ms.dense()))
    args = () if method == "occlusion" else (None,)
    jl, jh = getattr(jperturb, method)(jeng._fold_forward(), jnp.asarray(x),
                                       *args, **kw)
    tl, th = getattr(perturb, method)(teng._fold_forward(),
                                      torch.from_numpy(x), *args, **tkw)
    assert th.shape == (2, 8, 8) and th.dtype == torch.float32
    tol = TOL[precision]
    close(tl, jl, tol, "logits")
    if precision == "fxp16":
        if method == "lime":
            close(th, jh, 1e-4, "lime heat")
        else:
            assert np.array_equal(th.numpy(), np.asarray(jh)), method
    else:
        close(th, jh, 1e-4 if method == "lime" and tol < 1e-4 else tol,
              "heat")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_engine_occlusion_matches_repro_engine(setup, precision):
    jeng, teng = engines(setup, precision)
    x = setup[2]
    jl, jh = jeng.perturb(jnp.asarray(x), window=2, stride=2)
    tl, th = teng.perturb(x, window=2, stride=2)
    if precision == "fxp16":
        assert np.array_equal(th.numpy(), np.asarray(jh))
        assert np.array_equal(tl.numpy(), np.asarray(jl))
    else:
        close(tl, jl, TOL[precision])
        close(th, jh, TOL[precision])


# -- Engine.perturb -----------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", ["occlusion", "lime", "rise"])
def test_engine_batched_against_sequential(setup, precision, method):
    _, teng = engines(setup, precision)
    x = setup[2]
    key = None if method == "occlusion" else 11
    lb, hb = teng.perturb(x, key, method=method, n_samples=None
                          if method == "occlusion" else N,
                          batched=True, **OPTS[method])
    ls, hs = teng.perturb(x, key, method=method, n_samples=None
                          if method == "occlusion" else N,
                          batched=False, **OPTS[method])
    assert hb.shape == (2, 8, 8)
    if precision == "fxp16":
        assert torch.equal(hb, hs) and torch.equal(lb, ls)
    else:
        close(hb, hs, TOL[precision])
        close(lb, ls, TOL[precision])


def test_engine_fold_is_the_mask_free_forward(setup, monkeypatch):
    """The fold runs 2 forwards' worth of conv / mask-free ReLU + pool /
    FC calls per explain and nothing that stores or replays a mask."""
    _, teng = engines(setup, "f32")
    calls = []
    k = dict(cnn._KERNELS["f32"])
    for name in ("conv", "relu_pool", "fc", "pool", "conv_bwd", "fc_bwd"):
        def spy(*a, _name=name, _fn=k[name], **kw):
            calls.append((_name, kw.get("mask", a[1] if len(a) > 1
                                        and _name == "relu_pool" else None)))
            return _fn(*a, **kw)
        k[name] = spy
    monkeypatch.setitem(cnn._KERNELS, "f32", k)
    monkeypatch.setattr(cnn, "relu_fwd", lambda *a: calls.append(("b2",)))
    x = setup[2]
    teng.perturb(x, 3, method="rise", n_samples=N, grid=3)
    names = [c[0] for c in calls]
    assert names.count("conv") == 4 and names.count("fc") == 4
    assert names.count("relu_pool") == 2
    assert all(c[1] is False for c in calls if c[0] == "relu_pool")
    assert not {"pool", "conv_bwd", "fc_bwd", "b2"} & set(names)


@pytest.mark.parametrize("precision", ["f32", "fxp16"])
def test_engine_per_example_seeds(setup, precision):
    """A sequence of seeds draws one mask set per example: each row equals
    its own singleton explain; generators equal their seeds; pad rows
    draw under the first seed and change nothing."""
    jparams, params, x = setup
    _, teng = engines(setup, precision)
    _, both = teng.perturb(x, [21, 22], method="rise", n_samples=N, grid=3)
    for i, s in enumerate((21, 22)):
        _, one = teng.perturb(x[i:i + 1], s, method="rise", n_samples=N,
                              grid=3)
        if precision == "fxp16":
            assert torch.equal(both[i], one[0])
        else:
            close(both[i], one[0], TOL[precision])
    gens = [torch.Generator().manual_seed(s) for s in (21, 22)]
    _, via_gens = teng.perturb(x, gens, method="rise", n_samples=N, grid=3)
    assert torch.equal(via_gens, both)
    padded = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                              method="rise", precision=precision, batch=4,
                              n_samples=N))
    logits, heat = padded.perturb(x, [21, 22], grid=3)
    assert heat.shape == (2, 8, 8) and logits.shape == (2, 10)
    if precision == "fxp16":
        assert torch.equal(heat, both)
    else:
        close(heat, both, TOL[precision])
    _, shared = teng.perturb(x, 21, method="rise", n_samples=N, grid=3)
    assert not torch.equal(shared[1], both[1])


def test_engine_refuses_what_it_cannot_run(setup):
    _, teng = engines(setup, "f32")
    x = setup[2]
    with pytest.raises(ValueError, match="stochastic"):
        teng.perturb(x, method="rise", n_samples=N)
    with pytest.raises(ValueError, match="not in"):
        teng.perturb(x, method="saliency")
    for op in ("explain", "predict_then_explain", "input_x_gradient"):
        with pytest.raises(ValueError, match="forward-only"):
            getattr(teng, op)(x)
    with pytest.raises(ValueError, match="forward-only"):
        teng.ig(x, steps=2)
    with pytest.raises(ValueError, match="forward-only"):
        teng.smoothgrad(x, torch.Generator(), n=2)
    assert teng.predict(x).shape == (2, 10)


def test_engine_fnmodel_falls_back_to_its_forward(setup):
    _, params, x = setup

    def make_f(method):
        return lambda v: cnn.apply(params, v, CFG, method=method)

    fn = build(EngineSpec(FnModel(make_f, device="cpu"), method="occlusion"))
    _, hb = fn.perturb(x, window=2, stride=2, batched=True)
    _, hs = fn.perturb(x, window=2, stride=2, batched=False)
    close(hb, hs, 1e-6)
    _, t = engines(setup, "f32")
    close(hb, t.perturb(x, window=2, stride=2)[1], 1e-5)


@pytest.mark.parametrize("method", ["occlusion", "lime", "rise"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_perturbation_specs_build(setup, method, precision):
    _, params, _ = setup
    n = None if method == "occlusion" else 16
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                           method=method, precision=precision, n_samples=n))
    assert eng.spec.fwd_rules() == "saliency"
    assert eng.spec.resolve_backward() == "seed_batched"


def test_spec_validation_is_the_reference_s(setup):
    _, params, _ = setup
    model = CNNModel(params, CFG, device="cpu")
    for kw, match in ((dict(method="occlusion", n_samples=16), "n_samples"),
                      (dict(method="rise", targets=3), "one target"),
                      (dict(method="lime", n_samples=0), "n_samples"),
                      (dict(method="saliency", n_samples=4), "n_samples")):
        for pkg, m in ((tengine, model),
                       (jengine, jengine.FnModel(lambda m: m))):
            pkw = dict(kw)
            if "targets" in pkw:
                pkw["targets"] = pkg.TopK(pkw["targets"])
            with pytest.raises(ValueError, match=match):
                pkg.EngineSpec(model=m, **pkw)


# -- serving ------------------------------------------------------------------

SERVE_OPTS = {"occlusion": {"window": 2, "stride": 2},
              "lime": {"n_samples": N, "cells": 4},
              "rise": {"n_samples": N, "grid": 3}}


def make_server(pkg, adapter, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.0)
    kw.setdefault("method_opts", SERVE_OPTS)
    return pkg.ExplanationServer(adapter, **kw)


def port_adapter(setup, precision="f32"):
    _, params, _ = setup
    return tserve.CNNAdapter.from_engine(build(EngineSpec(
        CNNModel(params, CFG, device="cpu"), precision=precision)))


@pytest.mark.parametrize("method", ["occlusion", "rise"])
def test_serve_never_consults_the_residual_cache(setup, method):
    x = setup[2]
    srv = make_server(tserve, port_adapter(setup))
    srv.submit(tserve.Request(uid="u0", kind="predict", x=x[0]))
    srv.drain()
    assert srv.cache.peek("u0") is not None
    srv.submit(tserve.Request(uid="u0", kind="explain", x=x[0],
                              method=method, key=1))
    (resp,) = srv.drain()
    assert resp.ok and resp.method == method and resp.cache_hit is False
    assert resp.relevance.shape == (8, 8)
    assert srv.cache.stats.hits == 0 and srv.cache.stats.misses == 0
    srv.submit(tserve.Request(uid="u0", kind="explain", x=x[0],
                              method="saliency"))
    (resp2,) = srv.drain()
    assert resp2.ok and resp2.cache_hit is True


def test_serve_occlusion_matches_the_reference_server(setup):
    jparams, _, x = setup
    reqs = [dict(uid=f"q{i}", kind="explain", x=x[i % 2],
                 method="occlusion") for i in range(3)]
    jsrv = make_server(jserve, jserve.CNNAdapter(jparams, JCFG))
    tsrv = make_server(tserve, port_adapter(setup))
    for r in reqs:
        jsrv.submit(jserve.Request(**r))
        tsrv.submit(tserve.Request(**r))
    want, got = jsrv.drain(), tsrv.drain()
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert (b.uid, b.ok, b.targets, b.cache_hit, b.batch_size) == (
            a.uid, a.ok, a.targets, a.cache_hit, a.batch_size)
        close(b.relevance, a.relevance, 1e-5)


@pytest.mark.parametrize("precision", ["f32", "fxp16"])
@pytest.mark.parametrize("method", ["lime", "rise"])
def test_serve_cobatched_requests_keep_their_own_seeds(setup, precision,
                                                       method):
    x = setup[2]
    solo = {}
    for i in range(3):
        srv = make_server(tserve, port_adapter(setup, precision), max_batch=1)
        srv.submit(tserve.Request(uid=f"s{i}", kind="explain", x=x[i % 2],
                                  method=method, key=20 + i))
        (resp,) = srv.drain()
        solo[resp.uid] = resp.relevance
    srv = make_server(tserve, port_adapter(setup, precision))
    for i in range(3):
        srv.submit(tserve.Request(uid=f"s{i}", kind="explain", x=x[i % 2],
                                  method=method, key=20 + i))
    out = {r.uid: r for r in srv.drain()}
    assert len(out) == 3 and max(r.batch_size for r in out.values()) > 1
    for uid, resp in out.items():
        if precision == "fxp16":
            assert torch.equal(resp.relevance, solo[uid]), uid
        else:
            close(resp.relevance, solo[uid], TOL[precision], uid)


def test_serve_fxp16_rise_end_to_end(setup):
    x = setup[2]
    srv = make_server(tserve, port_adapter(setup, "fxp16"))
    srv.submit(tserve.Request(uid="q0", kind="explain", x=x[0],
                              method="rise", key=30))
    (resp,) = srv.drain()
    assert resp.ok and resp.relevance.shape == (8, 8)
    assert torch.isfinite(resp.relevance).all()
    eng = build(EngineSpec(CNNModel(setup[1], CFG, device="cpu"),
                           precision="fxp16"))
    _, heat = eng.perturb(x[:1], [30], method="rise", **SERVE_OPTS["rise"])
    assert torch.equal(resp.relevance, heat[0])


def test_serve_raw_callable_explainers(setup):
    """Raw-callable explainers run the free functions on ``f``."""
    _, params, x = setup
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu")))
    for name in ("occlusion", "lime", "rise"):
        ex = tserve.make(name, eng.model_fn, device="cpu",
                         **SERVE_OPTS[name])
        key = None if name == "occlusion" else 4
        logits, heat = ex.attribute(x, key=key)
        assert heat.shape == (2, 8, 8) and torch.isfinite(heat).all()
        if name != "occlusion":
            with pytest.raises(ValueError, match="stochastic"):
                ex.attribute(x)
            _, again = eng.perturb(x, 4, method=name, **SERVE_OPTS[name])
            close(heat, again, 1e-5)
    assert methods.METHODS == ("saliency", "deconvnet", "guided")


def test_driver_serves_rise_with_perturb_samples():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "cnn", "--method", "rise", "--perturb-samples", "64",
         "--torch-device", "cpu", "--requests", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "8 responses" in r.stdout and "0 errors" in r.stdout
    assert "cache hits 0/4" in r.stdout
