"""repro_torch.serve against repro.serve on the CPU: the registry, the
micro-batcher's arithmetic, the residual cache's accounting, the server end
to end, request handling, the LM adapter and the driver.

Both servers run on the same parameters (``repro``'s ``cnn.init``, copied by
``params_from_jax``) and the same NumPy inputs, at the tiny config of
``tests/test_torch_engine.py``; ``repro``'s Pallas path runs in interpret
mode, as its own tests run it.  Tolerances (relative to the reference's
max |value|): f32 logits 1e-5 and relevance 1e-4 (the same f32 arithmetic
summed in another order); fxp16 bitwise (integer arithmetic); bf16 2^-6
(``tests/test_torch_cnn_bf16.py``'s bound).  Targets, cache hits and batch
sizes are equal.  In the port alone: a cache hit is bitwise the cold
explain of the same request, the cache owns exactly ``bits_stored / 8``
bytes, and co-batched smoothgrad rows equal singleton requests.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.serve as jserve
from repro import lm as jlm
from repro.models import cnn as jcnn
from repro.models import transformer as jtf
from repro.serve import batcher as jbatcher
from repro.serve import registry as jregistry
from repro.serve import residual_cache as jcache
import repro_torch.serve as tserve
from repro_torch import configs, lm
from repro_torch import engine as tengine
from repro_torch.core import residuals as tresiduals
from repro_torch.engine import CNNModel, EngineSpec, LMModel, build, methods
from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.serve import adapters as tadapters
from repro_torch.serve import batcher as tbatcher
from repro_torch.serve import registry as tregistry
from repro_torch.serve import residual_cache as tcache

ROOT = Path(__file__).resolve().parents[1]
KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)
TOL = {"f32": (1e-5, 1e-4), "bf16": (2.0 ** -6, 2.0 ** -6),
       "fxp16": (0.0, 0.0)}
N_X = 8


@pytest.fixture(scope="module")
def setup():
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(1).randn(N_X, 8, 8, 3).astype(np.float32)
    tengine.clear_cache()
    yield jparams, params, x
    tengine.clear_cache()


def adapters(setup, precision="f32", store_rules="saliency"):
    jparams, params, _ = setup
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                           method=store_rules, precision=precision))
    return (jserve.CNNAdapter(jparams, JCFG, precision=precision,
                              store_rules=store_rules),
            tserve.CNNAdapter.from_engine(eng))


def server(pkg, adapter, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_s", 0.0)
    return pkg.ExplanationServer(adapter, **kw)


def stream(srv, reqs):
    """Submit each request, poll after each, drain: every response, in
    order (``serve`` would fold a uid's predict and explain into one)."""
    out = []
    for r in reqs:
        srv.submit(r)
        out += srv.poll()
    return out + srv.drain()


def burst(srv, reqs):
    """Submit every request, then drain: one padded batch per bucket."""
    for r in reqs:
        srv.submit(r)
    return srv.drain()


def host(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def close(got, want, tol, what):
    got, want = host(got), host(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def assert_parity(want, got, precision):
    """Responses of the reference and the port server, in order."""
    assert len(got) == len(want)
    ltol, rtol = TOL[precision]
    for a, b in zip(want, got):
        what = (a.uid, a.kind, a.method)
        assert (b.uid, b.kind, b.method, b.ok, b.error_type) == (
            a.uid, a.kind, a.method, a.ok, a.error_type), what
        assert (b.targets, b.cache_hit, b.batch_size) == (
            a.targets, a.cache_hit, a.batch_size), what
        assert b.meta == a.meta, what
        close(b.logits, a.logits, ltol, what)
        if a.relevance is not None:
            close(b.relevance, a.relevance, rtol, what)


def mixed_requests(pkg, x):
    """Predict -> hit (argmax, top-3 panel, explicit target, every BP
    method), cold BP explains warming the cache and their follow-up hits,
    and the IG / input x gradient composites."""
    R = pkg.Request
    reqs = [R(uid=f"p{i}", kind="predict", x=x[i]) for i in range(4)]
    reqs += [R(uid="p0", kind="explain", x=x[0], method="saliency"),
             R(uid="p1", kind="explain", x=x[1], method="guided", topk=3),
             R(uid="p2", kind="explain", x=x[2], method="deconvnet"),
             R(uid="p3", kind="explain", x=x[3], method="saliency",
               target=7)]
    reqs += [R(uid=f"c{i}", kind="explain", x=x[4 + i], method="guided")
             for i in range(3)]
    reqs += [R(uid="c0", kind="explain", x=x[4], method="deconvnet"),
             R(uid="c1", kind="explain", x=x[5], method="saliency", topk=2),
             R(uid="ig", kind="explain", x=x[7],
               method="integrated_gradients"),
             R(uid="ixg", kind="explain", x=x[6], method="input_x_gradient"),
             R(uid="ixg2", kind="explain", x=x[2], method="input_x_gradient",
               target=3)]
    return reqs


# -- registry -----------------------------------------------------------------

FLAGS = ("rules", "mask_reuse", "token_capable", "needs_key", "fold_keys")


def test_registry_names_and_flags_equal_reference():
    assert tregistry.names() == jregistry.names()
    assert tregistry.mask_reuse_methods() == jregistry.mask_reuse_methods()
    assert tregistry.token_methods() == jregistry.token_methods()
    for name in jregistry.names():
        for flag in FLAGS:
            assert (getattr(tregistry.get(name), flag)
                    == getattr(jregistry.get(name), flag)), (name, flag)
        assert tregistry.get(name).name == name
    with pytest.raises(KeyError):
        tregistry.get("no_such_method")
    with pytest.raises(ValueError):
        @tregistry.register("saliency")
        class Dup(tregistry.Explainer):
            pass


def test_registry_explainers_are_the_direct_calls(setup):
    _, params, x = setup
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu")))
    xb = torch.from_numpy(x[:3])
    for name, direct in (
            ("saliency", lambda: methods.attribute(eng.model_fn, xb)),
            ("input_x_gradient",
             lambda: methods.input_x_gradient(eng.model_fn, xb)),
            ("integrated_gradients", lambda: methods.integrated_gradients(
                eng.model_fn, xb, steps=4))):
        ex = tregistry.get(name).from_engine(eng, steps=4)
        assert torch.equal(ex.attribute(x[:3])[1], direct()[1]), name
    sg = tregistry.get("smoothgrad").from_engine(eng, n=3)
    _, rel = sg.attribute(x[:3], key=5)
    _, want = methods.smoothgrad(eng.model_fn, xb,
                                 torch.Generator().manual_seed(5), n=3)
    assert torch.equal(rel, want)
    with pytest.raises(ValueError, match="seed"):
        sg.attribute(x[:3])


# -- batching -----------------------------------------------------------------


def request_battery(pkg):
    R, z = pkg.Request, np.zeros((8, 8, 3), np.float32)
    return [R(uid="a", kind="predict", x=z),
            R(uid="b", kind="predict", x=np.zeros((4, 4, 3), np.float32)),
            R(uid="c", kind="predict", x=np.zeros((8, 8, 3), np.float64)),
            R(uid="d", kind="explain", x=z),
            R(uid="e", kind="explain", x=z, method="guided"),
            R(uid="f", kind="explain", x=z, topk=3),
            R(uid="g", kind="explain", x=z, target=1),
            R(uid="h", kind="explain", x=z, method="smoothgrad"),
            R(uid="i", kind="explain", x=z, method="lime"),
            R(uid="j", kind="explain", x=np.zeros((16,), np.int32),
              method="token_ixg")]


def test_bucket_keys_equal_reference():
    want = [jbatcher.bucket_key(r) for r in request_battery(jserve)]
    got = [tbatcher.bucket_key(r) for r in request_battery(tserve)]
    assert got == want
    deg = request_battery(tserve)[3]
    deg.degraded = True
    assert tbatcher.bucket_key(deg) not in got
    t = tserve.Request(uid="t", kind="predict",
                       x=torch.zeros((8, 8, 3)))
    assert tbatcher.bucket_key(t) == got[0]


@pytest.mark.parametrize("n,max_batch", [(1, 1), (1, 8), (3, 8), (5, 8),
                                         (8, 8), (9, 8), (33, 32), (7, 4),
                                         (100, 64), (2, 3)])
def test_pad_size_equals_reference(n, max_batch):
    assert tbatcher.pad_size(n, max_batch) == jbatcher.pad_size(n, max_batch)


@pytest.mark.parametrize("deadline,now,est", [(1.0, 0.5, 0.5),
                                              (1.0, 0.6, 0.5),
                                              (0.01, 0.0, 0.002),
                                              (float("inf"), 3.0, 1.0)])
def test_slack_equals_reference(deadline, now, est):
    assert (tbatcher.slack_s(deadline, now, est)
            == jbatcher.slack_s(deadline, now, est))


def test_stack_padded_is_one_host_batch(setup):
    _, _, x = setup
    got = tbatcher.stack_padded([x[0], torch.from_numpy(x[1]), x[2]], 4)
    want = jbatcher.stack_padded([x[0], x[1], x[2]], 4)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the residual cache -------------------------------------------------------


def cache_program(pkg_cache, make):
    c = pkg_cache.ResidualCache(capacity=3)
    out = []
    for uid, nbytes in (("a", 3), ("b", 5), ("a", 7), ("c", 2), ("d", 4),
                        ("e", 1)):
        c.put(uid, pkg_cache.CacheEntry(logits=None, residuals=make(nbytes),
                                        rules="saliency"))
        out.append(c.stats.snapshot())
    for uid in ("a", "b", "c", "zz", "e"):
        e = c.get(uid)
        out.append((uid, None if e is None else e.bits, c.stats.snapshot()))
    c.count_miss()
    out.append((len(c), "d" in c, c.peek("e") is not None,
                c.stats.snapshot()))
    return out


def test_cache_lru_accounting_equals_reference():
    want = cache_program(jcache, lambda n: {
        "m": np.zeros((1, n), np.uint8), "i": [np.zeros((1, 2), np.int32)],
        "s": (3, 4)})
    got = cache_program(tcache, lambda n: {
        "m": torch.zeros((1, n), dtype=torch.uint8),
        "i": [torch.zeros((1, 2), dtype=torch.int32)], "s": (3, 4)})
    assert got == want
    with pytest.raises(ValueError):
        tcache.ResidualCache(0)


@pytest.mark.parametrize("precision", ["f32", "bf16", "fxp16"])
@pytest.mark.parametrize("method", ["saliency", "deconvnet", "guided"])
def test_residual_bits_equal_core_and_reference(setup, precision, method):
    jparams, params, x = setup
    jad, tad = adapters(setup, precision=precision, store_rules=method)
    _, jres = jad.predict(jnp.asarray(x[:3]))
    _, tres = tad.predict(x[:3])
    bits = tcache.residual_bits(tres)
    assert bits == tresiduals.residual_bits(tres)
    assert bits == jcache.residual_bits(jres)
    one = tadapters.slice_example(tres, 1)
    assert tcache.residual_bits(one) * 3 == bits
    assert one["feat_shape"] == tres["feat_shape"]
    assert [m is None for m, _ in one["conv"]] == [
        m is None for m, _ in tres["conv"]]
    assert tcache.residual_bits(None) == 0


def test_slice_example_owns_its_bytes_and_concat_inverts_it(setup):
    _, params, x = setup
    _, tad = adapters(setup)
    _, res = tad.predict(x[:4])
    parts = [tadapters.slice_example(res, i) for i in range(4)]
    for part in parts:
        for t in tcache.leaves(part):
            if isinstance(t, torch.Tensor):
                assert t.untyped_storage().nbytes() == (
                    t.numel() * t.element_size())
    back = tadapters.concat_examples(parts)
    assert back["feat_shape"] == res["feat_shape"]
    for a, b in zip(tcache.leaves(back), tcache.leaves(res)):
        assert (a is None and b is None) or (
            not isinstance(a, torch.Tensor) and a == b) or torch.equal(a, b)


# -- the server against repro's -----------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "fxp16", "bf16"])
def test_server_matches_reference(setup, precision):
    _, _, x = setup
    jad, tad = adapters(setup, precision=precision)
    want = stream(server(jserve, jad), mixed_requests(jserve, x))
    srv = server(tserve, tad)
    got = stream(srv, mixed_requests(tserve, x))
    assert_parity(want, got, precision)
    hits = [r.uid for r in got if r.cache_hit]
    assert hits == ["p0", "p1", "p2", "p3", "c0", "c1"]
    assert got[5].relevance.shape == (3, 8, 8, 3)           # top-3 panel
    assert srv.cache.stats.hits == 6


def test_deconvnet_stored_masks_replay_only_deconvnet(setup):
    _, _, x = setup
    jad, tad = adapters(setup, store_rules="deconvnet")

    def reqs(pkg):
        R = pkg.Request
        return [R(uid="a", kind="predict", x=x[0]),
                R(uid="a", kind="explain", x=x[0], method="deconvnet"),
                R(uid="a", kind="explain", x=x[0], method="guided"),
                R(uid="a", kind="explain", x=x[0], method="saliency",
                  topk=2)]

    jsrv, tsrv = server(jserve, jad), server(tserve, tad)
    got = stream(tsrv, reqs(tserve)[:3])
    assert_parity(stream(jsrv, reqs(jserve)[:3]), got, "f32")
    assert [r.cache_hit for r in got] == [False, True, False]
    for srv, pkg in ((jsrv, jserve), (tsrv, tserve)):
        with pytest.raises(ValueError, match="topk"):
            srv.submit(reqs(pkg)[3])
    assert tsrv.cache.stats.snapshot() == jsrv.cache.stats.snapshot()


def test_lru_eviction_forces_the_cold_path(setup):
    _, _, x = setup
    jad, tad = adapters(setup)

    def reqs(pkg):
        R = pkg.Request
        return [R(uid="a", kind="predict", x=x[0]),
                R(uid="b", kind="predict", x=x[1]),
                R(uid="a", kind="explain", x=x[0], method="saliency"),
                R(uid="b", kind="explain", x=x[1], method="guided")]

    jsrv = server(jserve, jad, cache_capacity=1, max_batch=1)
    tsrv = server(tserve, tad, cache_capacity=1, max_batch=1)
    got = stream(tsrv, reqs(tserve))
    assert_parity(stream(jsrv, reqs(jserve)), got, "f32")
    assert not got[2].cache_hit and not got[3].cache_hit
    assert tsrv.cache.stats.snapshot() == jsrv.cache.stats.snapshot()
    assert tsrv.cache.stats.evictions == 3


# -- the port alone: hit == cold, owned bytes ---------------------------------


@pytest.mark.parametrize("precision", ["f32", "bf16", "fxp16"])
@pytest.mark.parametrize("method,topk", [("saliency", None),
                                         ("guided", 3), ("deconvnet", None)])
def test_hit_is_bitwise_the_cold_explain(setup, precision, method, topk):
    _, _, x = setup
    _, tad = adapters(setup, precision=precision)
    R = tserve.Request
    warm = server(tserve, tad)
    burst(warm, [R(uid=f"u{i}", kind="predict", x=x[i]) for i in range(3)])
    hot = burst(warm, [R(uid=f"u{i}", kind="explain", x=x[i],
                         method=method, topk=topk) for i in range(3)])
    cold = burst(server(tserve, tad),
                 [R(uid=f"u{i}", kind="explain", x=x[i], method=method,
                    topk=topk) for i in range(3)])
    assert all(r.cache_hit for r in hot) and not any(
        r.cache_hit for r in cold)
    assert {r.batch_size for r in hot + cold} == {4}
    for h, c in zip(hot, cold):
        assert torch.equal(h.relevance, c.relevance)
        assert torch.equal(h.logits, c.logits)
        assert h.targets == c.targets
    # and the engine's own explain of the same padded batch
    eng = tad.engine_for(method)
    xb = tbatcher.stack_padded([x[0], x[1], x[2]], 4)
    _, rel = eng.explain(xb, topk=topk)
    for i, h in enumerate(hot):
        assert torch.equal(h.relevance, rel[:, i] if topk else rel[i])


def test_cache_owns_exactly_bits_stored(setup):
    _, _, x = setup
    _, tad = adapters(setup)
    R = tserve.Request
    srv = server(tserve, tad, cache_capacity=5)
    stream(srv, [R(uid=f"u{i}", kind="predict", x=x[i]) for i in range(8)]
           + [R(uid="c", kind="explain", x=x[0], method="guided")])
    assert len(srv.cache) == 5 and srv.cache.stats.evictions == 4
    assert (tcache.owned_bytes(srv.cache) * 8
            == srv.cache.stats.bits_stored == 5 * tcache.residual_bits(
                tadapters.slice_example(tad.predict(x[:1])[1], 0)))


# -- request handling ---------------------------------------------------------


def outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__


def malformed(pkg, x):
    R = pkg.Request
    nan, inf = x[0].copy(), x[0].copy()
    nan[0, 0, 0], inf[-1, -1, -1] = np.nan, np.inf
    return [lambda: R(uid="k", kind="fetch", x=x[0]),
            lambda: R(uid="k", kind="predict", x=x[0], topk=2),
            lambda: R(uid="k", kind="explain", x=x[0], deadline_s=0.0),
            R(uid="nan", kind="predict", x=nan),
            R(uid="inf", kind="explain", x=inf),
            R(uid="shape", kind="predict", x=np.zeros((4, 4, 3),
                                                      np.float32)),
            R(uid="rank", kind="explain", x=np.zeros((8, 8), np.float32)),
            R(uid="m", kind="explain", x=x[0], method="no_such_method"),
            R(uid="sg", kind="explain", x=x[0], method="smoothgrad"),
            R(uid="tk", kind="explain", x=x[0], method="input_x_gradient",
              topk=2),
            R(uid="ok", kind="predict", x=x[0])]


def test_malformed_requests_raise_the_reference_types(setup):
    _, _, x = setup
    res = {}
    for name, pkg, ad in zip(("ref", "port"), (jserve, tserve),
                             adapters(setup)):
        srv = server(pkg, ad, max_delay_s=60.0,
                     admission=pkg.AdmissionConfig(capacity=8))
        res[name] = [outcome(r if callable(r) else
                             (lambda r=r: srv.submit(r)))
                     for r in malformed(pkg, x)]
        res[name].append(srv.batcher.pending())
    assert res["port"] == res["ref"]
    assert res["port"][3:5] == ["InvalidRequestError"] * 2
    assert res["port"][-1] == 1


def test_poisoned_batch_is_fault_isolated(setup):
    _, _, x = setup
    out = {}
    for name, pkg, ad in zip(("ref", "port"), (jserve, tserve),
                             adapters(setup)):
        def boom(xb):
            raise RuntimeError("device program crashed")
        ad.predict = boom
        srv = server(pkg, ad)
        resp = stream(srv, [pkg.Request(uid=u, kind="predict", x=x[i])
                            for i, u in enumerate("ab")])
        del ad.predict
        resp += stream(srv, [pkg.Request(uid="c", kind="predict", x=x[2])])
        out[name] = ([(r.uid, r.ok, r.error_type, r.error) for r in resp],
                     srv.stats.errors, srv.cache.peek("c") is not None)
    assert out["port"] == out["ref"]
    assert out["port"][1] == 2 and out["port"][2]


def test_capacity_shed_is_typed(setup):
    _, _, x = setup
    out = {}
    for name, pkg, ad in zip(("ref", "port"), (jserve, tserve),
                             adapters(setup)):
        srv = server(pkg, ad, max_delay_s=60.0,
                     admission=pkg.AdmissionConfig(capacity=1))
        srv.submit(pkg.Request(uid="a", kind="predict", x=x[0]))
        with pytest.raises(pkg.ShedError) as ei:
            srv.submit(pkg.Request(uid="b", kind="predict", x=x[1]))
        folded = srv.serve([pkg.Request(uid="c", kind="predict", x=x[2])])
        out[name] = (ei.value.uid, ei.value.reason, ei.value.detail,
                     dict(srv.stats.sheds), folded["c"].error_type,
                     folded["c"].meta, folded["a"].ok)
    assert out["port"] == out["ref"]


def test_fxp16_reroute_equals_the_fxp16_engine_bitwise(setup):
    _, params, x = setup
    res = {}
    for name, pkg, ad in zip(("ref", "port"), (jserve, tserve),
                             adapters(setup)):
        srv = server(pkg, ad, max_delay_s=60.0, admission=pkg.AdmissionConfig(
            capacity=2, degrade=pkg.DegradePolicy(
                pressure_threshold=0.5, reroute_precision="fxp16")))
        srv.submit(pkg.Request(uid="f", kind="explain", x=x[0],
                               method="saliency"))
        srv.submit(pkg.Request(uid="q", kind="explain", x=x[1],
                               method="guided"))
        res[name] = ({r.uid: r for r in srv.drain()}, srv)
    (want, _), (got, tsrv) = res["ref"], res["port"]
    assert got["q"].meta == want["q"].meta == {"degraded":
                                               "reroute_precision"}
    assert tsrv._degraded_adapter.precision == "fxp16"
    assert tsrv.cache.peek("q") is None and tsrv.cache.peek("f") is not None
    fxp = build(EngineSpec(CNNModel(params, CFG, device="cpu"),
                           method="guided", precision="fxp16"))
    logits, rel = fxp.explain(x[1:2])
    assert torch.equal(got["q"].relevance, rel[0])
    assert torch.equal(got["q"].logits, logits[0])
    assert np.array_equal(host(got["q"].relevance), host(want["q"].relevance))
    close(got["f"].relevance, want["f"].relevance, 1e-4, "f32 primary")


# -- top-K ties ---------------------------------------------------------------


TIED = [np.asarray([1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 2.0, -1.0, 3.0, 0.0]),
        np.asarray([0.5] * 10),
        np.asarray([2.0, 2.0, 1.0, 2.0, 1.0, 1.0, 2.0, 0.0, 0.0, 2.0])]


@pytest.mark.parametrize("lg", TIED)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_ties_resolve_as_the_reference_f32(lg, k):
    lg = lg.astype(np.float32)
    jr = jserve.Request(uid="a", kind="explain", x=None, topk=k)
    tr = tserve.Request(uid="a", kind="explain", x=None, topk=k)
    want = jserve.ExplanationServer._targets_for(None, jr, lg)
    got = tserve.ExplanationServer._targets_for(None, tr, lg)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("lg", TIED)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_ties_bf16_logits(lg, k):
    """bf16 logits: the port sorts their exact f32 widening (NumPy has no
    bf16), so its panel is the reference's panel of the same values in f32.
    The reference sorts the bf16 array itself, and NumPy's sort for that
    dtype may order equal values otherwise (ROADMAP C): the two panels then
    differ only among tied logits, position by position."""
    tr = tserve.Request(uid="a", kind="explain", x=None, topk=k)
    jr = jserve.Request(uid="a", kind="explain", x=None, topk=k)
    wide = torch.tensor(lg, dtype=torch.bfloat16).float().numpy()
    got = tserve.ExplanationServer._targets_for(None, tr, wide)
    want_f32 = jserve.ExplanationServer._targets_for(None, jr, wide)
    want_bf16 = jserve.ExplanationServer._targets_for(
        None, jr, jnp.asarray(lg, jnp.bfloat16))
    assert got.tolist() == want_f32.tolist()
    assert wide[got].tolist() == wide[np.asarray(want_bf16)].tolist()


# -- smoothgrad: per-request seeds --------------------------------------------


def test_engine_smoothgrad_per_example_generators_equal_singletons(setup):
    _, params, x = setup
    eng = build(EngineSpec(CNNModel(params, CFG, device="cpu")))
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    logits, rel = eng.smoothgrad(x[:3], gens, n=4)
    for i, s in enumerate((3, 4, 5)):
        li, ri = eng.smoothgrad(x[i:i + 1], torch.Generator().manual_seed(s),
                                n=4)
        close(logits[i:i + 1], li, 1e-6, "logits")
        close(rel[i:i + 1], ri, 1e-6, "relevance")
    with pytest.raises(ValueError, match="generators"):
        eng.smoothgrad(x[:3], gens[:2], n=4)


def test_smoothgrad_cobatched_requests_equal_singletons(setup):
    _, _, x = setup
    _, tad = adapters(setup)
    R = tserve.Request
    reqs = lambda: [R(uid=f"s{i}", kind="explain", x=x[i],
                      method="smoothgrad", key=10 + i) for i in range(3)]
    srv = server(tserve, tad, method_opts={"smoothgrad": {"n": 4}})
    for r in reqs():
        srv.submit(r)
    batched = srv.drain()
    assert [r.batch_size for r in batched] == [4] * 3
    for b, r in zip(batched, reqs()):
        (single,) = stream(server(tserve, tad,
                                  method_opts={"smoothgrad": {"n": 4}}),
                           [r])
        assert single.batch_size == 1 and single.targets == b.targets
        close(b.relevance, single.relevance, 1e-6, b.uid)
    assert not torch.equal(batched[0].relevance, batched[1].relevance)


# -- LM -----------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 5, 8, 9, 16, 17, 33])
def test_bucket_len_and_pad_tokens_equal_reference(s):
    assert lm.bucket_len(s) == jlm.bucket_len(s)
    assert lm.bucket_len(s, 4) == jlm.bucket_len(s, 4)
    toks = np.arange(1, 2 * s + 1, dtype=np.int32).reshape(2, s)
    for length in (None, lm.bucket_len(s) * 2):
        got = lm.pad_tokens(toks, length)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jlm.pad_tokens(toks, length)))
        np.testing.assert_array_equal(
            lm.pad_tokens(toks[0], length).numpy(),
            np.asarray(jlm.pad_tokens(toks[0], length)))
    with pytest.raises(ValueError):
        lm.pad_tokens(toks, s - 1 if s > 1 else 0)


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jconfigs.get_smoke("falcon-mamba-7b")
    cfg = configs.get_smoke("falcon-mamba-7b")
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    p = tf.params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, cfg.vocab, size=(s,)).astype(np.int32)
            for s in (8, 8, 8, 16)]
    return jcfg, cfg, jp, p, toks


def lm_adapter(p, cfg):
    return lm.LMAdapter.from_engine(build(EngineSpec(LMModel(p, cfg,
                                                             device="cpu"))))


def test_lm_server_matches_reference(lm_setup):
    jcfg, cfg, jp, p, toks = lm_setup
    out = {}
    for name, pkg, ad in (
            ("ref", jserve, jlm.LMAdapter(jp, jcfg)),
            ("port", tserve, lm_adapter(p, cfg))):
        reqs = []
        for i, t in enumerate(toks):
            reqs.append(pkg.Request(uid=f"q{i}", kind="predict", x=t))
            reqs.append(pkg.Request(uid=f"q{i}", kind="explain", x=t,
                                    method=("token_ixg", "token_contrastive")
                                    [i % 2]))
        out[name] = stream(server(pkg, ad), reqs)
    want, got = out["ref"], out["port"]
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert (b.uid, b.kind, b.method, b.ok, b.targets, b.batch_size) == (
            a.uid, a.kind, a.method, a.ok, a.targets, a.batch_size)
        close(b.logits, a.logits, 1e-5, (a.uid, a.kind))
        if a.kind == "explain":
            close(b.relevance, a.relevance, 1e-4, (a.uid, a.method))


def test_lm_predict_is_forward_and_explain_cached_refuses(lm_setup,
                                                          monkeypatch):
    _, cfg, _, p, toks = lm_setup
    ad = lm_adapter(p, cfg)
    xb = torch.from_numpy(np.stack(toks[:3]))
    logits, res = ad.predict(xb)
    with torch.no_grad():
        want = tf.forward(p, cfg, {"tokens": xb.long()})[0][:, -1]
    assert res is None and torch.equal(logits, want)
    with pytest.raises(ValueError, match="no residual replay"):
        ad.explain_cached("token_ixg", None, None)
    assert ad.example_shape is None and ad.n_shards == 1
    from repro_torch.engine import spec as spec_mod
    real = spec_mod.resolve_device
    monkeypatch.setattr(spec_mod, "resolve_device",
                        lambda d: real("cpu" if d is None else d))
    # an LM engine on a mesh device builds unsharded, as repro's
    assert lm.LMAdapter(p, cfg, device="mesh:edge-small:2").n_shards == 1


def test_planner_and_mesh_knobs_raise(setup, monkeypatch):
    jparams, params, _ = setup
    with pytest.raises(ValueError):
        tserve.CNNAdapter(params, CFG, precision="int4")
    if not torch.cuda.is_available():       # the card or an error, no CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.CNNAdapter(params, CFG)
    # the planner's knobs reach the engine (tests/test_torch_plan_engine.py);
    # a mesh of several shards builds a data-parallel engine whose extent
    # the adapter, its siblings and from_engine report (twin of
    # tests/test_engine.py::test_adapter_reports_mesh_extent)
    from repro_torch.engine import spec as spec_mod
    real = spec_mod.resolve_device
    monkeypatch.setattr(spec_mod, "resolve_device",
                        lambda d: real("cpu" if d is None else d))
    adp = tserve.CNNAdapter(params, CFG, device="mesh:edge-small:2")
    assert adp.n_shards == 2 and adp.engine_for("guided").n_shards == 2
    assert tserve.CNNAdapter.from_engine(adp.engine).n_shards == 2
    assert adp.with_precision("fxp16").n_shards == 2
    assert tserve.CNNAdapter(params, CFG,
                             device="mesh:edge-small:4").n_shards == 4
    single = tserve.CNNAdapter(params, CFG, device="edge-small")
    assert single.engine.plan is not None and single.n_shards == 1

    # a server on one rank fills toward max_batch * n_shards seats (twin
    # of tests/test_admission.py::test_fill_target_scales_batches_to_the_mesh)
    class Sharded:
        store_rules, n_shards = "saliency", 4
    srv = tserve.ExplanationServer(Sharded(), max_batch=3)
    assert srv.batcher.fill_target == 12 and srv.batcher.n_shards == 4


@pytest.mark.parametrize("n_shards", [1, 4])
def test_mesh_server_heatmaps_bitwise_with_single_device(setup, n_shards):
    """Twin of ``tests/test_serve.py::
    test_mesh_server_heatmaps_bitwise_with_single_device``: serving through
    a ``mesh:edge-small:<n>`` adapter on one rank returns the single-device
    adapter's heatmaps bit for bit, its batcher filling toward ``n *
    max_batch`` seats."""
    _, params, x = setup

    def adapter(device):
        return tserve.CNNAdapter.from_engine(build(EngineSpec(
            CNNModel(params, CFG, device="cpu"), device=device)))

    mk = lambda: [tserve.Request(uid=f"r{i}", kind="explain", x=x[i],
                                 method="saliency") for i in range(3)]
    single = server(tserve, adapter("edge-small"))
    meshed = server(tserve, adapter(f"mesh:edge-small:{n_shards}"))
    assert meshed.batcher.fill_target == 4 * n_shards
    out_s, out_m = burst(single, mk()), burst(meshed, mk())
    assert [r.uid for r in out_s] == [r.uid for r in out_m]
    for a, b in zip(out_s, out_m):
        assert a.ok and b.ok
        assert torch.equal(a.relevance, b.relevance)


def test_server_on_several_ranks_serves_through_followers(setup, tmp_path):
    """On a gloo world of 2 ranks (``tests/_torch_dist.py``), rank 0
    serves through ``follower.lead`` and rank 1 follows: predicts, their
    hits and cold explains come back bitwise the single-process server's
    on the same ``mesh:edge-small:2`` seats, every header sent in two
    broadcasts; a server on the multi-rank mesh without the call stream
    is refused before any launch."""
    from _torch_dist import followers_requests, run_worlds
    jparams, params, x = setup
    params_np = jax.tree.map(np.asarray, jparams)
    got = run_worlds(tmp_path, {"2": ("serve_followers_scenario", 2,
                                      dict(params_np=params_np, x=x))})["2"]
    adapter = tserve.CNNAdapter.from_engine(build(EngineSpec(
        CNNModel(params, CFG, device="cpu"), device="mesh:edge-small:2")))
    want = burst(server(tserve, adapter), followers_requests(tserve, x))
    assert got[0]["refused"] == "ValueError"
    assert [r.uid for r in want] == [r["uid"] for r in got[0]["responses"]]
    for a, b in zip(got[0]["responses"], want):
        assert a["ok"] and b.ok and a["cache_hit"] == b.cache_hit
        assert torch.equal(a["logits"], b.logits)
        if b.relevance is not None:
            assert torch.equal(a["relevance"], b.relevance)
    assert got[1]["calls"] == {"predict": 2, "explain_cached": 2,
                               "stop": 1}
    # a launch: two header broadcasts, the payload, two agreements; the
    # stop's header fits in one
    assert got[1]["collectives"] == 4 * 5 + 1


# -- the driver ---------------------------------------------------------------


def run_driver(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_driver_serves_cnn_on_the_cpu():
    r = run_driver("--workload", "cnn", "--torch-device", "cpu",
                   "--requests", "4", "--metrics")
    assert r.returncode == 0, r.stderr
    assert "8 responses" in r.stdout and "cache hits 4/4" in r.stdout
    assert "0 errors" in r.stdout and "serve_requests_total" in r.stdout


def test_driver_serves_a_mesh_sharded_engine(capsys):
    """The driver serves a mesh-sharded engine in one process: 4 shards,
    its batcher filling 4 x batch seats a launch."""
    from repro_torch.launch import serve as driver
    driver.main(["--workload", "cnn", "--torch-device", "cpu",
                 "--device-profile=mesh:edge-small:4", "--requests", "4",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert "mesh-sharded engine: 4 shards, batcher fills 8 seats" in out
    assert "8 responses" in out and "0 errors" in out
