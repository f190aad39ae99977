"""The fxp16 slice of repro_torch against the JAX package, bit for bit.

The paper's true-int16 datapath (``precision="fxp16"``) end to end: the
Table III CNN at the golden tiny config (``tests/golden/generate.py``,
recomputed live, never read from the ``.npz``) and at Table III width
(batch 2), for each method.  Parameters are the JAX package's
``cnn.init(PRNGKey(0))`` as NumPy; the input is drawn once with NumPy.  The
reference is the JAX engine (``repro.engine``, its Pallas kernels in
interpret mode) with ``TopK(3)`` targets.  Integer arithmetic throughout,
so everything is compared bitwise:

* logits, every residual byte and the relevance of ``Engine.explain``;
* the model-level pair (``forward_with_residuals`` / ``backward_seeds``);
* cross-replay both ways: the torch backward on JAX's residuals and the
  JAX backward on torch's;
* ``predict`` and logits-only ``apply``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.models import cnn as jcnn
from repro_torch.engine import CNNModel, EngineSpec, TopK, build
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
SIZES = {
    # tests/golden/generate.py CFG
    "tiny": dict(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3,
                 fc=(16,), num_classes=4),
    "table3": {},
}
BATCH, TOPK = 2, 3


def _jres_to_torch(res, feat_shape):
    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    return {"conv": [(t(m), t(i)) for m, i in res["conv"]],
            "fc": [t(m) for m in res["fc"]], "feat_shape": feat_shape}


def _tres_to_jax(res):
    def j(a):
        return None if a is None else jnp.asarray(a.numpy())

    return {"conv": [(j(m), j(i)) for m, i in res["conv"]],
            "fc": [j(m) for m in res["fc"]]}


class _Run:
    """Both packages' fxp16 engines on one size and method, run once."""

    def __init__(self, size, method):
        kw = SIZES[size]
        self.jcfg, self.cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
        self.jparams = jcnn.init(jax.random.PRNGKey(0), self.jcfg)
        self.params = cnn.params_from_jax(
            jax.tree.map(np.asarray, self.jparams))
        h, w = self.cfg.in_hw
        self.x = np.random.RandomState(1).randn(
            BATCH, h, w, self.cfg.in_ch).astype(np.float32)
        self.method = method
        self.jeng = jengine.build(jengine.EngineSpec(
            jengine.CNNModel(self.jparams, self.jcfg), method=method,
            precision="fxp16", targets=jengine.TopK(TOPK)))
        jl, jrel, self.jres = self.jeng.predict_then_explain(
            jnp.asarray(self.x))
        self.jlogits, self.jrel = np.asarray(jl), np.asarray(jrel)
        top = np.asarray(jax.lax.top_k(jl, TOPK)[1])            # [B, K]
        self.seeds = np.eye(self.cfg.num_classes, dtype=np.float32)[top.T]
        self.eng = build(EngineSpec(
            CNNModel(self.params, self.cfg, device="cpu"), method=method,
            precision="fxp16", targets=TopK(TOPK)))
        self.logits, self.rel, self.res = self.eng.predict_then_explain(
            self.x)


_RUNS = {}


@pytest.fixture(scope="module")
def run():
    def get(size, method):
        if (size, method) not in _RUNS:
            _RUNS[size, method] = _Run(size, method)
        return _RUNS[size, method]

    yield get
    _RUNS.clear()


CASES = [(s, m) for s in SIZES for m in METHODS]


def _eq(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,method", CASES)
def test_engine_explain_matches_jax_engine_bitwise(run, size, method):
    r = run(size, method)
    assert r.logits.dtype == r.rel.dtype == torch.float32
    _eq(r.logits, r.jlogits)
    assert tuple(r.rel.shape) == (TOPK, BATCH) + r.x.shape[1:]
    _eq(r.rel, r.jrel)
    logits, rel = r.eng.explain(r.x)
    assert torch.equal(logits, r.logits) and torch.equal(rel, r.rel)


@pytest.mark.parametrize("size,method", CASES)
def test_residual_bytes_match_bitwise(run, size, method):
    r = run(size, method)
    assert r.res["feat_shape"] == (r.jcfg.feature_hw()
                                   + (r.jcfg.channels[-1],))
    pairs = [(j, t) for jp, tp in zip(r.jres["conv"], r.res["conv"])
             for j, t in zip(jp, tp)] + list(zip(r.jres["fc"], r.res["fc"]))
    assert len(pairs) == 2 * len(r.jcfg.channels) + len(r.jcfg.fc) + 1
    for j, t in pairs:
        assert (j is None) == (t is None)
        if j is not None:
            assert t.dtype == torch.uint8
            _eq(t, j)


@pytest.mark.parametrize("size,method", CASES)
def test_model_pair_matches_engine(run, size, method):
    r = run(size, method)
    x = torch.from_numpy(r.x)
    logits, res = cnn.forward_with_residuals(r.params, x, r.cfg, method,
                                             "fxp16")
    assert torch.equal(logits, r.logits)
    rel = cnn.backward_seeds(r.params, res, torch.from_numpy(r.seeds),
                             r.cfg, method, "fxp16")
    _eq(rel, r.jrel)
    for prec_method in METHODS:       # logits are rule-invariant
        assert torch.equal(cnn.apply(r.params, x, r.cfg, method=prec_method,
                                     precision="fxp16"), r.logits)
    assert torch.equal(r.eng.predict(r.x), r.logits)


@pytest.mark.parametrize("size,method", CASES)
def test_torch_backward_replays_jax_residuals_bitwise(run, size, method):
    r = run(size, method)
    res = _jres_to_torch(r.jres, r.res["feat_shape"])
    _eq(r.eng.replay(res, r.seeds), r.jrel)


@pytest.mark.parametrize("size,method", CASES)
def test_jax_backward_replays_torch_residuals_bitwise(run, size, method):
    r = run(size, method)
    rel = r.jeng.replay(_tres_to_jax(r.res), jnp.asarray(r.seeds))
    _eq(r.rel, rel)


def test_replay_equals_cold_explain_bitwise(run):
    r = run("tiny", "guided")
    other = (torch.argmax(r.logits, -1) + 1) % r.cfg.num_classes
    seeds = torch.nn.functional.one_hot(other, r.cfg.num_classes).float()
    replayed = r.eng.replay(r.res, seeds[None])[0]
    _, cold = r.eng.explain(r.x, target=other)
    assert torch.equal(replayed, cold)


def test_bf16_and_vjp_raise_as_specified():
    """bf16 resolves to the seed-batched pair and runs it; under vjp
    (ROADMAP A6d, ported) it explains through autograd as the JAX
    package's engine does (bf16 logits, f32 relevance, within 2^-6 of
    max); fxp16 under vjp is refused as integer arithmetic, here and in
    the JAX package."""
    cfg = cnn.CNNConfig(**SIZES["tiny"])
    jcfg = jcnn.CNNConfig(**SIZES["tiny"])
    jp = jcnn.init(jax.random.PRNGKey(0), jcfg)
    p = cnn.params_from_jax(jax.tree.map(np.asarray, jp))
    model = CNNModel(p, cfg, device="cpu")
    assert EngineSpec(model, precision="bf16").resolve_backward() \
        == "seed_batched"
    x = np.random.RandomState(2).randn(2, 8, 8, 3).astype(np.float32)
    logits, rel = build(EngineSpec(model, precision="bf16",
                                   backward="vjp")).explain(x)
    jlogits, jrel = jengine.build(jengine.EngineSpec(
        jengine.CNNModel(jp, jcfg), precision="bf16",
        backward="vjp")).explain(jnp.asarray(x))
    assert logits.dtype == torch.bfloat16 and rel.dtype == torch.float32
    assert jlogits.dtype == jnp.bfloat16 and jrel.dtype == jnp.float32
    for t, j in ((logits, jlogits), (rel, jrel)):
        j = np.asarray(j.astype(jnp.float32))
        assert np.abs(t.float().numpy() - j).max() <= 2.0 ** -6 * \
            np.abs(j).max()
    pair_logits, _ = cnn.forward_with_residuals(
        p, torch.from_numpy(x), cfg, "saliency", precision="bf16")
    assert torch.equal(logits, pair_logits)
    with pytest.raises(ValueError, match="integer arithmetic"):
        EngineSpec(model, precision="fxp16", backward="vjp")
    with pytest.raises(ValueError, match="integer arithmetic"):
        jengine.EngineSpec(jengine.CNNModel(jp, jcfg), precision="fxp16",
                           backward="vjp")
    assert EngineSpec(model, precision="fxp16",
                      backward="seed_batched").precision == "fxp16"
