"""The Table III CNN of repro_torch against repro.models.cnn, end to end.

Two sizes: the golden tiny config (``tests/golden/generate.py``, recomputed
live here, never read from the ``.npz``) and the full Table III width at
batch 2.  Parameters are the JAX package's ``cnn.init(PRNGKey(0))`` turned
to NumPy; the input is drawn once with NumPy.  For each method:

* logits within 1e-5 * max|ref|;
* residual bytes equal, or different only where the JAX pre-activation is
  within 1e-5 * max|y| of 0 (a mask bit) or two window candidates are
  within that of each other (a crumb);
* cross-replay both ways within 1e-4 * max|rel|: the torch backward on
  JAX's residuals and the JAX backward on torch's;
* Spearman >= 0.999 between the heatmaps.

The JAX reference runs its jitted pair once per (size, method); its
Pallas kernels run in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import methods as jmethods
from repro.engine.spec import CNNModel as JCNNModel
from repro.kernels.conv2d import ref as jconv_ref
from repro.models import cnn as jcnn
from repro_torch.core import fidelity
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
    """Both packages on one size and method, each computed once."""

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
        fwd, bwd = JCNNModel(self.jparams, self.jcfg).pair(method, "f32")
        self.jbwd = jax.jit(bwd)
        jl, self.jres = jax.jit(fwd)(jnp.asarray(self.x))
        self.jlogits = np.asarray(jl)
        top = np.argsort(-self.jlogits, axis=-1, kind="stable")[:, :TOPK]
        self.seeds = np.eye(self.cfg.num_classes, dtype=np.float32)[top.T]
        self.jrel = np.asarray(self.jbwd(self.jres, jnp.asarray(self.seeds)))
        self.logits, self.res = cnn.forward_with_residuals(
            self.params, torch.from_numpy(self.x), self.cfg, method)
        self.rel = cnn.backward_seeds(self.params, self.res,
                                      torch.from_numpy(self.seeds), self.cfg,
                                      method).numpy()


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


def _rel_close(got, want, tol):
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("size,method", CASES)
def test_logits_match(run, size, method):
    r = run(size, method)
    _rel_close(r.logits.numpy(), r.jlogits, 1e-5)


def _preacts(r):
    """JAX pre-activations (and pooled-window inputs) per layer, lax ops."""
    h = jnp.asarray(r.x)
    conv_pre, pool_in = [], []
    for i, p in enumerate(r.jparams["conv"]):
        y = jconv_ref.conv2d(h, p["w"]) + p["b"]
        conv_pre.append(np.asarray(y))
        h = jnp.maximum(y, 0)
        if (i + 1) % r.cfg.pool_every == 0:
            pool_in.append(np.asarray(h))
            n, hh, ww, c = h.shape
            h = h.reshape(n, hh // 2, 2, ww // 2, 2, c).max(axis=(2, 4))
        else:
            pool_in.append(None)
    h = h.reshape(h.shape[0], -1)
    fc_pre = []
    for p in r.jparams["fc"]:
        y = h @ p["w"] + p["b"]
        fc_pre.append(np.asarray(y))
        h = jnp.maximum(y, 0)
    return conv_pre, pool_in, fc_pre


def _bits(m, c):
    return np.unpackbits(m, axis=-1, bitorder="little")[..., :c]


def _crumbs(i, c):
    return np.stack([(i >> (2 * j)) & 3 for j in range(4)],
                    axis=-1).reshape(i.shape[:-1] + (-1,))[..., :c]


def _assert_mask_diffs_near_zero(jm, tm, pre):
    diff = _bits(jm, pre.shape[-1]) != _bits(tm, pre.shape[-1])
    assert np.all(np.abs(pre[diff]) <= 1e-5 * np.abs(pre).max())


def _assert_crumb_diffs_near_ties(ji, ti, x):
    n, h, w, c = x.shape
    cands = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(
        0, 1, 3, 5, 2, 4).reshape(n, h // 2, w // 2, c, 4)
    jc, tc = _crumbs(ji, c), _crumbs(ti, c)
    diff = jc != tc
    picked_j = np.take_along_axis(cands, jc[..., None], -1)[..., 0]
    picked_t = np.take_along_axis(cands, tc[..., None], -1)[..., 0]
    gap = np.abs(picked_j - picked_t)[diff]
    assert np.all(gap <= 1e-5 * np.abs(x).max())


@pytest.mark.parametrize("size,method", CASES)
def test_residual_bytes_match(run, size, method):
    r = run(size, method)
    assert r.res["feat_shape"] == (r.jcfg.feature_hw()
                                   + (r.jcfg.channels[-1],))
    pairs = [(jm, tm) for (jm, _), (tm, _) in zip(r.jres["conv"],
                                                  r.res["conv"])]
    pairs += [(ji, ti) for (_, ji), (_, ti) in zip(r.jres["conv"],
                                                   r.res["conv"])]
    pairs += list(zip(r.jres["fc"], r.res["fc"]))
    assert len(r.res["conv"]) == len(r.jres["conv"])
    assert len(r.res["fc"]) == len(r.jres["fc"])
    if all((j is None and t is None) or (
            j is not None and t is not None
            and np.array_equal(np.asarray(j), t.numpy())) for j, t in pairs):
        return
    assert size != "tiny", "the golden config must match byte for byte"
    conv_pre, pool_in, fc_pre = _preacts(r)
    for i, ((jm, ji), (tm, ti)) in enumerate(zip(r.jres["conv"],
                                                 r.res["conv"])):
        assert (jm is None) == (tm is None) and (ji is None) == (ti is None)
        assert jm is None or jm.shape == tuple(tm.shape)
        assert ji is None or ji.shape == tuple(ti.shape)
        if jm is not None:
            _assert_mask_diffs_near_zero(np.asarray(jm), tm.numpy(),
                                         conv_pre[i])
        if ji is not None:
            _assert_crumb_diffs_near_ties(np.asarray(ji), ti.numpy(),
                                          pool_in[i])
    for jm, tm, pre in zip(r.jres["fc"], r.res["fc"], fc_pre):
        assert (jm is None) == (tm is None)
        if jm is not None:
            _assert_mask_diffs_near_zero(np.asarray(jm), tm.numpy(), pre)


@pytest.mark.parametrize("size,method", CASES)
def test_relevance_matches_and_ranks_alike(run, size, method):
    r = run(size, method)
    assert r.rel.shape == r.jrel.shape == (TOPK, BATCH) + r.x.shape[1:]
    _rel_close(r.rel, r.jrel, 1e-4)
    for s in range(TOPK):
        for b in range(BATCH):
            hj = np.asarray(jmethods.heatmap(jnp.asarray(r.jrel[s, b])))
            ht = np.asarray(jmethods.heatmap(jnp.asarray(r.rel[s, b])))
            assert fidelity.spearman(hj, ht) >= 0.999


@pytest.mark.parametrize("size,method", CASES)
def test_torch_backward_replays_jax_residuals(run, size, method):
    r = run(size, method)
    res = _jres_to_torch(r.jres, r.res["feat_shape"])
    rel = cnn.backward_seeds(r.params, res, torch.from_numpy(r.seeds),
                             r.cfg, method)
    _rel_close(rel.numpy(), r.jrel, 1e-4)


@pytest.mark.parametrize("size,method", CASES)
def test_jax_backward_replays_torch_residuals(run, size, method):
    r = run(size, method)
    rel = r.jbwd(_tres_to_jax(r.res), jnp.asarray(r.seeds))
    _rel_close(np.asarray(rel), r.rel, 1e-4)


def test_apply_is_the_forward_logits(run):
    r = run("tiny", "guided")
    logits = cnn.apply(r.params, torch.from_numpy(r.x), r.cfg,
                       method="guided", use_pallas=True)
    assert torch.equal(logits, r.logits)


def test_init_and_config_shapes():
    cfg = cnn.CNNConfig()
    p = cnn.init(torch.Generator().manual_seed(0), cfg)
    jcfg = jcnn.CNNConfig()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.flat_features() == jcfg.flat_features() == 4096
    shapes = [tuple(q["w"].shape) for q in p["conv"] + p["fc"]]
    assert shapes == [(3, 3, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64),
                      (3, 3, 64, 64), (4096, 128), (128, 10)]
    assert sum(q["w"].numel() + q["b"].numel()
               for q in p["conv"] + p["fc"]) == cfg.param_count()
    again = cnn.init(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["fc"][0]["w"], p["fc"][0]["w"])


@pytest.mark.parametrize("precision", ["bf16", "fxp16"])
def test_other_precisions_are_not_ported_yet(precision):
    """The other precisions on a bfloat16 config: both run their pair, on
    the same numbers as the f32 config holding the same (bf16-valued)
    params.  bf16 under autograd (ROADMAP A6d, ported) explains through
    the vjp backend as the JAX package's engine does: bf16 logits, f32
    relevance, within 2^-6 of max (``tests/test_torch_vjp_bf16.py``);
    fxp16 has no vjp at all, here and in the JAX package."""
    from repro import engine as jengine
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    cfg = cnn.CNNConfig(**SIZES["tiny"])
    bf16_cfg = cnn.CNNConfig(**SIZES["tiny"], dtype="bfloat16")
    p16 = cnn.init(torch.Generator().manual_seed(0), bf16_cfg)
    p32 = {k: [{n: v.float() for n, v in q.items()} for q in p16[k]]
           for k in ("conv", "fc")}
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    got, res = cnn.forward_with_residuals(p16, x, bf16_cfg, "saliency",
                                          precision=precision)
    want, res32 = cnn.forward_with_residuals(p32, x, cfg, "saliency",
                                             precision=precision)
    assert torch.equal(got, want)
    assert torch.equal(res["fc"][0], res32["fc"][0])     # the hidden FC
    if precision == "fxp16":
        with pytest.raises(ValueError, match="integer arithmetic"):
            EngineSpec(CNNModel(p16, bf16_cfg, device="cpu"),
                       precision=precision, backward="vjp")
        return
    jcfg = jcnn.CNNConfig(**SIZES["tiny"], dtype="bfloat16")
    jp16 = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16), p16)
    eng = build(EngineSpec(CNNModel(p16, bf16_cfg, device="cpu"),
                           precision="bf16", backward="vjp",
                           targets=TopK(2)))
    jeng = jengine.build(jengine.EngineSpec(
        jengine.CNNModel(jp16, jcfg), precision="bf16", backward="vjp",
        targets=jengine.TopK(2)))
    logits, rel = eng.explain(x)
    jlogits, jrel = jeng.explain(jnp.asarray(x.numpy()))
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    assert rel.dtype == torch.float32 and jrel.dtype == jnp.float32
    assert torch.equal(logits, got)
    for t, j in ((logits, jlogits), (rel, jrel)):
        j = np.asarray(j.astype(jnp.float32))
        assert np.abs(t.float().numpy() - j).max() <= 2.0 ** -6 * \
            np.abs(j).max()
