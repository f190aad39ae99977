"""The Table III CNN's bf16 path in repro_torch against repro's, end to end.

``precision="bf16"`` casts params, input and seeds to bf16, as the JAX
package does (``repro/models/cnn.py:476-478, 527-529``), and runs the bf16
instances of the kernels; on the CPU their plain versions: f32 sums of the
widened operands, each layer's output rounded once to bf16, the forward's
bias added after that rounding.  Two sizes, the golden tiny config and
``configs.paper_cnn.SMOKE``, every method, against the JAX package's
jitted pair and engine (its Pallas kernels in interpret mode) on the same
NumPy inputs.

Tolerance: a bf16 output is its f32 sum rounded once, so where the two
packages sum in another order a value can land one rounding step (2^-7 of
it, at most) apart, and four layers carry such steps on: logits and
relevance within ``TOL = 2^-6 * max|ref|``.  Residual bits (masks, crumbs)
are bitwise except where such a step moves a pre-activation across 0 or
reorders a tied pool window; those examples are replayed on the
reference's residuals, which must then agree within ``TOL`` too.
Heatmaps must rank alike: ``fidelity.compare`` at least ``FLOORS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import CNNModel as JCNNModel
from repro.engine import EngineSpec as JEngineSpec
from repro.engine import Fixed as JFixed
from repro.engine import TopK as JTopK
from repro.engine import build as jbuild
from repro.engine import methods as jmethods
from repro.models import cnn as jcnn
from repro_torch.configs import paper_cnn
from repro_torch.core import fidelity
from repro_torch.engine import (CNNModel, EngineSpec, Fixed, TopK, build,
                                clear_cache)
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
SIZES = {
    # tests/golden/generate.py CFG
    "tiny": dict(in_hw=(8, 8), in_ch=3, channels=(4, 4), kernel=3,
                 fc=(16,), num_classes=4),
    "smoke": {f.name: getattr(paper_cnn.SMOKE, f.name) for f in
              paper_cnn.SMOKE.__dataclass_fields__.values()},
}
BATCH, TOPK = 3, 2
TOL = 2.0 ** -6
#: Heatmap agreement (``fidelity.compare``, k = 16) with the reference.
FLOORS = {"spearman": 0.99, "topk_overlap": 0.75, "sign_agreement": 0.99}


def _f32(a):
    """A JAX or torch array as f32 NumPy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * ref, (what, err, ref)


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


def _flipped_examples(jres, tres):
    """Examples (batch rows) whose stored bits differ between the two."""
    rows = set()
    pairs = [(a, b) for (ja, jb), (ta, tb) in zip(jres["conv"], tres["conv"])
             for a, b in ((ja, ta), (jb, tb))]
    pairs += list(zip(jres["fc"], tres["fc"]))
    for j, t in pairs:
        assert (j is None) == (t is None)
        if j is None:
            continue
        d = np.asarray(j) != t.numpy()
        rows |= set(np.nonzero(d.reshape(d.shape[0], -1).any(-1))[0])
    return sorted(int(r) for r in rows)


class _Run:
    """Both packages' bf16 pair on one size and method, computed once."""

    def __init__(self, size, method):
        kw = SIZES[size]
        self.jcfg, self.cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
        self.jparams = jcnn.init(jax.random.PRNGKey(0), self.jcfg)
        self.params = cnn.params_from_jax(
            jax.tree.map(np.asarray, self.jparams))
        h, w = self.cfg.in_hw
        self.x = np.random.RandomState(1).randn(
            BATCH, h, w, self.cfg.in_ch).astype(np.float32)
        fwd, bwd = JCNNModel(self.jparams, self.jcfg).pair(method, "bf16")
        self.jbwd = jax.jit(bwd)
        self.jlogits, self.jres = jax.jit(fwd)(jnp.asarray(self.x))
        top = np.argsort(-_f32(self.jlogits), axis=-1,
                         kind="stable")[:, :TOPK]
        self.seeds = np.eye(self.cfg.num_classes, dtype=np.float32)[top.T]
        self.jrel = self.jbwd(self.jres, jnp.asarray(self.seeds))
        self.logits, self.res = cnn.forward_with_residuals(
            self.params, torch.from_numpy(self.x), self.cfg, method, "bf16")
        self.rel = cnn.backward_seeds(self.params, self.res,
                                      torch.from_numpy(self.seeds),
                                      self.cfg, method, "bf16")
        self.flipped = _flipped_examples(self.jres, self.res)


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


@pytest.mark.parametrize("size,method", CASES)
def test_logits_are_bf16_and_match(run, size, method):
    r = run(size, method)
    assert r.logits.dtype == torch.bfloat16
    assert r.jlogits.dtype == jnp.bfloat16
    _close(r.logits, r.jlogits, "logits")


@pytest.mark.parametrize("size,method", CASES)
def test_residual_bits_match(run, size, method):
    """Same packed formats; bitwise on the golden config, and elsewhere
    on every example but those a rounding step flips (replayed below)."""
    r = run(size, method)
    assert r.res["feat_shape"] == (r.jcfg.feature_hw()
                                   + (r.jcfg.channels[-1],))
    if size == "tiny":
        assert r.flipped == []
    assert len(r.flipped) < BATCH
    keep = [b for b in range(BATCH) if b not in r.flipped]
    for (jm, ji), (tm, ti) in zip(r.jres["conv"], r.res["conv"]):
        for j, t in ((jm, tm), (ji, ti)):
            assert (j is None) == (t is None)
            if j is not None:
                assert t.dtype == torch.uint8 and j.shape == tuple(t.shape)
                np.testing.assert_array_equal(np.asarray(j)[keep],
                                              t.numpy()[keep])
    for j, t in zip(r.jres["fc"], r.res["fc"]):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_array_equal(np.asarray(j)[keep],
                                          t.numpy()[keep])


@pytest.mark.parametrize("size,method", CASES)
def test_relevance_matches_and_ranks_alike(run, size, method):
    r = run(size, method)
    assert r.rel.dtype == torch.bfloat16
    assert r.rel.shape == (TOPK, BATCH) + r.x.shape[1:]
    keep = [b for b in range(BATCH) if b not in r.flipped]
    _close(r.rel[:, keep], _f32(r.jrel)[:, keep], "relevance")
    for s in range(TOPK):
        for b in keep:
            hj = jmethods.heatmap(jnp.asarray(_f32(r.jrel)[s, b]))
            ht = jmethods.heatmap(jnp.asarray(_f32(r.rel)[s, b]))
            got = fidelity.compare(np.asarray(hj), np.asarray(ht), k=16)
            for metric, floor in FLOORS.items():
                assert got[metric] >= floor, (s, b, got)


@pytest.mark.parametrize("size,method", CASES)
def test_torch_backward_replays_jax_residuals(run, size, method):
    """Every example, the flipped ones included, on the reference's bits."""
    r = run(size, method)
    res = _jres_to_torch(r.jres, r.res["feat_shape"])
    rel = cnn.backward_seeds(r.params, res, torch.from_numpy(r.seeds),
                             r.cfg, method, "bf16")
    assert rel.dtype == torch.bfloat16
    _close(rel, r.jrel, "torch backward on JAX residuals")


@pytest.mark.parametrize("size,method", CASES)
def test_jax_backward_replays_torch_residuals(run, size, method):
    r = run(size, method)
    rel = r.jbwd(_tres_to_jax(r.res), jnp.asarray(r.seeds))
    _close(r.rel, rel, "JAX backward on torch residuals")


# -- the engine: fan-out, replay, the config's dtype -------------------------


KW = SIZES["tiny"]


@pytest.fixture(scope="module")
def engines():
    """Both engines' bf16 builds on the tiny config, and an input."""
    jcfg, cfg = jcnn.CNNConfig(**KW), cnn.CNNConfig(**KW)
    jparams = jcnn.init(jax.random.PRNGKey(3), jcfg)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.RandomState(5).randn(4, 8, 8, 3).astype(np.float32)
    clear_cache()

    def make(method, targets, jtargets, jp=jparams, p=params, c=cfg,
             jc=jcfg, precision="bf16"):
        eng = build(EngineSpec(CNNModel(p, c, device="cpu"), method=method,
                               precision=precision, targets=targets))
        jeng = jbuild(JEngineSpec(JCNNModel(jp, jc), method=method,
                                  precision=precision, targets=jtargets))
        return eng, jeng

    yield make, x
    clear_cache()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("targets", ["topk", "fixed"])
def test_engine_explain_matches_repro(engines, method, targets):
    make, x = engines
    t, jt = ((TopK(3), JTopK(3)) if targets == "topk"
             else (Fixed(1), JFixed(1)))
    eng, jeng = make(method, t, jt)
    logits, rel = eng.explain(x)
    jlogits, jrel = jeng.explain(x)
    assert logits.dtype == rel.dtype == torch.bfloat16
    assert tuple(rel.shape) == jrel.shape
    _close(logits, jlogits, "engine logits")
    _close(rel, jrel, "engine relevance")


def test_replay_equals_cold_explain_and_repro(engines):
    """The engine's replay (the pair-level replays above run every
    method) equals a cold explain bitwise, and repro's replay."""
    make, x = engines
    eng, jeng = make("guided", TopK(2), JTopK(2))
    logits, rel, res = eng.predict_then_explain(x)
    assert torch.equal(eng.predict(x), logits)
    other = (torch.argmax(logits.float(), -1) + 1) % KW["num_classes"]
    seeds = torch.nn.functional.one_hot(other, KW["num_classes"]).float()
    replayed = eng.replay(res, seeds[None])[0]
    _, cold = eng.explain(x, target=other)
    assert torch.equal(replayed, cold)
    _, _, jres = jeng.predict_then_explain(x)
    _close(replayed, jeng.replay(jres, jnp.asarray(seeds.numpy())[None])[0],
           "replay")


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_bfloat16_config_matches_repro(engines, precision):
    """``CNNConfig(dtype="bfloat16")``: bf16 params (the JAX package's
    init); under bf16 the explain is bf16, under f32 the params widen (the
    JAX blocks promote them) and the explain is f32."""
    make, x = engines
    kw = dict(KW, dtype="bfloat16")
    jcfg, cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
    jparams = jcnn.init(jax.random.PRNGKey(4), jcfg)
    assert jparams["conv"][0]["w"].dtype == jnp.bfloat16
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    own = cnn.init(torch.Generator().manual_seed(0), cfg)
    assert own["conv"][0]["w"].dtype == own["fc"][0]["b"].dtype \
        == torch.bfloat16
    eng, jeng = make("guided", TopK(2), JTopK(2), jparams, params, cfg,
                     jcfg, precision)
    logits, rel = eng.explain(x)
    jlogits, jrel = jeng.explain(x)
    want = torch.bfloat16 if precision == "bf16" else torch.float32
    assert logits.dtype == rel.dtype == want
    assert jnp.asarray(jrel).dtype == (jnp.bfloat16 if precision == "bf16"
                                       else jnp.float32)
    _close(logits, jlogits, "logits")
    _close(rel, jrel, "relevance")


def test_bf16_relevance_ranks_like_f32(engines):
    """bf16 against the same model in f32: the heatmaps rank alike."""
    make, x = engines
    eng16, _ = make("saliency", TopK(2), JTopK(2))
    eng32, _ = make("saliency", TopK(2), JTopK(2), precision="f32")
    _, r16 = eng16.explain(x)
    _, r32 = eng32.explain(x)
    got = fidelity.compare(r16.float().abs().sum(-1),
                           r32.abs().sum(-1), k=16)
    assert got["spearman"] >= 0.99 and got["sign_agreement"] >= 0.99


# -- the wrappers: bf16 exactly where an instance exists ----------------------


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrappers take their kernel route on CPU tensors
    and record ``(entry, args)`` instead of launching."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import conv2d as conv_mod
    from repro_torch.kernels.pool import pool as pool_mod
    from repro_torch.kernels.relu_mask import relu_mask as relu_mod
    from repro_torch.kernels.vmm import vmm as vmm_mod
    out = []
    for mod in (conv_mod, vmm_mod, pool_mod, relu_mod):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "check_kernel_operands",
                            lambda name, *ts: None)
    monkeypatch.setattr(_build, "launch",
                        lambda counter, entry, device, *args, **kw:
                        out.append((counter, entry, args)))
    return out


def test_bf16_wrappers_launch_their_bf16_entries(launches):
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d.conv2d import (conv2d, conv2d_bwd_fused,
                                                   conv_bf16_plan,
                                                   conv_bwd_plan,
                                                   conv_mma_plan)
    from repro_torch.kernels.pool.pool import (maxpool_fwd, relu_pool_fwd,
                                               unpool_bwd)
    from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd
    from repro_torch.kernels.vmm.vmm import (vmm, vmm_bwd_fused,
                                             vmm_bwd_mma_plan, vmm_mma_plan)
    bf = torch.bfloat16
    x = torch.zeros(2, 8, 8, 16, dtype=bf)
    conv2d(x, torch.zeros(3, 3, 16, 8, dtype=bf), torch.zeros(8, dtype=bf))
    conv2d_bwd_fused(torch.zeros(3, 2, 8, 8, 8, dtype=bf),
                     torch.zeros(3, 3, 8, 16, dtype=bf))
    vmm(torch.zeros(32, 4096, dtype=bf), torch.zeros(4096, 128, dtype=bf))
    vmm_bwd_fused(torch.zeros(3, 32, 128, dtype=bf),
                  torch.zeros(128, 10, dtype=bf))
    relu_fwd(torch.zeros(4, 16, dtype=bf))
    maxpool_fwd(x)
    relu_pool_fwd(x)
    # the bf16 autograd paths' gate and unpool
    relu_bwd(torch.zeros(4, 2, dtype=torch.uint8),
             torch.zeros(4, 16, dtype=bf), "guided")
    unpool_bwd(torch.zeros(2, 4, 4, 4, dtype=torch.uint8),
               torch.zeros(2, 4, 4, 16, dtype=bf))
    got = [(c, e) for c, e, _ in launches]
    assert got == [
        ("conv2d_fwd", "repro_conv2d_fwd_bf16"),
        ("conv2d_bwd_fused", "repro_conv2d_bwd_fused_bf16"),
        ("vmm_fwd", "repro_vmm_fwd_bf16"),
        ("vmm_bwd_fused", "repro_vmm_bwd_fused_bf16"),
        ("relu_fwd", "repro_relu_fwd_bf16"),
        ("maxpool_fwd", "repro_maxpool_fwd_bf16"),
        ("relu_pool_fwd", "repro_relu_pool_fwd_bf16"),
        ("relu_bwd", "repro_relu_bwd_bf16"),
        ("unpool_bwd", "repro_unpool_bwd_bf16")]
    for _, entry, args in launches:
        assert len(args) + 1 == len(_build.SIGNATURES[entry])
    # the forwards on the tensor cores: the conv (Cin 16) on route 1 and
    # its plan, FC0 with no workspace, a cluster's K slices and a column
    # tile; the conv backward (C 8) on route 0, its tile plan at 2-byte
    # elements; the FC backward's tensor-core plan
    plan = conv_bf16_plan(2, 8, 8, 16, 8, 3)
    assert plan == conv_mma_plan(2, 8, 8, 16, 8, 3)
    assert launches[0][2][10:] == (1,) + plan.args()
    assert launches[1][2][-7:] == (0,) + conv_bwd_plan(3, 2, 8, 8, 8, 16, 3,
                                                       esize=2).args()
    assert launches[2][2][7:] == vmm_mma_plan(32, 4096, 128).args(4096)
    assert launches[3][2][-5:] == vmm_bwd_mma_plan(3, 32, 128, 10).args()


@pytest.mark.parametrize("method", METHODS)
def test_bf16_pair_launches_only_bf16_entries(launches, method):
    """The seed-batched bf16 pair, on a stubbed card, reaches every kernel
    through its bf16 entry point: a missed cast of the params, the input or
    the seeds would launch an f32 instance (the outputs are the stub's
    uninitialised buffers; only the routing is checked)."""
    cfg = cnn.CNNConfig(**SIZES["smoke"])
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    h, w = cfg.in_hw
    x = torch.from_numpy(np.random.RandomState(1).randn(
        BATCH, h, w, cfg.in_ch).astype(np.float32))
    logits, res = cnn.forward_with_residuals(params, x, cfg, method, "bf16")
    seeds = torch.eye(cfg.num_classes)[:TOPK, None].expand(
        TOPK, BATCH, cfg.num_classes)
    rel = cnn.backward_seeds(params, res, seeds, cfg, method, "bf16")
    assert logits.dtype == rel.dtype == torch.bfloat16
    got = {}
    for counter, entry, _ in launches:
        got[counter, entry] = got.get((counter, entry), 0) + 1
    n_conv, n_fc = len(cfg.channels), len(cfg.fc) + 1
    n_pool = n_conv // cfg.pool_every
    want = {("conv2d_fwd", "repro_conv2d_fwd_bf16"): n_conv,
            ("relu_pool_fwd", "repro_relu_pool_fwd_bf16"): n_pool,
            ("vmm_fwd", "repro_vmm_fwd_bf16"): n_fc,
            ("conv2d_bwd_fused", "repro_conv2d_bwd_fused_bf16"): n_conv,
            ("vmm_bwd_fused", "repro_vmm_bwd_fused_bf16"): n_fc}
    if method != "deconvnet":      # Table II: no mask stored for deconvnet
        want["relu_fwd", "repro_relu_fwd_bf16"] = (n_conv - n_pool
                                                   + n_fc - 1)
    assert got == want


def test_launch_counts_per_wrapper_and_per_entry_point(monkeypatch):
    """``_build.launch`` counts a launch under its wrapper's counter and
    under its C entry point, so the f32 and bf16 instances that share a
    counter are told apart; a failed launch counts nowhere, and
    ``reset_launches`` zeroes both tables."""
    from repro_torch.kernels import (ENTRY_LAUNCHES, LAUNCHES, _build,
                                     reset_launches)

    class Lib:
        def __init__(self, rc):
            self.rc = rc

        def repro_set_device(self, index):
            return 0

        def repro_cuda_error_string(self, rc):
            return b"stub"

        def __getattr__(self, entry):
            return lambda *args: self.rc

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    dev = torch.device("cuda", 0)
    reset_launches()
    try:
        monkeypatch.setattr(_build, "library", lambda: Lib(0))
        _build.launch("conv2d_fwd", "repro_conv2d_fwd_bf16", dev)
        _build.launch("conv2d_fwd", "repro_conv2d_fwd_bf16", dev)
        _build.launch("conv2d_fwd", "repro_conv2d_fwd", dev)
        monkeypatch.setattr(_build, "library", lambda: Lib(1))
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _build.launch("vmm_fwd", "repro_vmm_fwd_bf16", dev)
        assert set(ENTRY_LAUNCHES) == set(_build.SIGNATURES)
        assert LAUNCHES["conv2d_fwd"] == 3 and LAUNCHES["vmm_fwd"] == 0
        assert {k: v for k, v in ENTRY_LAUNCHES.items() if v} == {
            "repro_conv2d_fwd_bf16": 2, "repro_conv2d_fwd": 1}
    finally:
        reset_launches()
    assert not any(LAUNCHES.values()) and not any(ENTRY_LAUNCHES.values())


def test_bf16_has_no_general_kernel_on_the_card(launches):
    from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                                   CONV_GENERAL, conv2d,
                                                   conv2d_bwd_fused,
                                                   conv2d_planned)
    from repro_torch.kernels.vmm.vmm import VMM_BWD_GENERAL, vmm_bwd_fused
    bf = torch.bfloat16
    x = torch.zeros(1, 8, 8, 4, dtype=bf)
    for call in (lambda: conv2d(x, torch.zeros(9, 9, 4, 4, dtype=bf)),
                 lambda: conv2d_planned(x, torch.zeros(3, 3, 4, 4, dtype=bf),
                                        plan=CONV_GENERAL),
                 lambda: conv2d_bwd_fused(
                     torch.zeros(1, 1, 8, 8, 4, dtype=bf),
                     torch.zeros(3, 3, 4, 4, dtype=bf),
                     plan=CONV_BWD_GENERAL),
                 lambda: vmm_bwd_fused(torch.zeros(1, 2, 8, dtype=bf),
                                       torch.zeros(8, 4, dtype=bf),
                                       plan=VMM_BWD_GENERAL)):
        with pytest.raises(ValueError, match="bf16 has no general kernel"):
            call()
    assert launches == []
    # the same calls in f32 launch the general kernels
    conv2d_planned(x.float(), torch.zeros(3, 3, 4, 4), plan=CONV_GENERAL)
    assert launches[-1][1] == "repro_conv2d_fwd"


def test_wrappers_without_a_bf16_instance_reject_bf16():
    """The int16 wrappers take no bf16; the gate (B11) has no int16
    instance (fxp16 has no vjp).  B11 and B12 have bf16 instances since
    the bf16 autograd paths (``tests/test_torch_vjp_bf16.py``)."""
    from repro_torch.kernels.conv2d.fxp import conv2d_fxp
    from repro_torch.kernels.pool.fxp import unpool_bwd_fxp
    from repro_torch.kernels.relu_mask.relu_mask import relu_bwd
    from repro_torch.kernels.vmm.fxp import vmm_fxp
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        relu_bwd(None, torch.zeros(4, 8, dtype=torch.int16), "deconvnet")
    with pytest.raises(TypeError):
        unpool_bwd_fxp(torch.zeros(1, 2, 2, 1, dtype=torch.uint8),
                       torch.zeros(1, 2, 2, 4, dtype=bf))
    with pytest.raises(TypeError):
        conv2d_fxp(torch.zeros(1, 4, 4, 3, dtype=bf),
                   torch.zeros(3, 3, 3, 4, dtype=bf))
    with pytest.raises(TypeError):
        vmm_fxp(torch.zeros(2, 4, dtype=bf), torch.zeros(4, 3, dtype=bf))
