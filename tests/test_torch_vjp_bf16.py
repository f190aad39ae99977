"""bf16 under autograd in repro_torch against the JAX package (CPU): the
gate and unpool kernels, the standalone ops, the vjp engine and the
composite methods.

``cnn.apply(..., precision="bf16")`` casts the params and the input to
bf16, as ``repro/models/cnn.py`` does, and the cotangent flows in bf16
through each block's backward and back through the casts: logits bf16,
the relevance of an f32 input f32.  Inputs are built with NumPy from a
seed and fed to both packages; the JAX package's Pallas kernels run in
interpret mode, as its own tests run them.

* the gate (B11) and unpool (B12) wrappers on bf16 — their plain versions
  on the CPU — BITWISE against ``relu_bwd_pallas`` / ``unpool_bwd_pallas``
  on bf16 (C in {3, 13, 32, 64}, -0.0 and exact zeros in the gradient,
  every method): they select and route, never round;
* each standalone op's bf16 vjp against ``jax.vjp`` of
  ``repro.kernels.*.ops``: ReLU and pool bitwise, conv and FC within
  ``OP_TOL`` (one bf16 step of the largest value: an f32 sum taken in
  another order, then rounded once);
* the bf16 vjp engine on the fused blocks, on the reference ops and
  through an ``FnModel`` over the standalone ops (Argmax and TopK) against
  ``repro``'s engine of the same spec within ``TOL`` (2^-6 * max|ref|,
  ``tests/test_torch_cnn_bf16.py``'s bound; TopK for every method, Argmax
  for saliency), its dtypes (bf16 logits, f32 relevance), and against the
  port's own bf16 seed-batched pair;
* under ``saved_tensors_hooks``, a bf16 saliency vjp explain saves no
  float tensor besides the bf16 weights, and exactly the packed mask and
  crumb bytes of the bf16 ``forward_with_residuals``.

``cnn.apply``'s branches and gradients are in
``tests/test_torch_vjp_bf16_apply.py``, the composite methods, ``model_fn``
and ``composite_backward`` in ``tests/test_torch_vjp_bf16_composites.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.kernels.conv2d import ops as jconv_ops
from repro.kernels.pool import ops as jpool_ops
from repro.kernels.pool.pool import maxpool_fwd_pallas, unpool_bwd_pallas
from repro.kernels.relu_mask import ops as jrelu_ops
from repro.kernels.relu_mask.relu_mask import relu_bwd_pallas, relu_fwd_pallas
from repro.kernels.vmm import ops as jvmm_ops
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch.engine import CNNModel, EngineSpec, FnModel, TopK, build
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.pool import ops as pool_ops
from repro_torch.kernels.pool.pool import unpool_bwd
from repro_torch.kernels.relu_mask import ops as relu_ops
from repro_torch.kernels.relu_mask.relu_mask import relu_bwd
from repro_torch.kernels.vmm import ops as vmm_ops
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
KINDS = ("fused", "reference", "fn")
TOL = 2.0 ** -6          # four layers of one-step bf16 roundings
OP_TOL = 2.0 ** -7       # one bf16 rounding step of the largest value
KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CFG, JCFG = cnn.CNNConfig(**KW), jcnn.CNNConfig(**KW)
BF = jnp.bfloat16


def _bf16(a):
    """f32 NumPy -> bf16 NumPy (round to nearest even, as both packages)."""
    return np.asarray(a, np.float32).astype(BF)


def _t(a):
    """A NumPy or JAX array as a torch tensor, bf16 bit for bit."""
    a = np.asarray(a)
    if a.dtype == BF:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bitwise(got, want):
    want = np.asarray(want)
    assert got.dtype == _t(want).dtype and tuple(got.shape) == want.shape
    assert torch.equal(got.detach().view(torch.int16) if got.dtype ==
                       torch.bfloat16 else got.detach(),
                       _t(want).view(torch.int16) if want.dtype == BF
                       else _t(want))


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * ref, (what, err, ref)


def _grad(rs, *shape):
    """A bf16 gradient with exact zeros and -0.0 (``g > 0`` is strict)."""
    g = rs.randn(*shape).astype(np.float32)
    g.reshape(-1)[::7] = 0.0
    g.reshape(-1)[3::11] = -0.0
    return _bf16(g)


# -- B11 / B12 bf16 plain versions against the Pallas kernels, bitwise -------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (64, 32), (3, 64)])
def test_relu_bwd_bf16_bitwise_vs_pallas(method, r, c):
    rs = np.random.RandomState(r * c + 1)
    x = rs.randn(r, c).astype(np.float32)
    x[0] = 0.0
    x[1, ::2] = -0.0
    x = _bf16(x)
    g = _grad(rs, r, c)
    _, m = relu_fwd_pallas(jnp.asarray(x))
    want = relu_bwd_pallas(m, jnp.asarray(g), method)
    assert want.dtype == BF
    got = relu_bwd(_t(m), _t(g), method)
    assert got.dtype == torch.bfloat16
    _bitwise(got, want)
    if method == "deconvnet":             # reads no mask: none needed
        _bitwise(relu_bwd(None, _t(g), method), want)


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 8, 13),
                                     (2, 8, 6, 32), (1, 4, 4, 64)])
def test_unpool_bwd_bf16_bitwise_vs_pallas(n, h, w, c):
    rs = np.random.RandomState(n * h * w + c)
    x = np.maximum(rs.randn(n, h, w, c), 0).astype(np.float32)
    x[:, :2, :2, :] = 0.0                 # an all-zero window
    x[:, 2:4, 2:4, :] = 1.5               # an all-equal non-zero window
    _, idx = maxpool_fwd_pallas(jnp.asarray(_bf16(x)))
    g = _grad(rs, n, h // 2, w // 2, c)
    want = unpool_bwd_pallas(idx, jnp.asarray(g))
    assert want.dtype == BF
    _bitwise(unpool_bwd(_t(idx), _t(g)), want)


# -- the standalone ops' bf16 vjps against jax.vjp ---------------------------


def _vjp_both(jfn, tfn, xs, g):
    """Outputs and input cotangents of ``jfn``/``tfn`` at the bf16 ``xs``
    for the bf16 cotangent ``g``."""
    jy, jback = jax.vjp(jfn, *map(jnp.asarray, xs))
    tx = [_t(a).requires_grad_() for a in xs]
    ty = tfn(*tx)
    tgrads = torch.autograd.grad(ty, tx, _t(g))
    return (jy, jback(jnp.asarray(g))), (ty, tgrads)


@pytest.mark.parametrize("method", ("autodiff",) + METHODS)
def test_relu_and_pool_op_vjps_bitwise_vs_jax(method):
    """Bitwise; but autodiff's ReLU gradient is value for value only:
    ``jnp.maximum``'s derivative multiplies a negative gradient by 0, a
    -0.0 where ``torch.maximum``'s backward writes +0.0."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 6, 13).astype(np.float32)
    x.reshape(-1)[::5] = 0.0              # ties at 0
    x = _bf16(x)
    (jy, (jdx,)), (ty, (tdx,)) = _vjp_both(
        lambda v: jrelu_ops.relu(v, method),
        lambda v: relu_ops.relu(v, method), [x], _grad(rs, *x.shape))
    assert ty.dtype == tdx.dtype == torch.bfloat16
    _bitwise(ty, jy)
    if method == "autodiff":
        np.testing.assert_array_equal(_f32(tdx), _f32(jdx))
    else:
        _bitwise(tdx, jdx)
    xp = _bf16(np.maximum(_f32(x), 0))
    (jy, (jdx,)), (ty, (tdx,)) = _vjp_both(
        lambda v: jpool_ops.maxpool2x2(v, method),
        lambda v: pool_ops.maxpool2x2(v, method), [xp],
        _grad(rs, 2, 4, 3, 13))
    _bitwise(ty, jy)
    _bitwise(tdx, jdx)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 8, 8, 3, 8),
                                            (1, 6, 10, 16, 3)])
def test_conv2d_op_bf16_vjp_vs_jax(n, h, w, cin, cout):
    rs = np.random.RandomState(cin)
    x = _bf16(rs.randn(n, h, w, cin))
    wt = _bf16(rs.randn(3, 3, cin, cout) * 0.3)
    g = _bf16(rs.randn(n, h, w, cout))
    (jy, (jdx, jdw)), (ty, (tdx, tdw)) = _vjp_both(
        jconv_ops.conv2d, conv_ops.conv2d, [x, wt], g)
    for got, want, what in ((ty, jy, "y"), (tdx, jdx, "dx"),
                            (tdw, jdw, "dw")):
        assert got.dtype == torch.bfloat16 and want.dtype == BF
        _close(got, want, OP_TOL, what)


@pytest.mark.parametrize("m,k,n", [(4, 37, 13), (3, 512, 32)])
def test_vmm_op_bf16_vjp_vs_jax(m, k, n):
    rs = np.random.RandomState(k)
    x = _bf16(rs.randn(m, k))
    wt = _bf16(rs.randn(k, n) * k ** -0.5)
    g = _bf16(rs.randn(m, n))
    (jy, (jdx, jdw)), (ty, (tdx, tdw)) = _vjp_both(
        jvmm_ops.vmm, vmm_ops.vmm, [x, wt], g)
    for got, want, what in ((ty, jy, "y"), (tdx, jdx, "dx"),
                            (tdw, jdw, "dw")):
        assert got.dtype == torch.bfloat16 and want.dtype == BF
        _close(got, want, OP_TOL, what)


# -- the engine ----------------------------------------------------------------


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
                                       use_pallas=True, fused=False,
                                       precision="bf16")

        def jmake(m):
            return lambda v: jcnn.apply(jparams, v, JCFG, method=m,
                                        use_pallas=True, fused=False,
                                        precision="bf16")

        return FnModel(tmake, device="cpu"), jengine.FnModel(jmake)
    up = kind == "fused"
    return (CNNModel(params, CFG, use_pallas=up, device="cpu"),
            jengine.CNNModel(jparams, JCFG, use_pallas=up))


def _engines(setup, kind, **spec):
    jparams, params, _ = setup
    tm, jm = _models(kind, jparams, params)
    spec = dict(dict(precision="bf16", backward="vjp"), **spec)
    jspec = {k: (jengine.TopK(v.k) if isinstance(v, TopK) else v)
             for k, v in spec.items()}
    return build(EngineSpec(tm, **spec)), jengine.build(
        jengine.EngineSpec(jm, **jspec))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_vjp_explain_matches_jax_engine(setup, kind, method):
    x = setup[2]
    teng, jeng = _engines(setup, kind, method=method, targets=TopK(2))
    assert not teng.supports_replay and not jeng.supports_replay
    tl, trel = teng.explain(x)
    jl, jrel = jeng.explain(jnp.asarray(x))
    assert tl.dtype == torch.bfloat16 and jl.dtype == BF
    assert trel.dtype == torch.float32 and jrel.dtype == jnp.float32
    assert tuple(trel.shape) == jrel.shape == (2, 3, 8, 8, 3)
    _close(tl, jl, TOL, "logits")
    _close(trel, jrel, TOL, "top-2 relevance")
    if method != "saliency":              # Argmax once per kind
        return
    teng1, jeng1 = _engines(setup, kind, method=method)
    _, trel1 = teng1.explain(x)
    _, jrel1 = jeng1.explain(jnp.asarray(x))
    assert trel1.dtype == torch.float32 and jrel1.dtype == jnp.float32
    assert tuple(trel1.shape) == jrel1.shape == (3, 8, 8, 3)
    _close(trel1, jrel1, TOL, "argmax relevance")


@pytest.mark.parametrize("method", METHODS)
def test_bf16_vjp_on_the_fused_blocks_equals_the_bf16_pair(setup, method):
    """One S = 1 backward per seed sums each output in the order of the
    seed-batched launch: the same bits, widened."""
    _, params, x = setup
    model = CNNModel(params, CFG, device="cpu")
    pair = build(EngineSpec(model, method=method, precision="bf16",
                            targets=TopK(3)))
    vjp = build(EngineSpec(model, method=method, precision="bf16",
                           targets=TopK(3), backward="vjp"))
    pl, prel = pair.explain(x)
    vl, vrel = vjp.explain(x)
    assert prel.dtype == torch.bfloat16 and vrel.dtype == torch.float32
    assert torch.equal(pl, vl)
    assert torch.equal(prel.float(), vrel)
    # the two-phase form: the "residuals" are the input, replayed
    logits, rel, res = vjp.predict_then_explain(x)
    seeds, _ = vjp._seeds(logits, None, 3)
    assert seeds.dtype == torch.bfloat16
    assert torch.equal(vjp.replay(res, seeds), rel)
    assert torch.equal(vjp.predict(x), logits)


# -- the memory claim ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["fused", "fn"])
def test_bf16_vjp_explain_saves_only_packed_state(setup, kind):
    """Paper §V under bf16: the graph of a saliency explain holds the bf16
    weights and exactly the packed bytes ``forward_with_residuals``
    stores; the casts save nothing."""
    jparams, params, x = setup
    tm, _ = _models(kind, jparams, params)
    eng = build(EngineSpec(tm, method="saliency", precision="bf16",
                           backward="vjp"))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        eng.explain(x)
    floats = [t for t in saved if t.is_floating_point()]
    state = [t for t in saved if not t.is_floating_point()]
    weights = sorted(tuple(q["w"].shape) for q in params["conv"]
                     + params["fc"])
    assert all(t.dtype == torch.bfloat16 for t in floats)
    assert sorted(tuple(t.shape) for t in floats) == weights
    assert state and all(t.dtype == torch.uint8 for t in state)
    _, res = cnn.forward_with_residuals(params, torch.from_numpy(x), CFG,
                                        "saliency", "bf16")
    packed = [t for m, i in res["conv"] for t in (m, i) if t is not None]
    packed += [m for m in res["fc"] if m is not None]
    assert sum(t.numel() for t in state) == sum(t.numel() for t in packed)
