"""The autograd paths of repro_torch against the JAX package (CPU).

* the gate (B11) and unpool (B12) kernels' wrappers — their plain versions
  on the CPU — against ``relu_bwd_pallas`` / ``unpool_bwd_pallas`` /
  ``unpool_bwd_fxp`` in interpret mode, BITWISE, with ragged C;
* ``dx`` and ``dw`` of the standalone ops (``kernels/*/ops.py``) against
  ``jax.vjp`` of ``repro.kernels.*.ops``, within 1e-5 * max|ref| (f32 sums
  taken in another order; the gates and routes themselves are exact);
* ``cnn.apply``: logits, and the gradients of a cross-entropy loss with
  respect to the input and every parameter, for each branch (fused blocks,
  standalone kernel ops, reference ops) and rule set, against
  ``jax.grad`` of ``repro.models.cnn.apply``: logits within 1e-5 * max,
  gradients within 1e-4 * max per tensor (four layers of reordered sums);
* exact ties (x = 0 pre-activations, all-zero pool windows), where the
  autodiff derivatives of the two packages' ops must agree: 0.5 for
  ``maximum``, 0 for ``relu``, an even split for the window max, first-max
  routing for the pool kernel.

Inputs are built with NumPy from a seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import ops as jconv_ops
from repro.kernels.pool import ops as jpool_ops
from repro.kernels.pool.fxp import unpool_bwd_fxp as junpool_bwd_fxp
from repro.kernels.pool.pool import maxpool_fwd_pallas, unpool_bwd_pallas
from repro.kernels.relu_mask import ops as jrelu_ops
from repro.kernels.relu_mask.relu_mask import relu_bwd_pallas, relu_fwd_pallas
from repro.kernels.vmm import ops as jvmm_ops
from repro.models import cnn as jcnn
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.pool import ops as pool_ops
from repro_torch.kernels.pool.fxp import unpool_bwd_fxp
from repro_torch.kernels.pool.pool import unpool_bwd
from repro_torch.kernels.relu_mask import ops as relu_ops
from repro_torch.kernels.relu_mask.relu_mask import relu_bwd
from repro_torch.kernels.vmm import ops as vmm_ops
from repro_torch.models import cnn

METHODS = ("saliency", "deconvnet", "guided")
ALL_METHODS = ("autodiff",) + METHODS
OPS_TOL = 1e-5          # reordered f32 sums in one op
GRAD_TOL = 1e-4         # ... through four layers
KW = dict(in_hw=(16, 16), channels=(8, 8), fc=(32,))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _grad(rs, *shape):
    g = rs.randn(*shape).astype(np.float32)
    g.reshape(-1)[::7] = 0.0              # g > 0 is strict
    return g


# -- B11 / B12 plain versions against the Pallas kernels, bitwise ------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (64, 32), (3, 128)])
def test_relu_bwd_bitwise_vs_pallas(method, r, c):
    rs = np.random.RandomState(r * c)
    x = rs.randn(r, c).astype(np.float32)
    x[0] = 0.0
    g = _grad(rs, r, c)
    _, m = relu_fwd_pallas(jnp.asarray(x))
    want = np.asarray(relu_bwd_pallas(m, jnp.asarray(g), method))
    got = relu_bwd(_t(m), torch.from_numpy(g), method)
    np.testing.assert_array_equal(got.numpy(), want)
    if method == "deconvnet":             # reads no mask: none needed
        got = relu_bwd(None, torch.from_numpy(g), method)
        np.testing.assert_array_equal(got.numpy(), want)


def test_relu_bwd_needs_the_mask_except_for_deconvnet():
    g = torch.zeros(4, 9)
    for method in ("saliency", "guided"):
        with pytest.raises(ValueError, match="mask"):
            relu_bwd(None, g, method)
    with pytest.raises(ValueError):
        relu_bwd(torch.zeros(4, 1, dtype=torch.uint8), g, "saliency")
    with pytest.raises(ValueError, match="method"):
        relu_bwd(None, g, "autodiff")


def _pool_case(n, h, w, c, seed):
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(n, h, w, c), 0).astype(np.float32)
    x[:, :2, :2, :] = 0.0                 # an all-zero window
    x[:, 2:4, 2:4, :] = 1.5               # an all-equal non-zero window
    _, idx = maxpool_fwd_pallas(jnp.asarray(x))
    return idx, _grad(rs, n, h // 2, w // 2, c)


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 8, 13),
                                     (2, 8, 6, 32), (1, 4, 4, 64)])
def test_unpool_bwd_bitwise_vs_pallas(n, h, w, c):
    idx, g = _pool_case(n, h, w, c, seed=n * h * w + c)
    want = np.asarray(unpool_bwd_pallas(idx, jnp.asarray(g)))
    got = unpool_bwd(_t(idx), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [5, 16])
def test_unpool_bwd_fxp_bitwise_vs_pallas(c):
    idx, g = _pool_case(2, 8, 4, c, seed=c)
    gq = np.round(g * 256).astype(np.int16)
    want = np.asarray(junpool_bwd_fxp(idx, jnp.asarray(gq)))
    got = unpool_bwd_fxp(_t(idx), torch.from_numpy(gq))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        unpool_bwd_fxp(_t(idx), torch.from_numpy(g))


# -- the standalone ops against jax.vjp of repro.kernels.*.ops ---------------


def _vjp_both(jfn, tfn, xs, g):
    """Outputs and input cotangents of ``jfn``/``tfn`` at ``xs`` for ``g``."""
    jy, jback = jax.vjp(jfn, *map(jnp.asarray, xs))
    tx = [torch.from_numpy(a).requires_grad_() for a in xs]
    ty = tfn(*tx)
    tgrads = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    return (jy, jback(jnp.asarray(g))), (ty, tgrads)


@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("shape", [(2, 4, 4, 13), (5, 32)])
def test_relu_op_vjp_vs_jax(method, shape):
    rs = np.random.RandomState(len(shape))
    x = rs.randn(*shape).astype(np.float32)
    x.reshape(-1)[::5] = 0.0              # ties at 0
    g = _grad(rs, *shape)
    (jy, (jdx,)), (ty, (tdx,)) = _vjp_both(
        lambda v: jrelu_ops.relu(v, method),
        lambda v: relu_ops.relu(v, method), [x], g)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("method", ALL_METHODS)
def test_maxpool_op_vjp_vs_jax(method):
    rs = np.random.RandomState(11)
    x = np.maximum(rs.randn(2, 8, 6, 13), 0).astype(np.float32)
    x[:, :2, :2] = 0.0
    g = _grad(rs, 2, 4, 3, 13)
    (jy, (jdx,)), (ty, (tdx,)) = _vjp_both(
        lambda v: jpool_ops.maxpool2x2(v, method),
        lambda v: pool_ops.maxpool2x2(v, method), [x], g)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 8, 8, 3, 8), (1, 6, 10, 5, 3)])
def test_conv2d_op_vjp_vs_jax(n, h, w, cin, cout):
    rs = np.random.RandomState(cin)
    x = rs.randn(n, h, w, cin).astype(np.float32)
    wt = (rs.randn(3, 3, cin, cout) * 0.3).astype(np.float32)
    g = rs.randn(n, h, w, cout).astype(np.float32)
    (jy, (jdx, jdw)), (ty, (tdx, tdw)) = _vjp_both(
        jconv_ops.conv2d, conv_ops.conv2d, [x, wt], g)
    _close(ty, jy, OPS_TOL)
    _close(tdx, jdx, OPS_TOL)
    _close(tdw, jdw, OPS_TOL)


@pytest.mark.parametrize("m,k,n", [(4, 37, 13), (3, 512, 32)])
def test_vmm_op_vjp_vs_jax(m, k, n):
    rs = np.random.RandomState(k)
    x = rs.randn(m, k).astype(np.float32)
    wt = (rs.randn(k, n) * k ** -0.5).astype(np.float32)
    g = rs.randn(m, n).astype(np.float32)
    (jy, (jdx, jdw)), (ty, (tdx, tdw)) = _vjp_both(
        jvmm_ops.vmm, vmm_ops.vmm, [x, wt], g)
    _close(ty, jy, OPS_TOL)
    _close(tdx, jdx, OPS_TOL)
    _close(tdw, jdw, OPS_TOL)


def test_ops_save_x_only_when_w_needs_a_gradient():
    """On the attribution path (parameters closed over) the graph keeps
    the weight and no activation."""
    x = torch.randn(2, 4, 4, 3, requires_grad=True)
    for op, w in ((conv_ops.conv2d, torch.randn(3, 3, 3, 5)),
                  (vmm_ops.vmm, torch.randn(48, 5))):
        v = x if w.dim() == 4 else x.reshape(2, -1)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            op(v, w)
            op(v, w.clone().requires_grad_())
        assert [tuple(t.shape) for t in saved] == [
            tuple(w.shape), tuple(v.shape), tuple(w.shape)]


# -- cnn.apply, every branch, against jax.grad of repro.models.cnn.apply ------


def _setup(seed=0, **kw):
    kw = dict(KW, **kw)
    jcfg, cfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
    jparams = jcnn.init(jax.random.PRNGKey(seed), jcfg)
    params = cnn.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _both_grads(jcfg, cfg, jparams, params, x, y, **apply_kw):
    """Logits and the CE-loss gradients w.r.t. (params, x) in each package."""
    def jloss(p, v):
        logits = jcnn.apply(p, v, jcfg, **apply_kw)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(lp[jnp.arange(len(y)), y]), logits

    (_, jlogits), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    p = {k: [{n: t.clone().requires_grad_() for n, t in q.items()}
             for q in v] for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    logits = cnn.apply(p, tx, cfg, **apply_kw)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    leaves = [t for k in ("conv", "fc") for q in p[k] for t in q.values()]
    grads = torch.autograd.grad(loss, leaves + [tx])
    jleaves = [jgp[k][i][n] for k in ("conv", "fc")
               for i in range(len(jgp[k])) for n in ("w", "b")]
    return (jlogits, jleaves + [jgx]), (logits, list(grads))


def _check_apply(jcfg, cfg, jparams, params, x, y, **apply_kw):
    (jl, jg), (tl, tg) = _both_grads(jcfg, cfg, jparams, params, x, y,
                                     **apply_kw)
    _close(tl, jl, OPS_TOL)
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        if np.abs(np.asarray(j)).max() == 0:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j, GRAD_TOL)


@pytest.fixture(scope="module")
def small():
    jcfg, cfg, jparams, params = _setup()
    rs = np.random.RandomState(5)
    x = rs.randn(4, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, size=4)
    return jcfg, cfg, jparams, params, x, y


@pytest.mark.parametrize("method", ALL_METHODS)
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_apply_logits_and_grads_vs_jax(small, use_pallas, fused, method):
    _check_apply(*small, method=method, use_pallas=use_pallas, fused=fused)


@pytest.mark.parametrize("conv_relu", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_apply_autodiff_ties_match_jax(use_pallas, conv_relu):
    """Exact ties: a zero input block with zero biases gives pre-activations
    of exactly 0 and all-zero pool windows.  ``clamp_min`` (gradient 1 at 0)
    in place of ``maximum`` (0.5), or ``torch.max(dim)`` (one winner) in
    place of ``amax`` (an even split), changes these gradients."""
    jcfg, cfg, jparams, params = _setup(conv_relu=conv_relu)
    rs = np.random.RandomState(9)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    x[:, :8, :8] = 0.0
    y = np.array([1, 7])
    _check_apply(jcfg, cfg, jparams, params, x, y, use_pallas=use_pallas)
