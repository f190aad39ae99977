"""The int16 kernels of repro_torch (fxp16 path) against the JAX package's
fxp Pallas kernels, in interpret mode on the CPU, bit for bit.

On the CPU every wrapper runs its plain version: int16 ReLU+mask and pool,
and the int32-accumulating conv and matmul computed exactly in float64 and
reduced modulo 2^32.  Integer arithmetic leaves no tolerance to state:
values, mask bytes and crumb bytes must be equal.  Cases cover Cin = 3 and
Cout' = 3, K = 3 and 5, S = 1 and 3, all three methods with and without
pool and the epilogue gate, tied int16 pool windows, and accumulators that
wrap past the int32 range at ±32767 operands.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfxp
from repro.kernels.conv2d import ref as jconv_ref
from repro.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp_pallas,
                                      conv2d_fxp_pallas)
from repro.kernels.pool.fxp import maxpool_fwd_fxp as jmaxpool_fwd_fxp
from repro.kernels.relu_mask.relu_mask import relu_fwd_pallas
from repro.kernels.vmm.fxp import vmm_bwd_fused_fxp_pallas, vmm_fxp_pallas
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.fxp import conv2d_bwd_fused_fxp, conv2d_fxp
from repro_torch.kernels.pool.fxp import maxpool_fwd_fxp
from repro_torch.kernels.relu_mask.relu_mask import relu_fwd
from repro_torch.kernels.vmm.fxp import vmm_bwd_fused_fxp, vmm_fxp

METHODS = ("saliency", "deconvnet", "guided")
LIM = jfxp.INT16_LIM


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _qact(rs, *shape, scale=1.0):
    """Q7.8 int16 activations or gradients drawn with NumPy (writable)."""
    return np.array(jfxp.to_fixed(jnp.asarray(
        (rs.randn(*shape) * scale).astype(np.float32))))


def _qwgt(rs, *shape, scale=0.2):
    """Q1.14 int16 weights drawn with NumPy."""
    return np.asarray(jfxp.to_fixed(jnp.asarray(
        (rs.randn(*shape) * scale).astype(np.float32)), jfxp.WGT_FRAC))


def _rails(rs, *shape):
    """±32767 operands: products near 2^30, sums far past 2^31."""
    return (rs.choice([-1, 1], size=shape) * LIM).astype(np.int16)


# -- int16 B2 / B3 -------------------------------------------------------------


@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (64, 32), (3, 128)])
def test_relu_fwd_int16_bitwise_vs_pallas(r, c):
    x = _qact(np.random.RandomState(r * c), r, c, scale=0.02)
    x[0, :] = 0                          # x > 0 is strict: zeros give bit 0
    x[1, :2] = (LIM, -LIM)
    yj, mj = relu_fwd_pallas(jnp.asarray(x))
    yt, mt = relu_fwd(torch.from_numpy(x))
    _eq(yt, yj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 8, 13),
                                     (2, 8, 6, 32), (1, 16, 16, 64)])
def test_maxpool_fwd_fxp_bitwise_vs_pallas(n, h, w, c):
    rs = np.random.RandomState(n * h * w * c)
    # post-ReLU on a coarse int16 grid: ties in most windows
    x = np.maximum(rs.randint(-3, 4, size=(n, h, w, c)), 0).astype(np.int16)
    x[:, :2, :2, :] = 0                  # an all-zero window
    x[:, 2:4, 2:4, :] = LIM              # an all-equal window at the rail
    yj, ij = jmaxpool_fwd_fxp(jnp.asarray(x))
    yt, it = maxpool_fwd_fxp(torch.from_numpy(x))
    _eq(yt, yj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not it[:, 0, 0].any()         # ties go to candidate (0,0)


# -- B7 conv forward -------------------------------------------------------------


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 8, 8, 3, 32, 3),          # layer 0: Cin = 3
    (1, 16, 16, 32, 64, 3),       # Table III conv2 width
    (2, 6, 10, 5, 3, 3),          # ragged both ways, Cout = 3
    (1, 8, 8, 16, 8, 5),          # K = 5 halo
])
def test_conv2d_fxp_vs_pallas(n, h, w, cin, cout, k):
    rs = np.random.RandomState(n * h + cin)
    x = _qact(rs, n, h, w, cin)
    wt = _qwgt(rs, k, k, cin, cout)
    b = _qact(rs, cout, scale=4.0)
    want = conv2d_fxp_pallas(jnp.asarray(x), jnp.asarray(wt))
    _eq(conv2d_fxp(_t(x), _t(wt)), want)
    _eq(conv2d_fxp(_t(x), _t(wt), _t(b)), jfxp.sat_add(want, jnp.asarray(b)))
    np.testing.assert_array_equal(
        conv_ref.conv2d_fxp(_t(x), _t(wt)).numpy(),
        jconv_ref.conv2d_fxp_np(x, wt))


@pytest.mark.parametrize("same_sign", [True, False])
def test_conv2d_fxp_accumulator_wraps_as_reference(same_sign):
    """9 * 128 products of ±32767^2 pass 2^31: the int32 accumulator wraps
    and the plain version must wrap with it."""
    rs = np.random.RandomState(4)
    if same_sign:
        x = np.full((1, 4, 4, 128), LIM, np.int16)
        wt = np.full((3, 3, 128, 8), LIM, np.int16)
    else:
        x, wt = _rails(rs, 1, 4, 4, 128), _rails(rs, 3, 3, 128, 8)
    want = conv2d_fxp_pallas(jnp.asarray(x), jnp.asarray(wt))
    _eq(conv2d_fxp(_t(x), _t(wt)), want)
    if same_sign:    # the wrapped centre pixels are not all at the rail
        assert len(np.unique(np.asarray(want))) > 1


# -- B8 fused conv backward -------------------------------------------------------

# (n, h, w, c, cout', k, pool, seeds): c is the forward Cout (contraction)
BWD_CASES = [
    (2, 8, 8, 32, 3, 3, True, 3),     # layer 0 backward: Cout' = 3, S = 3
    (1, 8, 8, 13, 9, 3, False, 1),    # ragged, unpooled, S = 1
    (2, 8, 8, 16, 16, 3, True, 1),    # pooled, S = 1
    (1, 8, 8, 8, 4, 5, False, 3),     # K = 5
]


def _bwd_inputs(case, method, seed):
    n, h, w, c, cout, k, pool, s = case
    rs = np.random.RandomState(seed)
    y = _qact(rs, n, h, w, c)                      # the layer's pre-ReLU
    y[:, :2, :2, :] = -256                         # a tied all-zero window
    wt = _qwgt(rs, k, k, c, cout)
    mask4 = None
    if method != "deconvnet":
        _, m = relu_fwd_pallas(jnp.asarray(y).reshape(-1, c))
        mask4 = np.asarray(m).reshape(n, h, w, -1)
    idx, hg, wg = None, h, w
    if pool:
        _, idx = jmaxpool_fwd_fxp(jnp.maximum(jnp.asarray(y), 0))
        idx, hg, wg = np.asarray(idx), h // 2, w // 2
    g = _qact(rs, s, n, hg, wg, c, scale=2.0)
    return g, wt, mask4, idx


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_fxp_vs_pallas(case, method):
    g, wt, mask4, idx = _bwd_inputs(case, method, seed=11)
    want = conv2d_bwd_fused_fxp_pallas(
        jnp.asarray(g), jnp.asarray(wt), pool_idx=_j(idx),
        relu_mask=_j(mask4), gate=True, method=method)
    got = conv2d_bwd_fused_fxp(_t(g), _t(wt), pool_idx=_t(idx),
                               relu_mask=_t(mask4), gate=True, method=method)
    _eq(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_fxp_epilogue_gate_vs_pallas(method):
    """The epilogue gate runs after the requantize (fxp.py:119-125)."""
    case = (2, 8, 8, 16, 13, 3, True, 3)
    g, wt, mask4, idx = _bwd_inputs(case, method, seed=5)
    prev = _qact(np.random.RandomState(6), 2, 8, 8, 13)
    omask = None
    if method != "deconvnet":
        _, om = relu_fwd_pallas(jnp.asarray(prev).reshape(-1, 13))
        omask = np.asarray(om).reshape(2, 8, 8, -1)
    kw = dict(pool_idx=idx, relu_mask=mask4, gate=True, method=method,
              out_relu_mask=omask, out_gate=True)
    want = conv2d_bwd_fused_fxp_pallas(
        jnp.asarray(g), jnp.asarray(wt),
        **{k: (_j(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    got = conv2d_bwd_fused_fxp(
        _t(g), _t(wt), **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                          for k, v in kw.items()})
    _eq(got, want)


def test_conv2d_bwd_fused_fxp_wraps_unseeded_ungated():
    rs = np.random.RandomState(9)
    g, wt = _rails(rs, 1, 4, 4, 64), _rails(rs, 3, 3, 64, 8)
    _eq(conv2d_bwd_fused_fxp(_t(g), _t(wt)),
        conv2d_bwd_fused_fxp_pallas(jnp.asarray(g), jnp.asarray(wt)))


# -- B9 / B10 FC ---------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (3, 100, 17), (4, 4096, 128),
                                   (2, 128, 10)])
def test_vmm_fxp_vs_pallas(m, k, n):
    rs = np.random.RandomState(m * k + n)
    x = _qact(rs, m, k)
    w = _qwgt(rs, k, n, scale=k ** -0.5)
    b = _qact(rs, n, scale=4.0)
    want = vmm_fxp_pallas(jnp.asarray(x), jnp.asarray(w))
    _eq(vmm_fxp(_t(x), _t(w)), want)
    _eq(vmm_fxp(_t(x), _t(w), _t(b)), jfxp.sat_add(want, jnp.asarray(b)))


def test_vmm_fxp_accumulator_wraps_as_reference():
    rs = np.random.RandomState(8)
    x, w = _rails(rs, 3, 4096), _rails(rs, 4096, 16)
    x[0] = LIM
    w[:, 0] = LIM                       # row 0, col 0: 4096 * 2^30 wraps
    _eq(vmm_fxp(_t(x), _t(w)), vmm_fxp_pallas(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,m,k,n,epilogue", [(1, 3, 17, 64, False),
                                              (3, 4, 128, 300, True)])
def test_vmm_bwd_fused_fxp_vs_pallas(method, s, m, k, n, epilogue):
    """k is the gradient width (gated by ``relu_mask``), n the output width
    (gated after the requantize by ``out_relu_mask``, fxp.py:106-112)."""
    rs = np.random.RandomState(s * k + n)
    g = _qact(rs, s, m, k, scale=3.0)
    wt = _qwgt(rs, k, n, scale=k ** -0.5)
    mask = omask = None
    if method != "deconvnet":
        _, mask = relu_fwd_pallas(jnp.asarray(rs.randn(m, k), jnp.float32))
        if epilogue:
            _, omask = relu_fwd_pallas(
                jnp.asarray(rs.randn(m, n), jnp.float32))
    kw = dict(gate=True, method=method, out_gate=epilogue)
    want = vmm_bwd_fused_fxp_pallas(jnp.asarray(g), jnp.asarray(wt),
                                    relu_mask=mask, out_relu_mask=omask, **kw)
    got = vmm_bwd_fused_fxp(_t(g), _t(wt), relu_mask=_t(mask),
                            out_relu_mask=_t(omask), **kw)
    _eq(got, want)


def test_fxp_wrappers_reject_float_operands():
    x16 = torch.zeros(1, 4, 4, 3, dtype=torch.int16)
    with pytest.raises(TypeError):
        conv2d_fxp(x16, torch.zeros(3, 3, 3, 4))             # f32 kernel
    with pytest.raises(TypeError):
        conv2d_fxp(x16.float(), torch.zeros(3, 3, 3, 4, dtype=torch.int16))
    with pytest.raises(TypeError):
        vmm_fxp(torch.zeros(2, 4, dtype=torch.int16), torch.zeros(4, 3))
    with pytest.raises(TypeError):
        vmm_bwd_fused_fxp(torch.zeros(1, 2, 4), torch.zeros(
            4, 3, dtype=torch.int16))
    with pytest.raises(TypeError):
        maxpool_fwd_fxp(torch.zeros(1, 4, 4, 2))
    with pytest.raises(TypeError):
        relu_fwd(torch.zeros(4, 8, dtype=torch.int32))
