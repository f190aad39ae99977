"""Conv forward and fused conv backward of repro_torch against the Pallas
kernels (interpret mode on the CPU).

Dots agree within 1e-5 * max|ref| (f32 sums taken in another order); the
gating itself is exact, so a gated-off position is 0 on both sides.  Cases
cover all three methods, pooled and unpooled, the epilogue gate, S=1 and
S=3, Cout' < 8 and Cin = 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import ref as jconv_ref
from repro.kernels.conv2d.conv2d import conv2d_bwd_fused_pallas, conv2d_pallas
from repro.kernels.pool.pool import maxpool_fwd_pallas
from repro.kernels.relu_mask.relu_mask import relu_fwd_pallas
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import conv2d, conv2d_bwd_fused

METHODS = ("saliency", "deconvnet", "guided")
TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.tensor(np.asarray(a))


def _mask4(y):
    n, h, w, c = y.shape
    _, m = relu_fwd_pallas(jnp.asarray(y).reshape(-1, c))
    return np.asarray(m).reshape(n, h, w, -1)


@pytest.mark.parametrize("n,h,w,cin,cout,k", [
    (2, 8, 8, 3, 32, 3),          # layer 0: Cin = 3
    (1, 16, 16, 32, 64, 3),       # Table III conv2 width
    (2, 6, 10, 5, 3, 3),          # ragged both ways, Cout < 8
    (1, 8, 8, 16, 8, 5),          # K = 5 halo
])
def test_conv2d_vs_pallas(n, h, w, cin, cout, k):
    rs = np.random.RandomState(n * h + cin)
    x = rs.randn(n, h, w, cin).astype(np.float32)
    wt = (rs.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    want = conv2d_pallas(jnp.asarray(x), jnp.asarray(wt)) + b
    _close(conv2d(_t(x), _t(wt), _t(b)), want)
    _close(conv_ref.conv2d(_t(x), _t(wt)), jconv_ref.conv2d(x, wt))


def test_flip_transpose_and_input_grad_match_reference():
    rs = np.random.RandomState(3)
    w = rs.randn(3, 3, 4, 6).astype(np.float32)
    g = rs.randn(2, 5, 5, 6).astype(np.float32)
    np.testing.assert_array_equal(conv_ref.flip_transpose(_t(w)).numpy(),
                                  np.asarray(jconv_ref.flip_transpose(w)))
    _close(conv_ref.conv2d_input_grad(_t(g), _t(w)),
           jconv_ref.conv2d_input_grad(jnp.asarray(g), jnp.asarray(w)))


# (n, h, w, c, cout', pool, seeds): c is the forward Cout (contraction here)
BWD_CASES = [
    (2, 8, 8, 32, 3, True, 3),        # layer 0 backward: Cout' = 3 < 8
    (1, 8, 8, 13, 9, False, 1),       # ragged, unpooled, S = 1
    (2, 8, 8, 16, 16, True, 1),       # pooled, S = 1
]


def _bwd_inputs(case, method, seed):
    n, h, w, c, cout, pool, s = case
    rs = np.random.RandomState(seed)
    y = rs.randn(n, h, w, c).astype(np.float32)   # the layer's pre-ReLU
    y[:, :2, :2, :] = -1.0                          # a tied all-zero window
    wt = (rs.randn(3, 3, c, cout) * 0.2).astype(np.float32)
    mask4 = None if method == "deconvnet" else _mask4(y)
    idx = None
    hg, wg = h, w
    if pool:
        _, idx = maxpool_fwd_pallas(jnp.maximum(jnp.asarray(y), 0))
        idx = np.asarray(idx)
        hg, wg = h // 2, w // 2
    g = rs.randn(s, n, hg, wg, c).astype(np.float32)
    return g, wt, mask4, idx


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_vs_pallas(case, method):
    g, wt, mask4, idx = _bwd_inputs(case, method, seed=11)
    want = conv2d_bwd_fused_pallas(
        jnp.asarray(g), jnp.asarray(wt), pool_idx=idx, relu_mask=mask4,
        gate=True, method=method)
    got = conv2d_bwd_fused(
        _t(g), _t(wt), pool_idx=None if idx is None else _t(idx),
        relu_mask=None if mask4 is None else _t(mask4), gate=True,
        method=method)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_conv2d_bwd_fused_epilogue_gate_vs_pallas(method):
    case = (2, 8, 8, 16, 13, True, 3)
    g, wt, mask4, idx = _bwd_inputs(case, method, seed=5)
    rs = np.random.RandomState(6)
    prev = rs.randn(2, 8, 8, 13).astype(np.float32)
    omask = None if method == "deconvnet" else _mask4(prev)
    want = conv2d_bwd_fused_pallas(
        jnp.asarray(g), jnp.asarray(wt), pool_idx=idx, relu_mask=mask4,
        gate=True, method=method, out_relu_mask=omask, out_gate=True)
    got = conv2d_bwd_fused(
        _t(g), _t(wt), pool_idx=_t(idx),
        relu_mask=None if mask4 is None else _t(mask4), gate=True,
        method=method, out_relu_mask=None if omask is None else _t(omask),
        out_gate=True)
    _close(got, want)
    # the epilogue gate is exact: gated-off outputs are 0 on both sides
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)


def test_conv2d_bwd_fused_unseeded_and_ungated():
    g, wt, _, _ = _bwd_inputs((1, 8, 8, 8, 4, False, 1), "saliency", seed=2)
    want = conv2d_bwd_fused_pallas(jnp.asarray(g[0]), jnp.asarray(wt))
    got = conv2d_bwd_fused(_t(g[0]), _t(wt))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_conv2d_wrappers_reject_bad_operands():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError):
        conv2d(x, torch.zeros(2, 2, 3, 4))             # even K
    with pytest.raises(ValueError):
        conv2d(x, torch.zeros(3, 3, 5, 4))             # Cin mismatch
    with pytest.raises(ValueError):                    # saliency needs mask
        conv2d_bwd_fused(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 3),
                         gate=True, method="saliency")
    with pytest.raises(ValueError):                    # wrong mask shape
        conv2d_bwd_fused(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 3),
                         relu_mask=torch.zeros(1, 4, 4, 2, dtype=torch.uint8))
