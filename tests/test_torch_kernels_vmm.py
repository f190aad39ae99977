"""FC matmul forward and fused backward of repro_torch against the Pallas
kernels (interpret mode on the CPU).

Dots agree within 1e-5 * max|ref|; gating is exact.  Cases cover all three
methods, the epilogue gate, S=1 and S=3, and ragged K/N.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.relu_mask.relu_mask import relu_fwd_pallas
from repro.kernels.vmm import ref as jvmm_ref
from repro.kernels.vmm.vmm import vmm_bwd_fused_pallas, vmm_pallas
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm.vmm import vmm, vmm_bwd_fused

METHODS = ("saliency", "deconvnet", "guided")
TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("m,k,n", [(2, 4096, 128), (2, 128, 10),
                                   (5, 37, 13)])
def test_vmm_vs_pallas(m, k, n):
    rs = np.random.RandomState(m + k + n)
    x = rs.randn(m, k).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = rs.randn(n).astype(np.float32)
    _close(vmm(_t(x), _t(w), _t(b)),
           vmm_pallas(jnp.asarray(x), jnp.asarray(w)) + b)
    _close(vmm_ref.vmm(_t(x), _t(w)), jvmm_ref.vmm(x, w))
    g = rs.randn(m, n).astype(np.float32)
    _close(vmm_ref.vmm_input_grad(_t(g), _t(w)),
           jvmm_ref.vmm_input_grad(jnp.asarray(g), jnp.asarray(w)))


def _mask(rs, m, c):
    _, mk = relu_fwd_pallas(jnp.asarray(rs.randn(m, c).astype(np.float32)))
    return np.asarray(mk)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("s,m,k,n,epilogue", [
    (3, 2, 128, 256, False),      # FC0 backward at S = 3 (narrowed N)
    (1, 4, 13, 21, True),         # ragged K/N, epilogue gate, S = 1
    (3, 3, 10, 128, True),        # FC1-like K, epilogue, S = 3
])
def test_vmm_bwd_fused_vs_pallas(method, s, m, k, n, epilogue):
    rs = np.random.RandomState(s * 100 + k)
    g = rs.randn(s, m, k).astype(np.float32)
    w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)   # W^T view
    mask = None if method == "deconvnet" else _mask(rs, m, k)
    omask = None
    if epilogue and method != "deconvnet":
        omask = _mask(rs, m, n)
    want = vmm_bwd_fused_pallas(
        jnp.asarray(g), jnp.asarray(w), relu_mask=mask, gate=True,
        method=method, out_relu_mask=omask, out_gate=epilogue)
    got = vmm_bwd_fused(
        _t(g), _t(w), relu_mask=None if mask is None else _t(mask),
        gate=True, method=method,
        out_relu_mask=None if omask is None else _t(omask),
        out_gate=epilogue)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    if epilogue:
        np.testing.assert_array_equal(got.numpy() == 0,
                                      np.asarray(want) == 0)


def test_vmm_bwd_fused_unseeded_ungated():
    rs = np.random.RandomState(0)
    g = rs.randn(3, 10).astype(np.float32)
    w = rs.randn(10, 16).astype(np.float32)
    want = vmm_bwd_fused_pallas(jnp.asarray(g), jnp.asarray(w))
    got = vmm_bwd_fused(_t(g), _t(w))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_vmm_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        vmm(torch.zeros(2, 3), torch.zeros(4, 5))
    with pytest.raises(ValueError):
        vmm(torch.zeros(2, 3), torch.zeros(3, 5), torch.zeros(4))
    with pytest.raises(TypeError):
        vmm_bwd_fused(torch.zeros(1, 2, 8), torch.zeros(8, 4),
                      relu_mask=torch.zeros(2, 1))     # mask not uint8
    with pytest.raises(ValueError):
        vmm_bwd_fused(torch.zeros(1, 2, 8), torch.zeros(8, 4), gate=True,
                      method="guided")                 # guided needs a mask
