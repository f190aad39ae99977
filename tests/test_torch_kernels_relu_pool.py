"""ReLU+mask and max-pool+argmax of repro_torch against the Pallas kernels.

On the CPU the wrappers run their plain versions; the JAX side runs
``relu_fwd_pallas`` / ``maxpool_fwd_pallas`` in interpret mode.  Both must
agree BITWISE: values, mask bytes and crumb bytes, with ragged channel
counts and with tied (all-zero, post-ReLU) pool windows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pool import ref as jpool_ref
from repro.kernels.pool.pool import maxpool_fwd_pallas
from repro.kernels.relu_mask import ref as jrelu_ref
from repro.kernels.relu_mask.relu_mask import relu_fwd_pallas
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.pool.pool import maxpool_fwd
from repro_torch.kernels.relu_mask import ref as relu_ref
from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                     relu_fwd, unpack_bits)

METHODS = ("saliency", "deconvnet", "guided")


@pytest.mark.parametrize("r,c", [(5, 3), (16, 13), (64, 32), (3, 128)])
def test_relu_fwd_bitwise_vs_pallas(r, c):
    x = np.random.RandomState(r * c).randn(r, c).astype(np.float32)
    x[0, :] = 0.0                        # x > 0 is strict: zeros give bit 0
    yj, mj = relu_fwd_pallas(jnp.asarray(x))
    yt, mt = relu_fwd(torch.from_numpy(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert mt.dtype == torch.uint8 and tuple(mt.shape) == mj.shape
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _pool_input(n, h, w, c, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, c).astype(np.float32)
    x = np.maximum(x, 0)                 # post-ReLU: many tied zero windows
    x[:, :2, :2, :] = 0.0                # at least one all-zero window
    x[:, 2:4, 2:4, :] = 1.5              # and one all-equal non-zero window
    return x


@pytest.mark.parametrize("n,h,w,c", [(2, 4, 4, 3), (1, 8, 8, 13),
                                     (2, 8, 6, 32), (1, 16, 16, 64)])
def test_maxpool_fwd_bitwise_vs_pallas(n, h, w, c):
    x = _pool_input(n, h, w, c, seed=n * h * w * c)
    yj, ij = maxpool_fwd_pallas(jnp.asarray(x))
    yt, it = maxpool_fwd(torch.from_numpy(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert it.dtype == torch.uint8 and tuple(it.shape) == ij.shape
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # ties go to candidate (0,0): the all-zero window's crumbs are all 0
    assert not it[:, 0, 0].any()


def test_maxpool_fwd_matches_reference_oracle_on_ties():
    x = np.zeros((1, 2, 2, 4), np.float32)
    x[0, 1, 0, 1] = 2.0                  # channel 1: max at (1,0) -> crumb 2
    x[0, 0, 1, 2] = x[0, 1, 1, 2] = 3.0  # channel 2: tie (0,1)/(1,1) -> 1
    yj, ij = jpool_ref.maxpool_fwd(jnp.asarray(x))
    yt, it = maxpool_fwd(torch.from_numpy(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it.item() == (2 << 2) | (1 << 4)


@pytest.mark.parametrize("c", [3, 13, 32])
def test_unpool_bwd_matches_reference(c):
    rs = np.random.RandomState(c)
    x = _pool_input(2, 8, 8, c, seed=c)
    _, idx = jpool_ref.maxpool_fwd(jnp.asarray(x))
    g = rs.randn(2, 4, 4, c).astype(np.float32)
    want = jpool_ref.unpool_bwd(idx, jnp.asarray(g))
    got = pool_ref.unpool_bwd(torch.tensor(np.asarray(idx)),
                              torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("c", [5, 16])
def test_gating_bitwise_vs_reference(method, c):
    rs = np.random.RandomState(7 + c)
    x = rs.randn(6, c).astype(np.float32)
    g = rs.randn(6, c).astype(np.float32)
    _, m = jrelu_ref.relu_fwd(jnp.asarray(x))
    want = np.asarray(jrelu_ref.relu_bwd(m, jnp.asarray(g), method))
    mt, gt = torch.tensor(np.asarray(m)), torch.from_numpy(g)
    np.testing.assert_array_equal(relu_ref.relu_bwd(mt, gt, method).numpy(),
                                  want)
    bits = unpack_bits(mt)[:, :c]
    np.testing.assert_array_equal(gate_gradient(gt, bits, method).numpy(),
                                  want)


def test_relu_fwd_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        relu_fwd(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        relu_fwd(torch.zeros(4, 8, 2))
    with pytest.raises(ValueError):
        maxpool_fwd(torch.zeros(1, 3, 4, 2))          # odd H
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        relu_fwd(torch.zeros(4, 8, device="meta"))    # neither CPU nor CUDA
