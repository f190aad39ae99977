"""repro_torch.core.masks and kernels.tiling against the JAX package.

Packed 1-bit masks and 2-bit crumbs must round-trip and match
``repro.core.masks`` byte for byte (LSB first, padding bits 0), including
channel counts that are not a multiple of 8 or 4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.kernels import tiling as jtiling
from repro_torch.core import masks as tmasks
from repro_torch.kernels import tiling as ttiling

CHANNELS = (1, 3, 5, 8, 12, 13, 64)


@pytest.mark.parametrize("c", CHANNELS)
def test_pack_mask_matches_reference_and_round_trips(c):
    bits = np.random.RandomState(c).rand(2, 3, c) > 0.5
    want = np.asarray(jmasks.pack_mask(jnp.asarray(bits)))
    got = tmasks.pack_mask(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmasks.unpack_mask(got, c).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jmasks.unpack_mask(jnp.asarray(got.numpy()), c)), bits)


@pytest.mark.parametrize("c", CHANNELS)
def test_pack_crumbs_matches_reference_and_round_trips(c):
    idx = np.random.RandomState(100 + c).randint(0, 4, size=(2, 3, c))
    want = np.asarray(jmasks.pack_crumbs(jnp.asarray(idx)))
    got = tmasks.pack_crumbs(torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tmasks.unpack_crumbs(got, c)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), idx)


def test_lsb_first_layout_and_zero_padding():
    bits = torch.zeros(10, dtype=torch.bool)
    bits[0] = bits[9] = True                 # channel 0 -> bit 0 of byte 0
    np.testing.assert_array_equal(tmasks.pack_mask(bits).numpy(), [1, 2])
    crumbs = torch.tensor([3, 0, 0, 0, 2], dtype=torch.int32)
    np.testing.assert_array_equal(tmasks.pack_crumbs(crumbs).numpy(), [3, 2])


@pytest.mark.parametrize("shape", [(7,), (2, 3, 5), (4, 32, 32, 32)])
def test_nbytes_match_reference(shape):
    assert tmasks.mask_nbytes(shape) == jmasks.mask_nbytes(shape)
    assert tmasks.crumb_nbytes(shape) == jmasks.crumb_nbytes(shape)


@pytest.mark.parametrize("c", CHANNELS)
def test_tiling_byte_counts_match_reference(c):
    assert ttiling.mask_bytes(c) == jtiling.mask_bytes(c)
    assert ttiling.crumb_bytes(c) == jtiling.crumb_bytes(c)
    assert ttiling.align_up(c, 8) == jtiling.align_up(c, 8)
    assert (ttiling.BITS_PER_BYTE, ttiling.CRUMBS_PER_BYTE) == (
        jtiling.BITS_PER_BYTE, jtiling.CRUMBS_PER_BYTE)
