"""repro_torch.core.fixedpoint against repro.core.fixedpoint, bit for bit.

The int16 codec (half-way ties round to even, saturation at ±32767, never
-32768), the requantizer at the rails and where ``acc + 2^13`` wraps, the
saturating add and the params quantizer, on the same NumPy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixedpoint as jfxp
from repro_torch.core import fixedpoint as tfxp

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def test_constants_match_reference():
    for name in ("ACT_FRAC", "WGT_FRAC", "SEED_GAIN_BITS", "SEED_GAIN",
                 "INT16_LIM"):
        assert getattr(tfxp, name) == getattr(jfxp, name), name


def _codec_inputs(frac):
    rs = np.random.RandomState(frac)
    step = 2.0 ** -frac
    halves = (np.arange(-40, 40) + 0.5) * step       # exact half-way ties
    big = np.array([127.99, 128.0, 1e6, -1e6, -128.0, -127.998, 3.0, -3.0])
    return np.concatenate([halves, big, rs.randn(500) * 4,
                           rs.randn(100) * 300]).astype(np.float32)


@pytest.mark.parametrize("frac", [tfxp.ACT_FRAC, tfxp.WGT_FRAC])
def test_to_fixed_bitwise_with_ties_and_saturation(frac):
    x = _codec_inputs(frac)
    want = np.asarray(jfxp.to_fixed(jnp.asarray(x), frac))
    got = tfxp.to_fixed(torch.from_numpy(x), frac)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min().item() >= -tfxp.INT16_LIM           # never -32768


@pytest.mark.parametrize("frac", [tfxp.ACT_FRAC, tfxp.WGT_FRAC])
def test_from_fixed_bitwise(frac):
    q = np.random.RandomState(3).randint(-32767, 32768, 1000).astype(np.int16)
    want = np.asarray(jfxp.from_fixed(jnp.asarray(q), frac))
    got = tfxp.from_fixed(torch.from_numpy(q), frac)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _accumulators():
    rs = np.random.RandomState(7)
    rails = np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, 8191, 8192, -8192,
                      -8193, 32767 << 14, (32767 << 14) + 8191,
                      -(32767 << 14) - 8193, I32_MAX], np.int64)
    # acc + 2^13 passes 2^31 - 1 here and wraps to the negative rail
    wraps = I32_MAX - np.arange(0, 1 << 13, 97, dtype=np.int64)
    return np.concatenate([rails, wraps,
                           rs.randint(I32_MIN, I32_MAX, 2000,
                                      dtype=np.int64)])


def test_requantize_bitwise_at_rails_and_on_wrap():
    acc = _accumulators()
    want = np.asarray(jfxp.requantize(jnp.asarray(acc.astype(np.int32))))
    np.testing.assert_array_equal(
        want, jfxp.requantize_np(acc.astype(np.int32)))
    got = tfxp.requantize(torch.from_numpy(acc.astype(np.int32)))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapping rounding add sends the top of the range to the -rail
    assert (got.numpy()[-2000 - 85:-2000] == -tfxp.INT16_LIM).all()


def test_requantize_reduces_exact_sums_modulo_2_32():
    """An exact sum past the int32 range (held in int64 or float64, as the
    plain kernel versions hold it) requantizes as its int32 wrap does."""
    rs = np.random.RandomState(11)
    exact = rs.randint(-(2 ** 41), 2 ** 41, 3000, dtype=np.int64)
    want = np.asarray(jfxp.requantize(jnp.asarray(exact.astype(np.int32))))
    for t in (torch.from_numpy(exact), torch.from_numpy(exact).double()):
        np.testing.assert_array_equal(tfxp.requantize(t).numpy(), want)


def test_sat_add_bitwise():
    rs = np.random.RandomState(5)
    a = rs.randint(-32767, 32768, 4000).astype(np.int16)
    b = rs.randint(-32767, 32768, 4000).astype(np.int16)
    a[:4] = [32767, -32767, 32767, -32767]
    b[:4] = [32767, -32767, 1, -1]
    want = np.asarray(jfxp.sat_add(jnp.asarray(a), jnp.asarray(b)))
    got = tfxp.sat_add(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_params_int_bitwise():
    rs = np.random.RandomState(2)
    tree = {"conv": [{"w": rs.randn(3, 3, 3, 4) * 0.5, "b": rs.randn(4)}],
            "fc": [{"w": rs.randn(16, 4) * 3, "b": rs.randn(4) * 200}]}
    tree = {k: [{n: v.astype(np.float32) for n, v in p.items()} for p in ps]
            for k, ps in tree.items()}
    want = jfxp.quantize_params_int(
        {k: [{n: jnp.asarray(v) for n, v in p.items()} for p in ps]
         for k, ps in tree.items()})
    got = tfxp.quantize_params_int(
        {k: [{n: torch.from_numpy(v) for n, v in p.items()} for p in ps]
         for k, ps in tree.items()})
    for k in tree:
        for gp, wp in zip(got[k], want[k]):
            for n in ("w", "b"):
                assert gp[n].dtype == torch.int16
                np.testing.assert_array_equal(gp[n].numpy(),
                                              np.asarray(wp[n]))
    with pytest.raises(ValueError, match="'w'/'b'"):
        tfxp.quantize_params_int({"fc": [{"w": torch.zeros(2, 2),
                                          "gamma": torch.zeros(2)}]})
