"""repro_torch.runtime.compression against repro.runtime.compression (CPU).

* ``compress_int8`` / ``decompress_int8`` / ``ef_compress_update`` equal
  the JAX package's bit for bit on the same NumPy inputs: f32 and bf16
  ``x``, 1-D, 2-D and 3-D shapes, scales included.
* Twins of ``tests/test_runtime.py::test_int8_roundtrip_error_bounded``
  (over a handful of seeds, not a hypothesis sweep) and
  ``test_error_feedback_is_lossless_in_aggregate``.
* On 3 gloo ranks (``tests/_torch_dist.py``), ``compressed_all_reduce``
  equals the f32 sum, in rank order, of each rank's dequantized summand
  bit for bit, every rank gets the same bits, the new error equals each
  rank's residue, and a spy shows that the all-gather carries the int8
  payload and the f32 row scales.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime import compression as jcomp
from repro_torch import runtime
from repro_torch.runtime import compression as comp

from _torch_dist import COMPRESSION_CASES, compression_inputs, run_worlds

SHAPES = [(300,), (16, 64), (64, 257), (3, 5, 33)]
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _inputs(seed, shape, dtype):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * (1 + seed)).astype(np.float32)
    if len(shape) > 1:
        x[0] = 0.0                     # an all-zero row: the scale's clamp
    return x.astype(DTYPES[dtype][0]), (rs.randn(*shape) * 1e-2).astype(
        np.float32)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_ef_update_equal_reference(seed, shape, dtype):
    x, err = _inputs(seed, shape, dtype)
    q, s = comp.compress_int8(_torch(x))
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.decompress_int8(q, s).numpy(),
        np.asarray(jcomp.decompress_int8(jq, js)))
    got = comp.ef_compress_update(_torch(x), _torch(err))
    want = jcomp.ef_compress_update(jnp.asarray(x), jnp.asarray(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bf = comp.decompress_int8(q, s, torch.bfloat16)
    np.testing.assert_array_equal(
        _np(bf), np.asarray(jcomp.decompress_int8(jq, js, jnp.bfloat16)))


@pytest.mark.parametrize("seed", [0, 7, 123, 4567, 2 ** 31 - 1])
def test_int8_roundtrip_error_bounded(seed):
    """``test_int8_roundtrip_error_bounded``'s property over five seeds:
    each element within half its row's scale."""
    x = torch.randn((16, 64), generator=torch.Generator().manual_seed(
        seed)) * 5
    q, s = runtime.compress_int8(x)
    err = (runtime.decompress_int8(q, s) - x).abs()
    assert bool((err <= s / 2 + 1e-6).all())


def test_error_feedback_is_lossless_in_aggregate():
    """EF property: the sum of what was sent tends to the sum of the true
    values (the same 50 rounds and bound as the JAX package's test)."""
    g = torch.randn((8, 32), generator=torch.Generator().manual_seed(0)) \
        * 0.1
    err = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(50):
        q, s, err = runtime.ef_compress_update(g, err)
        sent = sent + runtime.decompress_int8(q, s)
    np.testing.assert_allclose((sent / 50).numpy(), g.numpy(), atol=2e-3)


def test_ef_init_and_exports():
    grads = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    st = comp.ef_init(grads)
    assert isinstance(st, runtime.ErrorFeedbackState)
    assert st.error["a"].dtype == torch.float32
    assert torch.equal(st.error["b"][0], torch.zeros(2))
    assert set(runtime.__all__) >= {
        "compress_int8", "decompress_int8", "ErrorFeedbackState",
        "compressed_all_reduce", "ef_compress_update"}


WORLD = 3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("compression"),
                      {"c": ("compression_scenario", WORLD, {})})["c"]


@pytest.mark.parametrize("case", COMPRESSION_CASES, ids=[
    f"{str(d).split('.')[-1]}-{'x'.join(map(str, s))}"
    for d, s in COMPRESSION_CASES])
def test_compressed_all_reduce_is_rank_order_sum(ranks, case):
    dtype, shape = case
    want = None
    for r in range(WORLD):
        x, err = compression_inputs(r, dtype, shape)
        q, s, new_err = comp.ef_compress_update(x, err)
        part = q.to(torch.float32) * s
        want = part if want is None else want + part
        got_sum, got_err = ranks[r]["out"][case]
        assert torch.equal(got_err, new_err)
        assert torch.equal(got_err, (x.float() + err)
                           - comp.decompress_int8(q, s))
    for r in range(WORLD):
        got_sum, _ = ranks[r]["out"][case]
        assert got_sum.dtype == dtype
        assert torch.equal(got_sum, want.to(dtype))


def test_all_gather_carries_int8(ranks):
    for r in range(WORLD):
        wire = ranks[r]["wire"]
        assert len(wire) == 2 * len(COMPRESSION_CASES)
        for (dtype, shape), (q, s) in zip(COMPRESSION_CASES,
                                          zip(wire[::2], wire[1::2])):
            assert q == (torch.int8, shape)
            rows = shape[:-1] + (1,) if len(shape) > 1 else (1, 1)
            assert s == (torch.float32, rows)
