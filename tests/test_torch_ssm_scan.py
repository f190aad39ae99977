"""B13 (the selective scan) and the smooth gates of repro_torch against the
JAX package (CPU).

* the scan wrapper's plain version (``kernels/ssm_scan``; a CPU tensor
  runs it) against ``repro``'s sequential ``ref.selective_scan`` and its
  Pallas kernel ``selective_scan_pallas`` in interpret mode, on
  ``tests/test_kernels_ssm.py``'s four shapes and ragged S, f32 and bf16 x:
  h_last and f32 y within ``repro``'s own tolerance (atol 2e-4, rtol
  2e-3); a bf16 y is a rounding of such a value, so it may sit one bf16
  step away (rtol 2^-7, the largest relative bf16 step);
* the port's chunked doubling scan (``models.mamba``) against ``repro``'s
  associative one, at the same tolerance;
* the gradients of ``ops.selective_scan`` with respect to all six inputs
  against ``jax.grad`` of ``repro``'s ``ops.selective_scan`` (Pallas
  forward, reference-recurrence backward): the port differentiates the
  chunked scan, the same recurrence summed in another order, so within
  1e-4 * max|ref| per input;
* ``quantize_int8`` bitwise (half-to-even ties included), and the
  smooth-gate backward of every method and residual policy against the vjp
  of ``repro``'s ``rules.act``: within 1e-5 * max|ref| (the slope is
  evaluated at the same dequantized value; sigmoid and tanh differ in the
  last bit between the libraries).

Inputs are built with NumPy from a seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rules as jrules
from repro.kernels.ssm_scan import ops as jops
from repro.kernels.ssm_scan import ref as jref
from repro.kernels.ssm_scan.ssm_scan import selective_scan_pallas
from repro.models import mamba as jmamba
from repro_torch.core import rules
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan
from repro_torch.models import mamba

ATOL, RTOL = 2e-4, 2e-3          # tests/test_kernels_ssm.py
BF16_RTOL = 2.0 ** -7            # one bf16 rounding step, at most
GRAD_TOL = 1e-4
GATE_TOL = 1e-5
SHAPES = [(1, 8, 16, 4), (2, 17, 32, 8), (1, 64, 128, 16), (2, 33, 256, 16)]


def _inputs(b, s, d, n, seed=0):
    rs = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rs.randn(b, s, d) - 2)).astype(np.float32)
    x = rs.randn(b, s, d).astype(np.float32)
    bm = rs.randn(b, s, n).astype(np.float32)
    cm = rs.randn(b, s, n).astype(np.float32)
    a = (-np.exp(rs.randn(d, n) * 0.3)).astype(np.float32)
    h0 = rs.randn(b, d, n).astype(np.float32)
    return dt, x, bm, cm, a, h0


def _both(args, bf16):
    """The same inputs for each package, x rounded to bf16 where asked."""
    j = [jnp.asarray(v) for v in args]
    t = [torch.from_numpy(v) for v in args]
    if bf16:
        j[1] = j[1].astype(jnp.bfloat16)
        t[1] = t[1].to(torch.bfloat16)
    return j, t


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_scan_matches_reference_and_pallas(shape, bf16):
    b, s, d, n = shape
    j, t = _both(_inputs(b, s, d, n), bf16)
    y, h = selective_scan(*t, d_tile=min(128, d), chunk=16)
    assert y.dtype == t[1].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (b, s, d) and tuple(h.shape) == (b, d, n)
    y_plain, h_plain = ref.selective_scan(*t)        # what a CPU tensor runs
    assert torch.equal(y, y_plain) and torch.equal(h, h_plain)
    y_ref, h_ref = jref.selective_scan(*j)            # y in f32 always
    y_pl, h_pl = selective_scan_pallas(*j, d_tile=min(128, d), chunk=16)
    rtol = BF16_RTOL if bf16 else RTOL
    _close(y, y_ref, rtol=rtol)
    _close(y, y_pl, rtol=rtol)
    _close(h, h_ref)
    _close(h, h_pl)


@pytest.mark.parametrize("s", [1, 7, 13, 24, 33])
def test_plain_scan_ragged_lengths(s):
    j, t = _both(_inputs(1, s, 16, 4, seed=s), False)
    y, h = selective_scan(*t, d_tile=16, chunk=8)
    y_pl, h_pl = selective_scan_pallas(*j, d_tile=16, chunk=8)
    assert tuple(y.shape) == (1, s, 16)
    _close(y, y_pl)
    _close(h, h_pl)


def test_wrapper_contract():
    _, t = _both(_inputs(1, 5, 24, 4), False)
    with pytest.raises(AssertionError):
        selective_scan(*t, d_tile=16, chunk=8)        # 24 % 16 != 0
    with pytest.raises(TypeError, match="x must be"):
        selective_scan(t[0], t[1].to(torch.float16), *t[2:], d_tile=8,
                       chunk=8)
    # dt, B and C are cast to f32, as the Pallas wrapper does
    y, _ = selective_scan(t[0].to(torch.bfloat16), t[1],
                          t[2].to(torch.bfloat16), t[3], t[4], t[5],
                          d_tile=8, chunk=8)
    assert y.dtype == torch.float32


@pytest.mark.parametrize("chunk", [5, 16])
def test_chunked_scan_matches_repro_module_math(chunk):
    """models.mamba.chunked_scan == repro's chunk body (associative scan,
    C . h inside the chunk), ragged last chunk included."""
    b, s, d, n = 2, 13, 16, 4
    dt, x, bm, cm, a, h0 = _inputs(b, s, d, n, seed=7)
    y, h = mamba.chunked_scan(*map(torch.from_numpy, (dt, x, bm, cm, a,
                                                       h0)), chunk=chunk)
    abar = jnp.exp(dt[..., None] * a)
    bx = dt[..., None] * bm[:, :, None, :] * x[..., None]
    h_all, h_last = jmamba._chunk_scan(abar, bx, jnp.asarray(h0))
    _close(y, jnp.einsum("bsdn,bsn->bsd", h_all, cm))
    _close(h, h_last)


def test_chunk_scan_step_matches_repro():
    rs = np.random.RandomState(3)
    abar = np.exp(-np.abs(rs.randn(2, 11, 8, 4))).astype(np.float32)
    bx = rs.randn(2, 11, 8, 4).astype(np.float32)
    h0 = rs.randn(2, 8, 4).astype(np.float32)
    h_all, h_last = mamba._chunk_scan(*map(torch.from_numpy,
                                           (abar, bx, h0)))
    j_all, j_last = jmamba._chunk_scan(jnp.asarray(abar), jnp.asarray(bx),
                                       jnp.asarray(h0))
    _close(h_all, j_all)
    _close(h_last, j_last)


@pytest.mark.parametrize("d_tile,chunk", [(16, 8), (32, 64)])
def test_scan_gradients_match_jax(d_tile, chunk):
    b, s, d, n = 2, 11, 32, 4
    args = _inputs(b, s, d, n, seed=11)
    rs = np.random.RandomState(12)
    gy = rs.randn(b, s, d).astype(np.float32)
    gh = rs.randn(b, d, n).astype(np.float32)

    def jloss(*a):
        y, h = jops.selective_scan(*a, d_tile=d_tile, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(v) for v in args])
    t = [torch.from_numpy(v).requires_grad_() for v in args]
    y, h = ops.selective_scan(*t, d_tile=d_tile, chunk=chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(loss, t)
    for name, g, w in zip(("dt", "x", "B", "C", "A", "h0"), got, want):
        w = np.asarray(w)
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def test_scan_backward_skips_inputs_without_grad():
    t = [torch.from_numpy(v) for v in _inputs(1, 6, 8, 4, seed=2)]
    t[1].requires_grad_()
    y, _ = ops.selective_scan(*t, d_tile=8, chunk=4)
    (gx,) = torch.autograd.grad(y.sum(), [t[1]])
    assert gx.shape == t[1].shape and torch.isfinite(gx).all()


# -- int8 residuals and the smooth gates ---------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bitwise(dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(6, 40).astype(np.float32) * 3
    x[0] = 0.0                                   # scale floor 1e-12
    x[1, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]   # scale 1: .5 ties
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))
    jq, js = jrules.quantize_int8(jx)
    q, sc = rules.quantize_int8(tx)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    assert list(q[1, :6]) == [127, 2, -4, 0, 0, 2]          # half to even
    for out_dtype in (jnp.float32, jnp.bfloat16):
        tdt = torch.float32 if out_dtype == jnp.float32 else torch.bfloat16
        np.testing.assert_array_equal(
            _np(rules.dequantize_int8(q, sc, tdt)),
            _np(jrules.dequantize_int8(jq, js, out_dtype)))


@pytest.mark.parametrize("residual", ["int8", "exact"])
@pytest.mark.parametrize("method", ["autodiff", "saliency", "deconvnet",
                                    "guided"])
@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_smooth_gate_backward_matches_repro(kind, method, residual):
    rs = np.random.RandomState(5)
    x = (rs.randn(4, 64) * 2).astype(np.float32)
    g = rs.randn(4, 64).astype(np.float32)
    g.reshape(-1)[::9] = 0.0                      # g > 0 is strict
    jy, vjp = jax.vjp(lambda v: jrules.act(v, kind, method, residual),
                      jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    y = rules.act(tx, kind, method, residual)
    (tg,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    for got, want in ((y, jy), (tg, jg)):
        want = np.asarray(want)
        assert np.abs(_np(got) - want).max() <= GATE_TOL * np.abs(want).max()


def test_int8_slope_is_not_autograds():
    """Saliency through an int8 SiLU evaluates the slope at the dequantized
    residual: it equals g * silu'(dequant(q)), not autograd's g * silu'(x),
    and the forward keeps no float copy of x."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy((rs.randn(3, 50) * 2).astype(np.float32))
    g = torch.from_numpy(rs.randn(3, 50).astype(np.float32))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    xr = x.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = rules.silu(xr, "saliency", "int8")
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (torch.int8, (3, 50)), (torch.float32, (3, 1))]
    (got,) = torch.autograd.grad(y, xr, g)
    xq = rules.dequantize_int8(*rules.quantize_int8(x), torch.float32)
    s = 1 / (1 + torch.exp(-xq))
    assert torch.equal(got, g * (s * (1 + xq * (1 - s))))
    xa = x.clone().requires_grad_()
    (exact,) = torch.autograd.grad(torch.nn.functional.silu(xa), xa, g)
    assert not torch.allclose(got, exact, rtol=1e-6, atol=0)
