"""B13's backward (the selective scan's vjp) in repro_torch against the JAX
package, on the CPU.

* the plain reverse recurrence ``ref.selective_scan_bwd`` (what a CPU
  tensor runs, through the wrapper ``ssm_scan.selective_scan_bwd``)
  against ``jax.vjp`` of ``repro``'s reference loop, which is what
  ``repro.kernels.ssm_scan.ops.selective_scan``'s backward (``_bwd``)
  computes: ``tests/test_kernels_ssm.py``'s four shapes and a ragged S, x
  f32 and bf16, gh zero and not, all six gradients, each within 1e-4 *
  max|ref| (one bf16 step, 2^-7 relative, more where the gradient is
  bf16).  (``jax.grad`` through ``ops.selective_scan`` itself is held in
  ``test_torch_ssm_scan.py`` in f32; under bf16 x it fails in ``repro``,
  ROADMAP queue C, so bf16 goes to the vjp directly.)
* the autograd Function ``ops._SelectiveScan`` on the CPU equal bit for
  bit to ``ref.selective_scan_bwd``, each gradient in its input's dtype,
  with B and C bf16 views of one projection as ``mamba_core`` passes them;
* subsets of the gradients: only what is asked is computed, with the bits
  of the full call;
* the launch helpers of both kernels (channels a forward block, shared
  memory, the backward's window, grid and cluster partial groups) and the
  arguments the wrapper hands the backward's entry point, with the launch
  stubbed.

Inputs are built with NumPy from a seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.kernels.ssm_scan import ssm_scan as scan_mod
from repro_torch.kernels.ssm_scan.ssm_scan import (
    BWD_CHANNELS, BWD_CLUSTER, BWD_GROUP, BWD_MAX_SLOTS, BWD_MIN_BLOCKS,
    BWD_SEG, FWD_MAX_CHANNELS, FWD_MAX_CHUNK, LANES, MAX_STATE, bwd_window,
    fwd_channels, selective_scan_bwd)
from repro_torch.kernels.tiling import H100_SMS, cdiv

GRAD_TOL = 1e-4
BF16_RTOL = 2.0 ** -7            # one bf16 rounding step, at most
SHAPES = [(1, 8, 16, 4), (2, 17, 32, 8), (1, 64, 128, 16), (2, 33, 256, 16),
          (2, 13, 24, 16)]       # the last: ragged S, D % 32 != 0
NAMES = ("ddt", "dx", "dB", "dC", "dA", "dh0")
#: The shared memory a block can use without opting in, with it, and per
#: SM.
SMEM_DEFAULT, SMEM_OPT_IN, SMEM_PER_SM = 48 * 1024, 227 * 1024, 228 * 1024


def _inputs(b, s, d, n, seed=0):
    rs = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rs.randn(b, s, d) - 2)).astype(np.float32)
    x = rs.randn(b, s, d).astype(np.float32)
    bm = rs.randn(b, s, n).astype(np.float32)
    cm = rs.randn(b, s, n).astype(np.float32)
    a = (-np.exp(rs.randn(d, n) * 0.3)).astype(np.float32)
    h0 = rs.randn(b, d, n).astype(np.float32)
    gy = rs.randn(b, s, d).astype(np.float32)
    gh = rs.randn(b, d, n).astype(np.float32)
    return (dt, x, bm, cm, a, h0), gy, gh


def _torch_args(args, gy, bf16):
    t = [torch.from_numpy(v) for v in args]
    gy = torch.from_numpy(gy)
    if bf16:
        t[1], gy = t[1].to(torch.bfloat16), gy.to(torch.bfloat16)
    return t, gy


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _assert_grad_close(name, got, want):
    """Within GRAD_TOL * max|want|, one bf16 step more for a bf16 got."""
    g, w = _f32(got), _f32(want)
    bound = GRAD_TOL * np.abs(w).max()
    if got.dtype == torch.bfloat16:
        bound = bound + BF16_RTOL * np.abs(w)
    assert (np.abs(g - w) <= bound).all(), (name, np.abs(g - w).max())


@pytest.mark.parametrize("with_gh", [False, True], ids=["gh0", "gh"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_repro_vjp(shape, bf16, with_gh):
    args, gy, gh = _inputs(*shape, seed=sum(shape))
    if not with_gh:
        gh = np.zeros_like(gh)
    t, tgy = _torch_args(args, gy, bf16)
    got = selective_scan_bwd(*t, tgy, torch.from_numpy(gh) if with_gh
                             else None, d_tile=shape[2], chunk=16)
    j = [jnp.asarray(v) for v in args]
    if bf16:
        j[1] = j[1].astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jref.selective_scan(*a), *j)
    want = vjp((jnp.asarray(_f32(tgy)), jnp.asarray(gh)))
    for name, g, w, inp in zip(NAMES, got, want, t):
        assert g.shape == inp.shape
        assert g.dtype == (inp.dtype if name == "dx" else torch.float32)
        assert w.dtype == (jnp.bfloat16 if bf16 and name == "dx"
                           else jnp.float32)
        _assert_grad_close(name, g, w)


@pytest.mark.parametrize("use_h", [False, True], ids=["y", "y_and_h"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_function_backward_is_the_plain_recurrence_bitwise(bf16, use_h):
    """autograd through ops.selective_scan == ref.selective_scan_bwd, each
    gradient cast to its input's dtype; B and C bf16 views of one
    projection; h_last unused (no gh) or used."""
    b, s, d, n = 2, 11, 32, 8
    args, gy, gh = _inputs(b, s, d, n, seed=3)
    t, tgy = _torch_args(args, gy, bf16)
    bc = torch.from_numpy(np.concatenate([args[2], args[3]], -1)).to(
        torch.bfloat16)
    leaves = [t[0].requires_grad_(), t[1].requires_grad_(),
              bc.requires_grad_(), t[4].requires_grad_(),
              t[5].requires_grad_()]
    bm, cm = bc[..., :n], bc[..., n:]
    y, h = ops.selective_scan(leaves[0], leaves[1], bm, cm, leaves[3],
                              leaves[4], d_tile=d, chunk=4)
    outs, cots = [y], [tgy]
    if use_h:
        outs.append(h)
        cots.append(torch.from_numpy(gh))
    got = torch.autograd.grad(outs, leaves, cots)
    want = ref.selective_scan_bwd(t[0].detach(), t[1].detach(), bm.detach(),
                                  cm.detach(), t[4].detach(), t[5].detach(),
                                  tgy, cots[1] if use_h else None)
    dbc = torch.cat([want[2], want[3]], -1).to(torch.bfloat16)
    for g, w, leaf in zip(got, (want[0], want[1], dbc, want[4], want[5]),
                          leaves):
        assert g.dtype == leaf.dtype
        assert torch.equal(g, w.to(leaf.dtype))


@pytest.mark.parametrize("needs", [(False, True, False, False, False, False),
                                   (True, True, True, True, False, False),
                                   (False, False, True, False, True, False),
                                   (False, False, False, False, False, True)])
def test_only_what_is_asked_is_computed(needs):
    args, gy, gh = _inputs(2, 9, 16, 4, seed=5)
    t, tgy = _torch_args(args, gy, False)
    full = selective_scan_bwd(*t, tgy, torch.from_numpy(gh), d_tile=16,
                              chunk=8)
    part = selective_scan_bwd(*t, tgy, torch.from_numpy(gh), d_tile=16,
                              chunk=8, needs=needs)
    for w, g, g0 in zip(needs, part, full):
        assert (g is None) != w
        if w:
            assert torch.equal(g, g0)


def test_function_skips_inputs_without_grad(monkeypatch):
    """Only x needs a gradient: the backward is asked for dx alone."""
    args, gy, _ = _inputs(1, 6, 8, 4, seed=2)
    t, tgy = _torch_args(args, gy, False)
    asked = []
    real = scan_mod.selective_scan_bwd

    def spy(*a, **kw):
        asked.append(kw["needs"])
        return real(*a, **kw)

    t[1].requires_grad_()
    y, _ = ops.selective_scan(*t, d_tile=8, chunk=4)
    monkeypatch.setattr(scan_mod, "selective_scan_bwd", spy)
    (gx,) = torch.autograd.grad(y, [t[1]], tgy)
    assert asked == [(False, True, False, False, False, False)]
    assert gx.shape == t[1].shape and torch.isfinite(gx).all()


def test_backward_wrapper_contract():
    args, gy, gh = _inputs(1, 5, 8, 4)
    t, tgy = _torch_args(args, gy, False)
    with pytest.raises(TypeError, match="gy must be"):
        selective_scan_bwd(*t, tgy.to(torch.bfloat16), None, d_tile=8,
                           chunk=4)
    with pytest.raises(ValueError, match="gh must have shape"):
        selective_scan_bwd(*t, tgy, torch.zeros(1, 8, 5), d_tile=8, chunk=4)
    with pytest.raises(ValueError, match="six flags"):
        selective_scan_bwd(*t, tgy, None, d_tile=8, chunk=4, needs=(True,))
    # S = 0: every gradient of the steps is empty, dh0 is gh
    e = [v[:, :0] if v.dim() == 3 and v.shape[1] == 5 else v for v in t]
    out = selective_scan_bwd(*e, tgy[:, :0], torch.from_numpy(gh),
                             d_tile=8, chunk=4)
    assert out[0].shape == (1, 0, 8) and torch.equal(
        out[5], torch.from_numpy(gh))
    assert torch.equal(out[4], torch.zeros(8, 4))


# -- launch helpers ------------------------------------------------------------


@pytest.mark.parametrize("d_tile,d", [(8192, 8192), (256, 8192), (16, 64),
                                      (7, 7), (200, 200), (1, 5), (40, 80)])
def test_fwd_channels_are_whole_warps_within_the_block(d_tile, d):
    c = fwd_channels(d_tile, d)
    assert c % 8 == 0 and 8 <= c <= FWD_MAX_CHANNELS
    assert c >= min(d_tile, d, FWD_MAX_CHANNELS)
    assert (LANES * c) % 32 == 0


def _fwd_smem(channels, esize):
    """A forward block's shared memory at its longest chunk (ssm_scan.cu
    Chunk::bytes, two buffers): dt and x columns, B and C rows of 16."""
    return 2 * FWD_MAX_CHUNK * (channels * (4 + esize) + 2 * MAX_STATE * 4)


def _bwd_smem(window, esize):
    """A backward block's shared memory (ssm_scan_bwd.cu smem_bytes): the
    four-stage ring of staged segments (dt, x and gy columns, B and C rows
    of 16), a float4 checkpoint a thread per segment of the window, and
    three thirds of the cluster inbox (its quarter of a segment's 2 x 8 x
    16 dB/dC entries from each of the cluster's 16 warps)."""
    threads = LANES * BWD_CHANNELS
    seg = BWD_SEG * (BWD_CHANNELS * (4 + 2 * esize) + 2 * MAX_STATE * 4)
    share = 2 * BWD_SEG * MAX_STATE // BWD_CLUSTER
    return (4 * seg + (window // BWD_SEG) * threads * 16
            + 4 * 3 * BWD_CLUSTER * (threads // 32) * share)


def test_fwd_fills_the_card_at_the_explain_shape():
    """[4, 72, 8192], N 16, bf16: 1024 blocks of 128 threads, ~31 warps an
    SM, every block resident at once (shared memory)."""
    c = fwd_channels(8192, 8192)
    blocks = cdiv(8192, c) * 4
    assert blocks == 1024
    warps = blocks * LANES * c // 32
    assert warps / H100_SMS > 30
    assert SMEM_PER_SM // (_fwd_smem(c, 2) + 1024) * H100_SMS >= blocks


@pytest.mark.parametrize("esize", [2, 4])
def test_kernels_need_no_shared_memory_opt_in(esize):
    """The forward never raises the 48 KB default.  The backward stays
    under it at the explain's window (72 steps, 9 segments); its longest
    windows (11 segments or more in f32, 13 in bf16) opt in
    (ssm_scan_bwd.cu: cudaFuncSetAttribute above 48 KB), within the 227 KB
    a block may have."""
    assert _fwd_smem(FWD_MAX_CHANNELS, esize) <= SMEM_DEFAULT
    assert _bwd_smem(bwd_window(72, 128), esize) <= SMEM_DEFAULT
    opt_in = [w for w in range(1, BWD_MAX_SLOTS + 1)
              if _bwd_smem(BWD_SEG * w, esize) > SMEM_DEFAULT]
    assert opt_in == list(range(13 if esize == 2 else 11,
                                BWD_MAX_SLOTS + 1))
    assert _bwd_smem(BWD_SEG * BWD_MAX_SLOTS, esize) <= SMEM_OPT_IN


@pytest.mark.parametrize("name,d", [("falcon-mamba-7b", 8192),
                                    ("hymba-1.5b", 3200)])
def test_bwd_fills_the_card_at_the_explain_shapes(name, d):
    """[4, 72, D], N 16, bf16, one window of 72 steps: whole clusters of
    BWD_CLUSTER blocks of 128 threads, every SM busy, and shared memory
    for the BWD_MIN_BLOCKS blocks an SM that the registers allow.
    hymba's 400 blocks run in one wave, falcon's 1024 in 1.55."""
    b = 4
    blocks = cdiv(d, BWD_GROUP) * BWD_CLUSTER * b
    assert blocks % BWD_CLUSTER == 0
    assert blocks == {8192: 1024, 3200: 400}[d]
    assert blocks * BWD_CHANNELS >= d * b > (blocks - BWD_CLUSTER) * \
        BWD_CHANNELS                           # no dead cluster
    assert blocks >= H100_SMS
    window = bwd_window(72, 128)
    assert window == 72
    per_sm = SMEM_PER_SM // (_bwd_smem(window, 2) + 1024)
    assert per_sm >= BWD_MIN_BLOCKS
    waves = blocks / (BWD_MIN_BLOCKS * H100_SMS)
    assert waves <= 1 if d == 3200 else 1 < waves < 2


@pytest.mark.parametrize("d", [8, 100, 128, 200, 3200, 8192])
def test_bwd_partial_group_is_a_constant(launches, d):
    """The dB/dC workspace holds one partial per cluster of BWD_GROUP =
    128 channels whatever the knobs: every (d_tile, chunk) pair hands the
    entry point the same [B, S, ceil(D / 128), N] workspaces, so every
    pair sums in one order."""
    assert BWD_GROUP == BWD_CLUSTER * BWD_CHANNELS == 128
    b, s, n = 1, 9, 4
    args, gy, _ = _inputs(b, s, d, n)
    t, tgy = _torch_args(args, gy, False)
    tiles = [(dt, ck) for dt in (d, max(1, d // 2), 1) if d % dt == 0
             for ck in (1, 7, 128)]
    for dt, ck in tiles:
        selective_scan_bwd(*t, tgy, None, d_tile=dt, chunk=ck)
    shapes = {tuple(tuple(w.shape) for w in rec[3][-3:-1])
              for rec in launches}
    assert shapes == {((b, s, cdiv(d, 128), n),) * 2}
    assert len(launches) == len(tiles)


@pytest.mark.parametrize("s,chunk", [(72, 128), (72, 64), (13, 5), (1, 4),
                                     (300, 128), (77, 7), (77, 1),
                                     (4096, 128), (0, 64)])
def test_bwd_window_is_whole_segments_within_the_slots(s, chunk):
    w = bwd_window(s, chunk)
    assert w % BWD_SEG == 0 and BWD_SEG <= w <= BWD_SEG * BWD_MAX_SLOTS
    if 0 < min(s, chunk) <= BWD_SEG * BWD_MAX_SLOTS:
        assert w >= min(s, chunk) > w - BWD_SEG     # one window of chunk


def test_bwd_explain_runs_one_window():
    """The explain's knobs (chunk 128) at S = 72 and 64: one window, so the
    forward runs once from h0; the default chunk 64 at S = 72: two."""
    assert cdiv(72, bwd_window(72, 128)) == 1
    assert cdiv(64, bwd_window(64, 128)) == 1
    assert cdiv(72, bwd_window(72, 64)) == 2


@pytest.fixture
def launches(monkeypatch):
    """Stub the card: the wrapper takes its kernel route on CPU tensors and
    records ``(counter, entry, args, tensors handed to _build.ptr)``."""
    seen, out = [], []
    real_ptr = _build.ptr

    def ptr(t):
        seen.append(t)
        return real_ptr(t)

    def launch(counter, entry, device, *args):
        out.append((counter, entry, args, list(seen)))
        seen.clear()

    monkeypatch.setattr(scan_mod, "on_card", lambda name, *ts: True)
    monkeypatch.setattr(scan_mod, "check_kernel_operands",
                        lambda name, *ts: None)
    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(_build, "launch", launch)
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("needs", [None, (True, True, True, True, False,
                                          False)])
def test_bwd_entry_arguments(launches, bf16, needs):
    b, s, d, n = 2, 13, 200, 16
    args, gy, gh = _inputs(b, s, d, n)
    t, tgy = _torch_args(args, gy, bf16)
    grads = selective_scan_bwd(*t, tgy, None, d_tile=200, chunk=128,
                               needs=needs)
    (counter, entry, a, tensors), = launches
    assert counter == "selective_scan_bwd"
    assert entry == ("repro_selective_scan_bwd_bf16" if bf16
                     else "repro_selective_scan_bwd")
    assert len(a) == len(_build.SIGNATURES[entry]) - 1      # no stream
    ptrs, ints = a[:17], a[17:]
    assert ints == (b, s, d, n, bwd_window(s, 128))
    assert ptrs[7] is None                                   # no gh
    want = (True,) * 6 if needs is None else needs
    for w, p, g in zip(want, ptrs[8:14], grads):
        assert (p is None) != w and (g is None) != w
        if w:
            assert p == g.data_ptr()
    # the workspaces: the dB/dC partials of G clusters of BWD_GROUP
    # channels, and the per-row dA sums
    groups = cdiv(d, BWD_GROUP)
    for w, ws, shape in zip(want[2:5], tensors[-3:], (
            (b, s, groups, n), (b, s, groups, n), (b, d, n))):
        assert (ws is None) != w
        if w:
            assert ws.shape == shape and ws.dtype == torch.float32
    assert grads[1].dtype == t[1].dtype
    assert grads[0].shape == (b, s, d) and grads[2].shape == (b, s, n)


def test_fwd_entry_arguments(launches):
    args, _, _ = _inputs(2, 9, 64, 8)
    t, _ = _torch_args(args, np.zeros(1, np.float32), True)
    scan_mod.selective_scan(*t, d_tile=16, chunk=5)
    (counter, entry, a, _), = launches
    assert (counter, entry) == ("selective_scan", "repro_selective_scan_bf16")
    assert a[8:] == (2, 9, 64, 8, 16, 5)
