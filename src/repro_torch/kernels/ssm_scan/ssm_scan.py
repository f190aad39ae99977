"""Selective scan (mamba-1), the SSM hot spot of LM token attribution.

:func:`selective_scan` wraps the CUDA kernel ``csrc/ssm_scan.cu``, the port
of ``repro.kernels.ssm_scan.ssm_scan.selective_scan_pallas``: one launch
per mamba layer, a channel's f32 states in the registers of 4 lanes, B/C
and the block's dt/x columns staged in shared memory chunk by chunk,
double-buffered.  :func:`selective_scan_bwd` wraps ``csrc/ssm_scan_bwd.cu``,
its vjp (``repro``'s ``ops._bwd``): the reverse recurrence over states
recomputed from checkpoints, every step's operands staged in shared
memory, dB/dC summed per cluster of blocks on chip and then over clusters
in a fixed order.  CPU tensors run the plain versions
:func:`ref.selective_scan` and :func:`ref.selective_scan_bwd`.

``d_tile`` and ``chunk`` are the launch knobs of the JAX package (how many
channels one grid cell covers, how many timesteps one staging chunk
holds).  As there, they split the grid and the staging, never the
arithmetic of an element, so every pair gives the same bits, forward and
backward.  In the backward ``chunk`` sets the window of checkpointed
steps (:func:`bwd_window`); its block is a fixed count of
:data:`BWD_CHANNELS` channels and its cluster of :data:`BWD_CLUSTER`
blocks the fixed group of :data:`BWD_GROUP` channels of a dB/dC partial.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check, check_kernel_operands, on_card
from repro_torch.kernels.ssm_scan import ref
from repro_torch.kernels.tiling import cdiv

#: Kernel entry points per element type of x (and y, gy, dx).
_ENTRY = {torch.float32: "repro_selective_scan",
          torch.bfloat16: "repro_selective_scan_bf16"}
_ENTRY_BWD = {torch.float32: "repro_selective_scan_bwd",
              torch.bfloat16: "repro_selective_scan_bwd_bf16"}
#: States of a channel the kernels keep in registers, lanes of a channel
#: (4 states a lane; constants of both kernels, csrc/ssm_scan.cuh).
MAX_STATE = 16
LANES = 4
#: Forward: at most this many channels a block, steps a staging chunk.
FWD_MAX_CHANNELS = 32
FWD_MAX_CHUNK = 16
#: Backward: steps a segment (staged, recomputed into registers), channels
#: a block, blocks a thread-block cluster, channels a dB/dC partial (the
#: cluster's), segments a window (checkpoints in shared memory).
BWD_SEG = 8
BWD_CHANNELS = 32
BWD_CLUSTER = 4
BWD_GROUP = BWD_CLUSTER * BWD_CHANNELS
BWD_MAX_SLOTS = 16
#: Blocks an SM the backward kernel's registers are bounded for (its
#: ``__launch_bounds__``).
BWD_MIN_BLOCKS = 5


def fwd_channels(d_tile: int, d: int) -> int:
    """Channels a forward block covers: ``min(d_tile, D)`` rounded up to
    whole warps (8 channels of 4 lanes), at most :data:`FWD_MAX_CHANNELS`."""
    c = max(1, min(d_tile, d))
    return min(FWD_MAX_CHANNELS, cdiv(c, 8) * 8)


def bwd_window(s: int, chunk: int) -> int:
    """Steps of one backward window: ``min(chunk, S)`` rounded up to whole
    segments, at most :data:`BWD_MAX_SLOTS` of them.  A longer sequence runs
    ``ceil(S / window)`` windows, each re-running the forward from h0."""
    segs = cdiv(max(1, min(chunk, s)), BWD_SEG)
    return BWD_SEG * min(BWD_MAX_SLOTS, segs)


def _check_scan(name, dt, x, bmat, cmat, a, h0, d_tile, chunk):
    """Validate the scan's operands; return (dt, bmat, cmat) in f32."""
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"{name}: x must be [B,S,D] and a [D,N], got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    b, s, d = x.shape
    n = a.shape[1]
    dt_t = min(d_tile, d)
    assert d % dt_t == 0, (d, dt_t)
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be >= 1, got {chunk}")
    dt = dt.to(torch.float32)
    bmat = bmat.to(torch.float32)
    cmat = cmat.to(torch.float32)
    check(name, dt, torch.float32, (b, s, d), what="dt")
    check(name, x, tuple(_ENTRY), what="x")
    check(name, bmat, torch.float32, (b, s, n), what="bmat")
    check(name, cmat, torch.float32, (b, s, n), what="cmat")
    check(name, a, torch.float32, (d, n), what="a")
    check(name, h0, torch.float32, (b, d, n), what="h0")
    return dt, bmat, cmat


def _check_state_count(name, n):
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{name}: the kernel keeps N <= {MAX_STATE} "
                         f"states in registers, got N = {n}")


def selective_scan(dt, x, bmat, cmat, a, h0, *, d_tile: int, chunk: int):
    """dt/x [B,S,D], bmat/cmat [B,S,N], a [D,N] f32, h0 [B,D,N] f32 ->
    (y [B,S,D] in x's dtype, h_last [B,D,N] f32).

    dt, B and C are cast to f32 (as ``selective_scan_pallas`` does); x is
    f32 or bf16.  ``d % min(d_tile, D) == 0`` is required, as in the JAX
    package.  CPU tensors run :func:`ref.selective_scan`; CUDA tensors the
    kernel.
    """
    name = "selective_scan"
    dt, bmat, cmat = _check_scan(name, dt, x, bmat, cmat, a, h0, d_tile,
                                 chunk)
    if not on_card(name, dt, x, bmat, cmat, a, h0):
        return ref.selective_scan(dt, x, bmat, cmat, a, h0)
    b, s, d = x.shape
    n = a.shape[1]
    _check_state_count(name, n)
    # B/C come as views of one projection: make every operand dense
    dt, x, bmat, cmat, a, h0 = (t.contiguous()
                                for t in (dt, x, bmat, cmat, a, h0))
    check_kernel_operands(name, dt, x, bmat, cmat, a, h0)
    y = torch.empty_like(x)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    if b and d:
        _build.launch(name, _ENTRY[x.dtype], x.device, dt.data_ptr(),
                      x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                      a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                      h_last.data_ptr(), b, s, d, n, fwd_channels(d_tile, d),
                      chunk)
    return y, h_last


def selective_scan_bwd(dt, x, bmat, cmat, a, h0, gy, gh, *, d_tile: int,
                       chunk: int, needs=None):
    """The vjp of :func:`selective_scan` at its inputs, for the cotangents
    ``gy`` [B,S,D] (y's: x's dtype) and ``gh`` [B,D,N] f32 (h_last's; None:
    zeros).

    Returns ``(ddt, dx, dB, dC, dA, dh0)``: dx in x's dtype, the others f32;
    None for each input that ``needs`` (six bools in argument order; None:
    all) does not ask for, and nothing is computed for it.  CPU tensors run
    :func:`ref.selective_scan_bwd`; CUDA tensors the kernel.
    """
    name = "selective_scan_bwd"
    dt, bmat, cmat = _check_scan(name, dt, x, bmat, cmat, a, h0, d_tile,
                                 chunk)
    b, s, d = x.shape
    n = a.shape[1]
    check(name, gy, x.dtype, (b, s, d), what="gy")
    if gh is not None:
        check(name, gh, torch.float32, (b, d, n), what="gh")
    needs = (True,) * 6 if needs is None else tuple(bool(w) for w in needs)
    if len(needs) != 6:
        raise ValueError(f"{name}: needs takes six flags, got {len(needs)}")
    if not on_card(name, dt, x, bmat, cmat, a, h0, gy, gh):
        return ref.selective_scan_bwd(dt, x, bmat, cmat, a, h0, gy, gh,
                                      needs)
    _check_state_count(name, n)
    dt, x, bmat, cmat, a, h0, gy = (t.contiguous() for t in (
        dt, x, bmat, cmat, a, h0, gy))
    gh = None if gh is None else gh.contiguous()
    check_kernel_operands(name, dt, x, bmat, cmat, a, h0, gy, gh)
    dev, f32 = x.device, torch.float32

    def out(i, shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev) if needs[i] \
            else None

    grads = (out(0, (b, s, d)), out(1, (b, s, d), x.dtype),
             out(2, (b, s, n)), out(3, (b, s, n)), out(4, (d, n)),
             out(5, (b, d, n)))
    if not (b and d):                 # no channel: sums over nothing
        return tuple(None if g is None else g.zero_() for g in grads)
    groups = cdiv(d, BWD_GROUP)
    ws = (out(2, (b, s, groups, n)), out(3, (b, s, groups, n)),
          out(4, (b, d, n)))
    _build.launch(name, _ENTRY_BWD[x.dtype], dev, dt.data_ptr(),
                  x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                  a.data_ptr(), h0.data_ptr(), gy.data_ptr(),
                  _build.ptr(gh), *map(_build.ptr, grads + ws), b, s, d, n,
                  bwd_window(s, chunk))
    return grads
