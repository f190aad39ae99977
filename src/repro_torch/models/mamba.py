"""Mamba-1 selective-scan block (falcon-mamba), as ``repro.models.mamba``.

The full-sequence recurrence ``h_t = Abar_t * h_{t-1} + Bbar_t x_t``
(diagonal A) runs one of three ways, in ``repro``'s order:

* one token (``s == 1``, decode): the O(1) update of the carried state;
* ``use_pallas`` or a ``scan_tile``: the B13 kernel
  (``kernels/ssm_scan``), whose backward is the B13 backward kernel (the
  reverse recurrence over recomputed states) — the LM attribution path;
* otherwise the chunked scan: fixed-size chunks, each a log-step doubling
  scan (torch has no ``associative_scan``) with the discretization and the
  ``C . h`` contraction inside the chunk, the state carried between
  chunks — prefill, and autodiff through the stack.

Every gate goes through ``core.rules.act``, so attribution crosses the SSM
with the configured method and residual policy.  ``A_log``, ``D`` and
``dt_bias`` stay f32, as in the JAX package.

On a mesh whose "model" axis has several ranks each rank runs its
``d_inner / ways`` channels: its columns of both halves of ``in_proj``,
its conv, ``dt_proj``, ``A_log``, ``D`` and ``dt_bias`` channels, the scan
(B13 on the rank's channels), and its rows of ``out_proj`` and
``x_proj``, whose partial products are summed over the model group.  The
summed ``dt | B | C`` then enters each rank's channels through
``copy_to_model``, so their cotangents (B13's backward returns dB and dC
summed over the rank's own channels only) are summed over the group too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import rules
from repro_torch.dist import sharding as shd
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import layers


def init_mamba(gen: torch.Generator, cfg) -> dict:
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    dev, dtype = gen.device, cfg.torch_dtype
    # S4-style A init: -[1..N] per channel
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=dev)[None, :].expand(di, n)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di, dtype),
        "conv_w": (torch.randn((cfg.ssm_conv, di), generator=gen,
                               device=dev) * (1.0 / cfg.ssm_conv)).to(dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": layers.dense_init(gen, di, dtr + 2 * n, dtype),
        "dt_proj": layers.dense_init(gen, dtr, di, dtype),
        "dt_bias": torch.full((di,), -4.6, device=dev),  # softplus ~= 0.01
        "A_log": torch.log(a),
        "D": torch.ones(di, device=dev),
        "out_proj": layers.dense_init(gen, di, d, dtype),
    }


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, kernel k (small, unrolled taps).

    x: [B, S, di]; w: [k, di].  With ``state`` [B, k-1, di] (decode), the
    window is state||x.  Returns (y, new_state).
    """
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # [B, S+k-1, di]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    return y, xp[:, -(k - 1):]


def _chunk_scan(abar, bx, h0):
    """One chunk: h_t = abar_t * h_{t-1} + bx_t, seeded by the carry h0.

    abar, bx: [B, C, di, N] (f32); h0: [B, di, N].  A Hillis-Steele
    doubling scan over C (ceil(log2 C) vectorised steps) of the combine
    ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r)``.  Returns
    (h_all [B, C, di, N], h_last).
    """
    a, b = abar, bx
    k, c = 1, abar.shape[1]
    while k < c:
        a, b = (torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1),
                torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]],
                          dim=1))
        k *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def chunked_scan(dt, x, bmat, cmat, a, h0, *, chunk: int):
    """The selective scan as chunks of :func:`_chunk_scan`, with the
    discretization and the ``C . h`` contraction inside each chunk, so the
    ``[B, S, di, N]`` tensors never exist beyond one chunk.  Same contract
    as the kernel: ``(y [B,S,di] in x's dtype, h_last [B,di,N] f32)``.  A
    ragged last chunk is simply shorter (the JAX package zero-pads it;
    a step with dt = 0 leaves h unchanged)."""
    s = x.shape[1]
    f32 = torch.float32
    dt, xf = dt.to(f32), x.to(f32)
    bmat, cmat = bmat.to(f32), cmat.to(f32)
    h = h0.to(f32)
    ys, ck = [], max(1, min(chunk, s))
    for t0 in range(0, s, ck):
        sl = slice(t0, t0 + ck)
        dtc = dt[:, sl]
        abar = torch.exp(dtc[..., None] * a)         # [B, ck, di, N]
        bx = dtc[..., None] * bmat[:, sl, None, :] * xf[:, sl, :, None]
        h_all, h = _chunk_scan(abar, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, cmat[:, sl]))
    y = torch.cat(ys, dim=1) if ys else xf.new_zeros(xf.shape)
    return y.to(x.dtype), h


def mamba_core(p, x, cfg, method="autodiff", state: Optional[dict] = None,
               pos=None, use_pallas: bool = False, scan_tile=None):
    """x: [B, S, d] -> (out [B, S, d], new_state | None).

    ``state = {"h": [B, di, N] f32, "conv": [B, k-1, di]}`` for decode.
    ``use_pallas`` routes the full-sequence scan through the B13 kernel
    with its default knobs; ``scan_tile`` is a ``(d_tile, chunk)`` pair for
    it (same bits for every pair).  ``pos`` is unused (attention-free).
    On the model axis ``di`` is the rank's channel count and the state
    holds its channels.
    """
    b, s, _ = x.shape
    di, n = p["A_log"].shape[0], cfg.ssm_state

    x = shd.copy_to_model(x)
    xz = x @ p["in_proj"]
    xin, z = xz.split(di, dim=-1)

    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = rules.act(xc, "silu", method, cfg.residual_policy,
                   row_max=shd.max_over_model)

    bcdt = shd.copy_to_model(shd.reduce_from_model(
        xc @ p["x_proj"]))                                # [B, S, dtr+2N]
    dt_r, bmat, cmat = bcdt.split([cfg.dtr, n, n], dim=-1)
    dt = F.softplus((dt_r @ p["dt_proj"]).to(torch.float32)
                    + p["dt_bias"])                       # [B, S, di] f32
    a = -torch.exp(p["A_log"])                            # [di, N]

    h_init = (state["h"] if state is not None
              else torch.zeros((b, di, n), dtype=torch.float32,
                               device=x.device))

    if s == 1:                                            # decode: O(1)
        abar = torch.exp(dt[..., None] * a)
        bx = (dt[..., None] * bmat.to(torch.float32)[:, :, None, :]
              * xc.to(torch.float32)[..., None])
        h_last = abar[:, 0] * h_init + bx[:, 0]
        y = torch.einsum("bdn,bn->bd", h_last,
                         cmat[:, 0].to(torch.float32))[:, None].to(x.dtype)
    elif use_pallas or scan_tile is not None:
        d_tile, chunk = scan_tile if scan_tile is not None else (None, None)
        y, h_last = scan_ops.selective_scan(dt, xc, bmat, cmat, a, h_init,
                                            d_tile=d_tile, chunk=chunk)
        y = y.to(x.dtype)
    else:
        y, h_last = chunked_scan(dt, xc, bmat, cmat, a, h_init,
                                 chunk=cfg.ssm_chunk)
        y = y.to(x.dtype)

    y = y + xc * p["D"].to(x.dtype)
    y = y * rules.act(z, "silu", method, cfg.residual_policy,
                      row_max=shd.max_over_model)
    out = shd.reduce_from_model(y @ p["out_proj"])

    new_state = None
    if state is not None:
        new_state = {"h": h_last,
                     "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state


def init_state(cfg, batch: int, dtype=None, device=None) -> dict:
    """Decode state for one mamba block."""
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype or cfg.torch_dtype, device=device),
    }
