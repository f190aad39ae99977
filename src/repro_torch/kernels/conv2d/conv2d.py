"""Convolution kernels (paper §III.B, Fig. 4-6): forward and fused backward.

:func:`conv2d` wraps ``repro_conv2d_fwd`` of ``csrc/conv2d.cu`` (the port of
``repro.kernels.conv2d.conv2d.conv2d_pallas``), with the conv bias added in
its epilogue; :func:`conv_plan` chooses its tile for each shape (K in
:data:`CONV_KS`; other odd K run the kernel of the fused backward, which
tiles itself).
:func:`conv2d_bwd_fused` wraps ``repro_conv2d_bwd_fused`` (the
port of ``conv2d_bwd_fused_pallas``): the unpool scatter by the stored 2-bit
argmax and the Eq. 3-5 gate by the stored 1-bit mask run as a prologue on
the gradient as it is loaded, then the SAME conv with the flip-transposed
kernel, then an optional epilogue gate — a conv layer's whole backward step
in one launch, all S seeds sharing one load of the stored residuals.
:func:`conv2d_bwd_fused_plain` is that kernel's plain twin.

The int16 twins (``conv2d.fxp``) share the argument contract, checks and
plain dataflow defined here; only the element type, the entry point and
the conv itself differ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import masks
from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_kernel_operands, on_card,
                                 validate_bp_gates)
from repro_torch.kernels.conv2d import ref
from repro_torch.kernels.pool.ref import unpool_scatter
from repro_torch.kernels.relu_mask.relu_mask import gate_gradient, unpack_bits
from repro_torch.kernels.tiling import (H100_SMS, align_up, cdiv,
                                        crumb_bytes, mask_bytes)

#: ``csrc/conv2d.cu`` FW_TW and FW_MAX_THREADS: the forward's tile is
#: ``th`` rows x 8 pixels, at most 256 threads a block.
CONV_TILE_W, CONV_MAX_THREADS = 8, 256
#: Kernel sizes the register-tiled forward is compiled for (its tile holds a
#: row of PX + K - 1 inputs); ``repro_conv2d_fwd`` runs other odd K on the
#: general kernel it shares with the fused backward.
CONV_KS = (1, 3, 5, 7)
#: Shared memory a block of the forward may stage (both ring stages): two
#: blocks, each with the 1 KB the card reserves, fit an SM's 228 KB.
CONV_SMEM_BUDGET = 112 * 1024
#: Cin channels per ring stage at most.
CONV_MAX_CIN_T = 32
#: Threads a block aims for: among plans of about two blocks per SM, 128
#: were the fastest on the Table III layers, or within 1 % of it
#: (``python3 chip_smoke.py --sweep`` on an H100).
CONV_TARGET_THREADS = 128


@dataclass(frozen=True)
class ConvPlan:
    """The forward's tile: ``th`` rows x 8 pixels x ``tco`` output channels
    a block, ``px`` pixels (8 or 4) x 4 channels a thread, ``cin_t`` input
    channels a ring stage.  No field changes the order of any sum."""
    th: int
    px: int
    tco: int
    cin_t: int

    @property
    def threads(self) -> int:
        return self.th * (CONV_TILE_W // self.px) * (self.tco // 4)

    def blocks(self, n: int, h: int, w: int, cout: int) -> int:
        return (cdiv(h, self.th) * cdiv(w, CONV_TILE_W)
                * cdiv(cout, self.tco) * n)

    def smem_bytes(self, k: int) -> int:
        """Both ring stages: the halo tile (rows padded to a multiple of 4
        floats, plus 4) and the weight slice, as ``repro_conv2d_fwd``
        lays them out."""
        xstride = align_up(self.cin_t, 4) + 4
        stage = ((self.th + k - 1) * (CONV_TILE_W + k - 1) * xstride
                 + k * k * self.cin_t * self.tco)
        return 2 * 4 * stage

    def args(self) -> Tuple[int, int, int, int]:
        return (self.th, self.px, self.tco, self.cin_t)


def conv_cin_t(cin: int, k: int, th: int, px: int, tco: int) -> int:
    """Cin channels per ring stage: up to 32, halved until both stages fit
    :data:`CONV_SMEM_BUDGET`; a multiple of 4 where Cin is (16-byte
    copies)."""
    step = 4 if cin % 4 == 0 else 1
    ct = max(1, min(cin, CONV_MAX_CIN_T) // step * step)
    while ct > step and ConvPlan(th, px, tco, ct).smem_bytes(k) \
            > CONV_SMEM_BUDGET:
        ct = max(step, ct // 2 // step * step)
    return ct


def conv_plan(n: int, h: int, w: int, cin: int, cout: int,
              k: int) -> ConvPlan:
    """The register-tiled forward's tile for one shape on an H100.

    32 output channels a block (fewer where Cout is), and the tallest tile
    (up to 32 rows) whose grid still gives about two blocks per SM: at
    least twice the SMs rounded down to a power of two (256), as the tiles
    and the batch are powers of two.  Then 8 pixels a thread where that
    makes 128 threads, else 4 for twice the threads.
    """
    if k not in CONV_KS:
        raise ValueError(f"conv2d: the tiled forward takes K in {CONV_KS}, "
                         f"got {k}")
    min_blocks = 1 << ((2 * H100_SMS).bit_length() - 1)
    tco = min(32, align_up(max(cout, 1), 4))
    th = min(32, 1 << max(0, (h - 1).bit_length()))
    while th > 1 and ConvPlan(th, 8, tco, 1).blocks(n, h, w, cout) \
            < min_blocks:
        th //= 2
    px = 8 if th * tco // 4 >= CONV_TARGET_THREADS else 4
    return ConvPlan(th, px, tco, conv_cin_t(cin, k, th, px, tco))


def _check_kernel(name, w, cin, dtype):
    if (w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0
            or w.shape[2] != cin):
        raise ValueError(f"{name}: kernel must be [K, K, {cin}, Cout] with "
                         f"odd K, got {tuple(w.shape)}")
    check(name, w, dtype, what="kernel")


def _fwd_dims(name: str, dtype: torch.dtype, x: torch.Tensor,
              w: torch.Tensor, b: Optional[torch.Tensor]):
    """Check the forward's operands; ``(n, h, w, cin, cout, k)``."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [N, H, W, Cin], got "
                         f"{tuple(x.shape)}")
    n, h, wd, cin = x.shape
    check(name, x, dtype, what="x")
    _check_kernel(name, w, cin, dtype)
    k, cout = w.shape[0], w.shape[3]
    if b is not None:
        check(name, b, dtype, (cout,), what="b")
    return n, h, wd, cin, cout, k


def conv_fwd(name: str, counter: str, entry: str, dtype: torch.dtype,
             plain: Callable, x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor], extra: tuple = ()) -> torch.Tensor:
    """Check, then run ``plain(x, w, b)`` on the CPU or launch ``entry``
    with ``extra`` after its common arguments."""
    n, h, wd, cin, cout, k = _fwd_dims(name, dtype, x, w, b)
    if not on_card(name, x, w, b):
        return plain(x, w, b)
    check_kernel_operands(name, x, w, b)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch(counter, entry, x.device, x.data_ptr(), w.data_ptr(),
                      _build.ptr(b), y.data_ptr(), n, h, wd, cin, cout, k,
                      *extra)
    return y


def _conv2d_plain(x, w, b):
    y = ref.conv2d(x, w)
    return y if b is None else y + b


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, H, W, Cin] x [K, K, Cin, Cout] (+ b [Cout]) -> [N, H, W, Cout],
    stride 1, SAME padding, odd K, f32 accumulation.

    CPU tensors run :func:`ref.conv2d` (then ``+ b``); CUDA tensors the
    kernel, tiled by :func:`conv_plan` for K in :data:`CONV_KS`.
    """
    return conv2d_planned(x, w, b)


def conv2d_planned(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None, *,
                   plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """:func:`conv2d` with the tile chosen by the caller, for tests and
    sweeps: every plan gives the same bits.  One count of ``conv2d_fwd``
    per call."""
    n, h, wd, cin, cout, k = _fwd_dims("conv2d", torch.float32, x, w, b)
    if k in CONV_KS:
        plan = plan or conv_plan(n, h, wd, cin, cout, k)
    elif plan is not None:
        raise ValueError(f"conv2d: a tile plan needs K in {CONV_KS}, got {k}")
    # no plan (0, 0, 0, 0): the general-K kernel, which tiles itself
    return conv_fwd("conv2d", "conv2d_fwd", "repro_conv2d_fwd",
                    torch.float32, _conv2d_plain, x, w, b,
                    plan.args() if plan else (0, 0, 0, 0))


def bwd_fused_plain(conv: Callable, g, wt, *, pool_idx=None, relu_mask=None,
                    gate=None, method="saliency", out_relu_mask=None,
                    out_gate=None):
    """Unpool, gate, ``conv(g, wt)``, gate, as separate PyTorch ops."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 5
    if not seeded:
        g = g[None]
    s, n, _, _, c = g.shape
    cout = wt.shape[-1]
    if pool_idx is not None:
        g = unpool_scatter(masks.unpack_crumbs(pool_idx, c), g)
    if gate:
        bits = None if relu_mask is None else unpack_bits(relu_mask)[..., :c]
        g = gate_gradient(g, bits, method)
    h, w = g.shape[2:4]
    out = conv(g.reshape(s * n, h, w, c), wt).reshape(s, n, h, w, cout)
    if out_gate:
        bits = (None if out_relu_mask is None
                else unpack_bits(out_relu_mask)[..., :cout])
        out = gate_gradient(out, bits, method)
    return out if seeded else out[0]


def conv2d_bwd_fused_plain(g, wt, **kw):
    """Plain twin of :func:`conv2d_bwd_fused`: unpool, gate, conv, gate, as
    separate PyTorch ops."""
    return bwd_fused_plain(ref.conv2d, g, wt, **kw)


def bwd_fused(name: str, entry: str, dtype: torch.dtype, plain: Callable,
              g: torch.Tensor, wt: torch.Tensor, *, pool_idx, relu_mask,
              gate, method, out_relu_mask, out_gate) -> torch.Tensor:
    """Check the fused-backward operands, then run ``plain`` on the CPU or
    launch ``entry`` (counted under ``name``)."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 5
    g5 = g if seeded else g[None]
    if g5.dim() != 5:
        raise ValueError(f"{name}: g must be [S, N, H, W, C] or [N, H, W, C],"
                         f" got {tuple(g.shape)}")
    s, n, hg, wg, c = g5.shape
    check(name, g5, dtype, what="g")
    _check_kernel(name, wt, c, dtype)
    k, cout = wt.shape[0], wt.shape[3]
    h, w = (2 * hg, 2 * wg) if pool_idx is not None else (hg, wg)
    if pool_idx is not None:
        check(name, pool_idx, torch.uint8, (n, hg, wg, crumb_bytes(c)),
              what="pool_idx")
    if relu_mask is not None:
        check(name, relu_mask, torch.uint8, (n, h, w, mask_bytes(c)),
              what="relu_mask")
    if out_relu_mask is not None:
        check(name, out_relu_mask, torch.uint8, (n, h, w, mask_bytes(cout)),
              what="out_relu_mask")
    if not on_card(name, g5, wt, pool_idx, relu_mask, out_relu_mask):
        return plain(
            g, wt, pool_idx=pool_idx, relu_mask=relu_mask, gate=gate,
            method=method, out_relu_mask=out_relu_mask, out_gate=out_gate)
    check_kernel_operands(name, g5, wt, pool_idx, relu_mask, out_relu_mask)
    out = torch.empty((s, n, h, w, cout), dtype=g.dtype, device=g.device)
    if out.numel():
        _build.launch(name, entry, g.device, g5.data_ptr(), wt.data_ptr(),
                      _build.ptr(pool_idx), _build.ptr(relu_mask),
                      _build.ptr(out_relu_mask), out.data_ptr(), s, n, h, w,
                      c, cout, k, int(gate), int(out_gate),
                      METHOD_CODES[method])
    return out if seeded else out[0]


def conv2d_bwd_fused(
        g: torch.Tensor, wt: torch.Tensor, *,
        pool_idx: Optional[torch.Tensor] = None,
        relu_mask: Optional[torch.Tensor] = None,
        gate: Optional[bool] = None,
        method: str = "saliency",
        out_relu_mask: Optional[torch.Tensor] = None,
        out_gate: Optional[bool] = None) -> torch.Tensor:
    """One launch for a conv layer's whole backward step.

    ``g``:        gradients w.r.t. the layer output, [N, Hg, Wg, C] or
                  seed-batched [S, N, Hg, Wg, C] (Hg = H/2 when pooled).
    ``wt``:       flip-transposed kernel [K, K, C, Cout'] (made once by the
                  caller with ``ref.flip_transpose(w)``; Cout' is the
                  forward Cin).
    ``pool_idx``: [N, Hg, Wg, ceil(C/4)] packed 2-bit argmax (None: no pool).
    ``relu_mask``: [N, H, W, ceil(C/8)] packed 1-bit mask of the layer's
                  ReLU; ``gate=True`` with no mask selects deconvnet.
    ``out_relu_mask``/``out_gate``: the same as an epilogue on the outgoing
                  gradient, [N, H, W, ceil(Cout'/8)].
    Residuals carry no seeds axis: all S seeds share one load.
    CPU tensors run :func:`conv2d_bwd_fused_plain`; CUDA tensors the kernel.
    """
    return bwd_fused("conv2d_bwd_fused", "repro_conv2d_bwd_fused",
                     torch.float32, conv2d_bwd_fused_plain, g, wt,
                     pool_idx=pool_idx, relu_mask=relu_mask, gate=gate,
                     method=method, out_relu_mask=out_relu_mask,
                     out_gate=out_gate)
