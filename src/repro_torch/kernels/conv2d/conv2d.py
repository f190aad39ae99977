"""Convolution kernels (paper §III.B, Fig. 4-6): forward and fused backward.

:func:`conv2d` wraps ``repro_conv2d_fwd`` of ``csrc/conv2d.cu`` (the port of
``repro.kernels.conv2d.conv2d.conv2d_pallas``), with the conv bias added in
its epilogue.  :func:`conv2d_bwd_fused` wraps ``repro_conv2d_bwd_fused`` (the
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

from typing import Callable, Optional

import torch

from repro_torch.core import masks
from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_kernel_operands, on_card,
                                 validate_bp_gates)
from repro_torch.kernels.conv2d import ref
from repro_torch.kernels.pool.ref import unpool_scatter
from repro_torch.kernels.relu_mask.relu_mask import gate_gradient, unpack_bits
from repro_torch.kernels.tiling import crumb_bytes, mask_bytes


def _check_kernel(name, w, cin, dtype):
    if (w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[0] % 2 == 0
            or w.shape[2] != cin):
        raise ValueError(f"{name}: kernel must be [K, K, {cin}, Cout] with "
                         f"odd K, got {tuple(w.shape)}")
    check(name, w, dtype, what="kernel")


def conv_fwd(name: str, counter: str, entry: str, dtype: torch.dtype,
             plain: Callable, x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    """Check, then run ``plain(x, w, b)`` on the CPU or launch ``entry``."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [N, H, W, Cin], got "
                         f"{tuple(x.shape)}")
    n, h, wd, cin = x.shape
    check(name, x, dtype, what="x")
    _check_kernel(name, w, cin, dtype)
    k, cout = w.shape[0], w.shape[3]
    if b is not None:
        check(name, b, dtype, (cout,), what="b")
    if not on_card(name, x, w, b):
        return plain(x, w, b)
    check_kernel_operands(name, x, w, b)
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch(counter, entry, x.device, x.data_ptr(), w.data_ptr(),
                      _build.ptr(b), y.data_ptr(), n, h, wd, cin, cout, k)
    return y


def _conv2d_plain(x, w, b):
    y = ref.conv2d(x, w)
    return y if b is None else y + b


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, H, W, Cin] x [K, K, Cin, Cout] (+ b [Cout]) -> [N, H, W, Cout],
    stride 1, SAME padding, f32 accumulation.

    CPU tensors run :func:`ref.conv2d` (then ``+ b``); CUDA tensors the
    kernel.
    """
    return conv_fwd("conv2d", "conv2d_fwd", "repro_conv2d_fwd",
                    torch.float32, _conv2d_plain, x, w, b)


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
