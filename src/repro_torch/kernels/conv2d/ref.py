"""Plain PyTorch version of the conv kernels (NHWC x HWIO, stride 1, SAME).

On a CUDA tensor the convolutions go through cuDNN, whose f32 default is
TF32.  Every cuDNN call here (the forward, its autograd gradients and the
weight gradient) runs inside :func:`ieee_f32`, so an f32 conv of the port
sums in IEEE f32, as the JAX package's do, whatever the process-wide
flags say.
"""
import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.fixedpoint import requantize


@contextlib.contextmanager
def ieee_f32():
    """cuDNN's f32 convolutions in IEEE f32 (no TF32) inside the block;
    the caller's setting comes back on exit, an exception included.  It
    reads and writes one setting, ``torch.backends.cudnn.conv.
    fp32_precision``, so a caller may use either of PyTorch's TF32 APIs."""
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = before


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW x OIHW, stride 1) whose forward and backward both
    run inside :func:`ieee_f32`: the backward is the same
    ``convolution_backward`` autograd would call, when the caller's
    ``backward()`` runs outside any block of this module."""

    @staticmethod
    def forward(ctx, x, w, pad: int):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        with ieee_f32():
            return F.conv2d(x, w, padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [ctx.pad, ctx.pad], [1, 1], False,
                [0, 0], 1, [need[0], need[1], False])
        return dx, dw, None


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [N, H, W, Cin], w: [K, K, Cin, Cout] (odd K) -> [N, H, W, Cout]."""
    y = _Conv2d.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                      (w.shape[0] - 1) // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_widened(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (or f32) x and w widened to f32, exactly, then the f32 conv:
    the sum the bf16 kernels hold before they round."""
    return conv2d(x.float(), w.float())


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x [N, H, W, Cin] and w [K, K, Cin, Cout] -> bf16 [N, H, W, Cout]:
    the f32 conv of the widened operands, rounded to nearest even once, as
    the JAX package's conv2d_pallas does on bf16 blocks (an f32 dot, then
    ``.astype(bf16)``)."""
    return conv2d_widened(x, w).to(torch.bfloat16)


def conv2d_fxp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int16 x [N, H, W, Cin] (Q7.8) and w [K, K, Cin, Cout] (Q1.14) ->
    int16 [N, H, W, Cout]: the int32 accumulator, requantized once.

    PyTorch has no integer matmul on CUDA, so the accumulator is an im2col
    product in float64.  It is exact on either device: every product is an
    integer below 2^30 and every partial sum one below 2^53, whatever the
    order.  :func:`requantize` then reduces it modulo 2^32, as the int32
    accumulator of the kernels and of the reference wraps.
    """
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    p = (k - 1) // 2
    xp = F.pad(x.to(torch.float64), (0, 0, p, p, p, p))
    patches = torch.cat([xp[:, i:i + h, j:j + wd, :]
                         for i in range(k) for j in range(k)], dim=-1)
    acc = patches.reshape(n * h * wd, k * k * cin) @ w.to(
        torch.float64).reshape(k * k * cin, cout)
    return requantize(acc).reshape(n, h, wd, cout)


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 6: 180-degree kernel flip + in/out channel transpose."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


def conv2d_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of a stride-1 SAME conv == SAME conv of g with flip_transpose(w)."""
    return conv2d(g, flip_transpose(w))


def conv2d_weight_grad(x: torch.Tensor, w: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """dL/dw of a stride-1 SAME conv for the output gradient ``g``: x [N, H,
    W, Cin], g [N, H, W, Cout] -> [K, K, Cin, Cout] (HWIO) of w's type.

    In f32 throughout (bf16 operands widened exactly), rounded once to w's
    type, as the JAX package's ``conv2d_weight_grad`` computes it.
    Training only; on a CUDA tensor cuDNN computes it, in IEEE f32
    (:func:`ieee_f32`).
    """
    with ieee_f32():
        dw = torch.nn.grad.conv2d_weight(
            x.float().permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).shape,
            g.float().permute(0, 3, 1, 2), padding=(w.shape[0] - 1) // 2)
    return dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
