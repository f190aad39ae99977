"""Attribution backward rules at nonlinearities (paper §II, Eq. 3-5, Fig. 4),
in plain PyTorch: the reference ops behind ``cnn.apply(..., use_pallas=
False)``, as ``repro.core.rules`` has them.

The three gradient-backprop methods differ ONLY in how the gradient crosses
a rectifier:

  saliency   : R_L = (f > 0) . R_{L+1}             (Eq. 3; 1-bit mask of f)
  deconvnet  : R_L = (R_{L+1} > 0) . R_{L+1}       (Eq. 4; no residual)
  guided     : R_L = (f>0).(R>0) . R_{L+1}         (Eq. 5; 1-bit mask of f)

Each rule is a :class:`torch.autograd.Function` whose only saved tensor is
the bit-packed mask (:mod:`repro_torch.core.masks`), so autograd cannot
keep the activation.  ``method="autodiff"`` is the plain op, for training.
These run the kernels' plain versions on any device and launch no kernel.

Smooth gates (SiLU and GELU; the LM stack) need the pre-activation's
value for their slope, so a 1-bit mask is not enough: the generalisation
keeps the cheapest sufficient residual, a per-row int8 quantization
(``residual="int8"``, :func:`quantize_int8`), and DeconvNet still keeps
none.
"""
from __future__ import annotations

import torch

from repro_torch.core import masks
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.relu_mask import ref as relu_ref

METHODS = ("autodiff", "saliency", "deconvnet", "guided")
RESIDUALS = ("exact", "int8")


# ---------------------------------------------------------------------------
# int8 residual quantization
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, row_max=None):
    """Per-row (last-axis) absmax int8 quantization -> ``(q int8, scale
    f32 [..., 1])``: ``scale = max(absmax / 127, 1e-12)`` in f32 and ``q =
    clip(round(x / scale), ±127)``, rounding half to even as ``jnp.round``
    does.  ``row_max`` maps the local absmax to the whole row's where
    ranks hold slices of the last axis (the max over the model group)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        amax = row_max(amax)
    scale = amax.to(torch.float32) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class _ReluAttr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, method):
        ctx.method = method
        if method != "deconvnet":     # Table II: DeconvNet stores no mask
            ctx.save_for_backward(masks.pack_mask(x > 0))
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.saved_tensors[0] if ctx.saved_tensors else None
        return relu_ref.relu_bwd(packed, g, ctx.method), None


def relu(x: torch.Tensor, method: str = "autodiff") -> torch.Tensor:
    """ReLU whose backward is ``method``'s rule.  ``"autodiff"`` is
    ``torch.relu``, whose gradient at 0 is 0, as ``jax.nn.relu``'s is."""
    if method == "autodiff":
        return torch.relu(x)
    if method not in METHODS:
        raise ValueError(f"unknown attribution method {method!r}")
    return _ReluAttr.apply(x, method)


def _pool_windows(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> [N, H/2, W/2, C, 4] window view (2x2, stride 2)."""
    n, h, w, c = x.shape
    xw = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return xw.reshape(n, h // 2, w // 2, c, 4)


class _MaxPoolAttr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, packed = pool_ref.maxpool_fwd(x)   # first maximum wins
        ctx.save_for_backward(packed)
        return y

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        return pool_ref.unpool_bwd(packed, g)


def maxpool2x2(x: torch.Tensor, method: str = "autodiff") -> torch.Tensor:
    """2x2/2 max-pool.  The rule sets route the gradient to the stored
    2-bit argmax (Fig. 5b); ``"autodiff"`` is ``torch.amax`` over the
    window, which splits a tie evenly, as ``jnp.max`` does."""
    if method == "autodiff":
        return torch.amax(_pool_windows(x), dim=-1)
    return _MaxPoolAttr.apply(x)


# ---------------------------------------------------------------------------
# Smooth gates (SiLU / GELU) with int8 residuals
# ---------------------------------------------------------------------------


def _sigmoid(x):
    """``1 / (1 + exp(-x))``, each operation rounded to ``x``'s dtype, as
    ``jax.nn.sigmoid`` lowers (``torch.sigmoid`` rounds once, and differs
    from it in a third of bf16 values)."""
    return 1 / (1 + torch.exp(-x))


def _gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``, operation by operation."""
    c = 0.7978845608028654  # sqrt(2/pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


#: Forward of each smooth gate, as the JAX package computes it.
_FWD = {
    "silu": lambda x: x * _sigmoid(x),
    "gelu": _gelu_tanh,
}


def _derivative(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The gate's slope at ``x`` (f32), in ``repro.core.rules``' closed
    forms."""
    if kind == "silu":
        s = _sigmoid(x)
        return s * (1 + x * (1 - s))
    if kind == "gelu":
        c = 0.7978845608028654  # sqrt(2/pi)
        t = torch.tanh(c * (x + 0.044715 * x ** 3))
        return (0.5 * (1 + t)
                + 0.5 * x * (1 - t ** 2) * c * (1 + 3 * 0.044715 * x ** 2))
    raise ValueError(kind)


class _SmoothAttr(torch.autograd.Function):
    """A smooth gate whose backward is the method's rule.  Saves the int8
    residual (``residual="int8"``), the input (``"exact"``) or nothing
    (deconvnet) — never ``x`` under int8.

    Under saliency and guided the slope is evaluated at the DEQUANTIZED
    residual, not at ``x``, so this is not autograd's gradient of the gate.
    """

    @staticmethod
    def forward(ctx, x, kind, method, residual, row_max):
        ctx.kind, ctx.method, ctx.residual = kind, method, residual
        if method == "deconvnet":
            pass                        # gradient-side rule: no residual
        elif residual == "int8":
            ctx.save_for_backward(*quantize_int8(x, row_max))
        else:
            ctx.save_for_backward(x)
        return _FWD[kind](x)

    @staticmethod
    def backward(ctx, g):
        if ctx.method == "deconvnet":   # generalised Eq. 4
            return torch.where(g > 0, g, 0).to(g.dtype), None, None, \
                None, None
        if ctx.residual == "int8":
            x = dequantize_int8(*ctx.saved_tensors, torch.float32)
        else:
            x = ctx.saved_tensors[0].to(torch.float32)
        r = g.to(torch.float32) * _derivative(ctx.kind, x)
        if ctx.method == "guided":      # generalised Eq. 5
            r = torch.where(g > 0, r, 0)
        return r.to(g.dtype), None, None, None, None


def act(x: torch.Tensor, kind: str, method: str = "autodiff",
        residual: str = "int8", row_max=None) -> torch.Tensor:
    """Attribution-aware nonlinearity used by every model of the zoo.
    ``row_max``: see :func:`quantize_int8` (the int8 residual's row scale
    over a last axis that ranks split)."""
    if kind == "relu":
        return relu(x, method)
    if method == "autodiff":
        return _FWD[kind](x)
    if method not in METHODS:
        raise ValueError(f"unknown attribution method {method!r}")
    if residual not in RESIDUALS:
        raise ValueError(f"unknown residual policy {residual!r}")
    return _SmoothAttr.apply(x, kind, method, residual, row_max)


def silu(x, method="autodiff", residual="int8"):
    return act(x, "silu", method, residual)


def gelu(x, method="autodiff", residual="int8"):
    return act(x, "gelu", method, residual)
