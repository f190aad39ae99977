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
The smooth gates (``act``, ``silu``, ``gelu``) and ``quantize_int8`` come
with the LM stack (ROADMAP A11).
"""
from __future__ import annotations

import torch

from repro_torch.core import masks
from repro_torch.kernels.pool import ref as pool_ref
from repro_torch.kernels.relu_mask import ref as relu_ref

METHODS = ("autodiff", "saliency", "deconvnet", "guided")


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
