"""Attribution-aware ReLU on the kernels: the standalone op of the unfused
path (``cnn.apply(..., use_pallas=True, fused=False)``).

Each rule set is a :class:`torch.autograd.Function` whose forward is the
ReLU+mask kernel (B2) and whose only saved tensor is the 1-bit packed mask
(none for deconvnet, Table II); its backward is the gate kernel (B11).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd


class _ReluAttr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, method):
        c = x.shape[-1]
        y, packed = relu_fwd(x.reshape(-1, c).contiguous())
        ctx.method = method
        if method != "deconvnet":           # Table II: no mask for Eq. 4
            ctx.save_for_backward(packed)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        packed = ctx.saved_tensors[0] if ctx.saved_tensors else None
        # the incoming gradient may be a strided or expanded view
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        return relu_bwd(packed, g2, ctx.method).reshape(g.shape), None


def relu(x: torch.Tensor, method: str = "autodiff") -> torch.Tensor:
    """``max(x, 0)`` whose backward is ``method``'s rule (Eq. 3-5).

    ``"autodiff"`` is ``torch.maximum(x, 0)``: its gradient at x = 0 is 0.5,
    as ``jnp.maximum``'s is (``clamp_min`` would give 1, ``relu`` 0).
    """
    if method == "autodiff":
        return torch.maximum(x, x.new_zeros(()))
    return _ReluAttr.apply(x, method)
