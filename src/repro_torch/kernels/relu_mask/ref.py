"""Plain PyTorch version of the fused ReLU + 1-bit-mask kernel (§III.D)."""
import torch

from repro_torch.core import masks


def relu_fwd(x: torch.Tensor):
    """Returns (relu(x), packed 1-bit mask of ``x > 0`` along the last axis).

    ``x > 0 ? x : 0``: -0.0 maps to +0.0, as ``jnp.maximum(x, 0)`` and the
    kernel give it (``torch.clamp_min`` keeps the sign of -0.0).
    """
    gt = x > 0
    return torch.where(gt, x, 0), masks.pack_mask(gt)


def relu_bwd(packed: torch.Tensor, g: torch.Tensor,
             method: str) -> torch.Tensor:
    """The three masked BP dataflows of paper Fig. 4 (b)-(d)."""
    if method == "deconvnet":
        return torch.where(g > 0, g, 0)
    m = masks.unpack_mask(packed, g.shape[-1])
    if method == "guided":
        return torch.where(m & (g > 0), g, 0)
    return torch.where(m, g, 0)     # saliency
