"""Plain PyTorch version of the fused ReLU + 1-bit-mask kernel (§III.D)."""
import torch

from repro_torch.core import masks


def relu_fwd(x: torch.Tensor):
    """Returns (relu(x), packed 1-bit mask of ``x > 0`` along the last axis)."""
    return torch.clamp_min(x, 0), masks.pack_mask(x > 0)


def relu_bwd(packed: torch.Tensor, g: torch.Tensor,
             method: str) -> torch.Tensor:
    """The three masked BP dataflows of paper Fig. 4 (b)-(d)."""
    if method == "deconvnet":
        return torch.where(g > 0, g, 0)
    m = masks.unpack_mask(packed, g.shape[-1])
    if method == "guided":
        return torch.where(m & (g > 0), g, 0)
    return torch.where(m, g, 0)     # saliency
