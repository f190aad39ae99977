"""Plain PyTorch version of the conv kernel (NHWC x HWIO, stride 1, SAME).

On a CUDA tensor ``F.conv2d`` goes through cuDNN, which runs f32 as TF32
unless ``torch.backends.cudnn.allow_tf32 = False``; whoever compares a
kernel with this version on the card sets that flag first.
"""
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [N, H, W, Cin], w: [K, K, Cin, Cout] (odd K) -> [N, H, W, Cout]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(w.shape[0] - 1) // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 6: 180-degree kernel flip + in/out channel transpose."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


def conv2d_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of a stride-1 SAME conv == SAME conv of g with flip_transpose(w)."""
    return conv2d(g, flip_transpose(w))
