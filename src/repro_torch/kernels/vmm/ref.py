"""Plain PyTorch version of the FC matmul kernel (paper §III.C).

On a CUDA tensor ``torch.matmul`` is full f32 only with
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default);
whoever compares a kernel with this version on the card keeps it so.
"""
import torch


def vmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] -> [M, N], f32 accumulation."""
    return torch.matmul(x, w)


def vmm_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """BP of FC w.r.t. its input: the transposed VMM (paper §III.E)."""
    return torch.matmul(g, w.T)
