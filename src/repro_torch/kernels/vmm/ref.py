"""Plain PyTorch version of the FC matmul kernel (paper §III.C).

On a CUDA tensor ``torch.matmul`` is full f32 only with
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default);
whoever compares a kernel with this version on the card keeps it so.
"""
import torch

from repro_torch.core.fixedpoint import requantize


def vmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] -> [M, N], f32 accumulation."""
    return torch.matmul(x, w)


def vmm_widened(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 (or f32) operands widened to f32, exactly, then the f32
    product: the sum the bf16 kernels hold before they round."""
    return torch.matmul(x.float(), w.float())


def vmm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 [..., M, K] @ bf16 [K, N] -> bf16 [..., M, N]: the f32 product
    of the widened operands, rounded to nearest even once, as the JAX
    package's vmm_pallas does on bf16 blocks (an f32 accumulator, then
    ``.astype(bf16)``)."""
    return vmm_widened(x, w).to(torch.bfloat16)


def vmm_weight_grad(x: torch.Tensor, g: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """dL/dw of ``x @ w`` for the output gradient ``g``: ``x^T g`` [K, N],
    an f32 sum of the widened operands rounded once to ``dtype`` (w's), as
    the JAX package's ``einsum(..., preferred_element_type=f32)
    .astype(w.dtype)``."""
    return vmm_widened(x.T, g).to(dtype)


def vmm_fxp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int16 [..., M, K] (Q7.8) @ int16 [K, N] (Q1.14) -> int16 [..., M, N]:
    the int32 accumulator, requantized once.

    The product runs in float64, exact on either device (integer partial
    sums below 2^53); :func:`requantize` reduces it modulo 2^32 as the
    int32 accumulator wraps.
    """
    return requantize(torch.matmul(x.to(torch.float64), w.to(torch.float64)))


def vmm_input_grad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """BP of FC w.r.t. its input: the transposed VMM (paper §III.E)."""
    return torch.matmul(g, w.T)
