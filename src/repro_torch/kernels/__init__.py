"""Hand-written CUDA kernels for the paper's hot spots, beside their plain
PyTorch versions.

Each family lives in its own subpackage, as in ``repro.kernels``:
``ref.py`` holds the plain version of the math, the module named after the
family holds the kernel wrapper(s) and the plain twin of each fused kernel.
The CUDA sources are in ``repro_torch/csrc/`` (one per family) and are
built into one shared library at first use (:mod:`._build`).

Dispatch is by the tensor's device, never by a flag: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises.  There is no
fallback from a kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (ENTRY_LAUNCHES, LAUNCHES,
                                       reset_launches)

METHOD_CODES = {"saliency": 0, "deconvnet": 1, "guided": 2}

__all__ = ["ENTRY_LAUNCHES", "LAUNCHES", "METHOD_CODES", "on_card",
           "reset_launches", "validate_bp_gates"]


def validate_bp_gates(method: str, gate, relu_mask, out_gate, out_relu_mask):
    """Shared argument contract of the fused-BP wrappers.

    ``gate``/``out_gate`` default to mask presence; forcing a gate with no
    stored mask is only valid for the deconvnet rule (Eq. 4 reads just the
    gradient sign — Table II stores no mask for it).  Returns the resolved
    ``(gate, out_gate)`` pair.
    """
    if method not in METHOD_CODES:
        raise ValueError(f"method={method!r} not in {tuple(METHOD_CODES)}")
    if gate is None:
        gate = relu_mask is not None
    if out_gate is None:
        out_gate = out_relu_mask is not None
    if gate and relu_mask is None and method != "deconvnet":
        raise ValueError(
            f"gate=True without relu_mask is only valid for "
            f"method='deconvnet' (Eq. 4 reads just the gradient sign); "
            f"method={method!r} needs the stored 1-bit mask")
    if out_gate and out_relu_mask is None and method != "deconvnet":
        raise ValueError(
            f"out_gate=True without out_relu_mask is only valid for "
            f"method='deconvnet'; method={method!r} needs the stored mask")
    return gate, out_gate


def on_card(name: str, *tensors) -> bool:
    """Route a wrapper call: False for CPU tensors (plain version), True for
    CUDA tensors (kernel).  Mixed devices or any other device raise."""
    devs = {t.device for t in tensors if t is not None}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return True
    raise ValueError(f"{name}: tensors must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(map(str, devs))}")


def check_kernel_operands(name: str, *tensors) -> None:
    """Raise unless every operand is contiguous and small enough for the
    kernels' 32-bit element indices."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel operands must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} elements exceed the "
                             f"kernels' 32-bit indexing")


def check_image_operand(name: str, x: torch.Tensor) -> None:
    """Raise unless the batched operand ``x`` [N, ...] is contiguous and
    one image of it fits the 32-bit element indices: for the kernels that
    offset each image by a 64-bit product and index within it in 32 bits,
    whatever N (the conv forwards, which also launch the batch in chunks
    of at most ``conv2d.CONV_BATCH_CHUNK`` images)."""
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel operands must be contiguous")
    per_image = x[0].numel() if x.shape[0] else 0
    if per_image >= 2 ** 31:
        raise ValueError(f"{name}: {per_image} elements an image exceed the "
                         f"kernels' 32-bit indexing")


def check(name: str, t: torch.Tensor, dtype, shape=None,
          what: str = "tensor"):
    """Raise unless ``t`` has ``dtype`` (one dtype, or a tuple of the ones
    accepted) and ``shape`` where given."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        want = " or ".join(map(str, dtypes))
        raise TypeError(f"{name}: {what} must be {want}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
