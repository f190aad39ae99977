"""16-bit fixed-point arithmetic (paper §IV), true-int16 half, in PyTorch.

The numeric contract of the int16 kernels (``kernels/*/fxp.py``), as
``repro.core.fixedpoint`` defines it:

* activations, gradients and biases on the Q7.8 grid (``ACT_FRAC``), weights
  on the Q1.14 grid (``WGT_FRAC``), all int16;
* products accumulate in int32, wrapping modulo 2^32 as XLA and NumPy do;
* one requantization narrows the accumulator back to int16:
  ``clip((acc + 2^(s-1)) >> s, ±INT16_LIM)``, an int32 add that wraps and an
  arithmetic shift;
* saturation is symmetric at ±(2^15 - 1): -2^15 is never produced;
* backward seeds are pre-scaled by ``SEED_GAIN`` (a power of two), divided
  back out exactly at the end.

The fake-quantizer half of the reference module (``make_quantizer``,
``fxp16``, ``quantize_tree``) is not on the port's path yet (ROADMAP A6c).
"""
from __future__ import annotations

import torch

ACT_FRAC = 8          # Q7.8 activations / gradients / biases
WGT_FRAC = 14         # Q1.14 weights
SEED_GAIN_BITS = 6    # backward seed pre-scale: 2^6 (removed exactly at the end)
SEED_GAIN = float(1 << SEED_GAIN_BITS)
INT16_LIM = (1 << 15) - 1          # symmetric saturation, grid units


def to_fixed(x: torch.Tensor, frac_bits: int = ACT_FRAC) -> torch.Tensor:
    """f32 -> int16 on the Q(15-n).n grid, round half to even, saturated."""
    g = torch.round(x.to(torch.float32) * (1 << frac_bits))
    return torch.clamp(g, -INT16_LIM, INT16_LIM).to(torch.int16)


def from_fixed(q: torch.Tensor, frac_bits: int = ACT_FRAC) -> torch.Tensor:
    """int16 grid values -> f32 (exact: every grid point is an f32)."""
    return q.to(torch.float32) / (1 << frac_bits)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Integers held in int64 -> their int32 two's-complement value (int64)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def requantize(acc: torch.Tensor, shift: int = WGT_FRAC) -> torch.Tensor:
    """Integer accumulator -> int16: ``clip((acc + 2^(shift-1)) >> shift)``.

    ``acc`` may hold the exact sum in int64 (or float64, see the plain
    versions of the fxp kernels): it is first reduced modulo 2^32 to the
    int32 accumulator the kernels keep, and the rounding add wraps there
    too, so the result is the reference's int32 arithmetic bit for bit.
    """
    a = _wrap_int32(acc.to(torch.int64))
    v = _wrap_int32(a + (1 << (shift - 1))) >> shift       # arithmetic shift
    return torch.clamp(v, -INT16_LIM, INT16_LIM).to(torch.int16)


def sat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating int16 add (bias adds): widen to int32, clip, narrow."""
    s = a.to(torch.int32) + b.to(torch.int32)
    return torch.clamp(s, -INT16_LIM, INT16_LIM).to(torch.int16)


def quantize_params_int(params) -> dict:
    """f32 params tree -> int16: weights Q1.14, biases Q7.8.

    ``params`` is ``{"conv": [{"w", "b"}], "fc": [{"w", "b"}]}``; any leaf
    not named ``w`` or ``b`` raises, since defaulting it to either format
    would be a silent 2^6 scale error in the int16 model.
    """
    out = {}
    for group, layers in params.items():
        out[group] = []
        for layer in layers:
            q = {}
            for name, v in layer.items():
                if name not in ("w", "b"):
                    raise ValueError(
                        f"quantize_params_int expects 'w'/'b' leaves, got "
                        f"{group}[{len(out[group])}][{name!r}]")
                q[name] = to_fixed(v, WGT_FRAC if name == "w" else ACT_FRAC)
            out[group].append(q)
    return out
