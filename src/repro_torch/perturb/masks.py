"""Perturbation masks, drawn on the device and bit-packed like residuals, as
``repro.perturb.masks`` has them.

The binary pattern behind every mask family lives bit-packed in a
:class:`MaskSet` through :func:`repro_torch.core.masks.pack_mask` (8 cells
a byte, least significant bit first, the residuals' layout: a ``MaskSet``
moves between the two packages byte for byte) and is densified to float
``[N, H, W]`` multipliers on demand.

The stochastic generators draw from a :class:`torch.Generator` on the
generator's device: a single generator yields one mask set, a sequence of
generators one set per example (a leading B axis), which is how the serve
layer folds per-request seeds (:mod:`repro_torch.perturb.keys`).  A
generator does not replay a JAX key, so the draws are the reference's in
distribution, not in value; occlusion is deterministic and equal byte for
byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.masks import pack_mask, unpack_mask

Generators = Union[torch.Generator, Sequence[torch.Generator]]


@dataclass(frozen=True)
class MaskSet:
    """N binary perturbation patterns, bit-packed on a coarse cell grid.

    ``packed``: uint8 ``[..., N, ceil(n_cells/8)]``, leading dims (if any)
    per example.  ``grid`` is the coarse pattern shape ``(gh, gw)`` with
    ``n_cells = gh * gw``; ``hw`` is the dense image shape.  ``shifts``
    (RISE only) holds each mask's sub-cell crop offset, int32
    ``[..., N, 2]``.
    """

    kind: str
    packed: torch.Tensor
    n_cells: int
    grid: Tuple[int, int]
    hw: Tuple[int, int]
    shifts: Optional[torch.Tensor] = None

    @property
    def n_masks(self) -> int:
        return int(self.packed.shape[-2])

    @property
    def nbytes(self) -> int:
        total = self.packed.numel()
        if self.shifts is not None:
            total += self.shifts.numel() * self.shifts.element_size()
        return int(total)

    def cells(self) -> torch.Tensor:
        """Unpacked boolean cell grid, ``[..., N, gh, gw]``."""
        bits = unpack_mask(self.packed, self.n_cells)
        return bits.reshape(tuple(bits.shape[:-1]) + tuple(self.grid))

    def dense(self) -> torch.Tensor:
        """Dense float32 multipliers in [0, 1], ``[..., N, H, W]``: 1 keeps
        the pixel, 0 replaces it by the baseline; RISE masks are fractional
        at cell boundaries."""
        gh, gw = self.grid
        h, w = self.hw
        c = self.cells().to(torch.float32)
        if self.kind == "occlusion":
            return c
        if self.kind == "lime":
            return c.repeat_interleave(h // gh, dim=-2).repeat_interleave(
                w // gw, dim=-1)
        if self.kind == "rise":
            return _rise_dense(c, self.shifts, self.hw)
        raise ValueError(f"unknown mask kind: {self.kind!r}")


def _triangle_weights(m: int, n: int, device) -> torch.Tensor:
    """``[m, n]`` weights of a bilinear upsample from ``m`` to ``n``
    samples: ``jax.image.scale_and_translate``'s triangle kernel at scale
    ``n / m``, normalized per output sample, in float32 as it computes
    them."""
    inv = torch.tensor(1.0 / (n / m), dtype=torch.float32, device=device)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    wts = torch.clamp_min(1.0 - x, 0.0)
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _rise_dense(c: torch.Tensor, shifts: torch.Tensor, hw) -> torch.Tensor:
    """RISE cells ``[..., N, g, g]`` upsampled bilinearly to ``(g+1)`` cells
    of ``ceil(H/g)`` pixels, then each mask cropped to ``hw`` at its shift.

    The upsample is the reference's ``jax.image.resize(..., "bilinear")``
    as the product of per-axis weight matrices; the sums run in another
    order, so values may differ from the reference's in the last bit
    (within 2.4e-7 on the grids the tests draw)."""
    gh, gw = c.shape[-2:]
    h, w = hw
    ch, cw = -(-h // gh), -(-w // gw)
    wy = _triangle_weights(gh, (gh + 1) * ch, c.device)
    wx = _triangle_weights(gw, (gw + 1) * cw, c.device)
    lead = tuple(c.shape[:-2])
    flat = c.reshape((-1, gh, gw))
    up = torch.einsum("nij,jb->nib", torch.einsum("nij,ia->naj", flat, wy),
                      wx)
    sh = shifts.reshape((-1, 2)).to(device=c.device, dtype=torch.long)
    rows = sh[:, 0:1] + torch.arange(h, device=c.device)       # [M, h]
    cols = sh[:, 1:2] + torch.arange(w, device=c.device)       # [M, w]
    m = torch.arange(flat.shape[0], device=c.device)
    out = up[m[:, None, None], rows[:, :, None], cols[:, None, :]]
    return out.reshape(lead + (h, w))


def occlusion_positions(hw, *, window: int, stride: int) -> Tuple[int, int]:
    """Sliding-window grid shape ``(nh, nw)`` for occlusion over ``hw``."""
    h, w = hw
    if window > h or window > w:
        raise ValueError(f"window {window} exceeds input {tuple(hw)}")
    return ((h - window) // stride + 1, (w - window) // stride + 1)


def occlusion_masks(hw, *, window: int = 4, stride: Optional[int] = None,
                    device="cpu") -> MaskSet:
    """Deterministic sliding-window masks on ``device``: mask i zeroes one
    window."""
    stride = window if stride is None else stride
    h, w = hw
    nh, nw = occlusion_positions(hw, window=window, stride=stride)
    ys = torch.arange(nh, device=device) * stride
    xs = torch.arange(nw, device=device) * stride
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    in_y = (rows[None, :] >= ys[:, None]) & (rows[None, :] < ys[:, None]
                                              + window)
    in_x = (cols[None, :] >= xs[:, None]) & (cols[None, :] < xs[:, None]
                                              + window)
    occluded = in_y[:, None, :, None] & in_x[None, :, None, :]  # [nh,nw,H,W]
    keep = ~occluded.reshape(nh * nw, h * w)
    return MaskSet(kind="occlusion", packed=pack_mask(keep), n_cells=h * w,
                   grid=(h, w), hw=(h, w))


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _per_example(gen: Generators, one) -> MaskSet:
    """``one(generator)`` for a single generator, or stacked along a new
    leading axis for a sequence of them."""
    if isinstance(gen, torch.Generator):
        return one(gen)
    sets = [one(g) for g in gen]
    shifts = (None if sets[0].shifts is None
              else torch.stack([s.shifts for s in sets]))
    first = sets[0]
    return MaskSet(kind=first.kind,
                   packed=torch.stack([s.packed for s in sets]),
                   n_cells=first.n_cells, grid=first.grid, hw=first.hw,
                   shifts=shifts)


def lime_masks(gen: Generators, n_samples: int, hw, *,
               cells: int = 8) -> MaskSet:
    """LIME-style superpixel masks: Bernoulli(1/2) on a ``cells x cells``
    grid (a regular grid as the superpixels), each mask keeping or
    dropping whole cells.  ``hw`` must be divisible by ``cells``.  A
    sequence of generators yields per-example mask sets."""
    h, w = hw
    if h % cells or w % cells:
        raise ValueError(f"hw {tuple(hw)} not divisible by cells={cells}")

    def one(g):
        bits = _bernoulli(g, 0.5, (n_samples, cells * cells))
        return MaskSet(kind="lime", packed=pack_mask(bits),
                       n_cells=cells * cells, grid=(cells, cells),
                       hw=(h, w))

    return _per_example(gen, one)


def rise_masks(gen: Generators, n_samples: int, hw, *, grid: int = 7,
               p: float = 0.5) -> MaskSet:
    """RISE masks (Petsiuk et al. 2018): Bernoulli(p) on a ``grid x grid``
    lattice, upsampled bilinearly past the image size and cropped at a
    random sub-cell shift.  A sequence of generators yields per-example
    mask sets."""
    h, w = hw
    ch, cw = -(-h // grid), -(-w // grid)

    def one(g):
        bits = _bernoulli(g, p, (n_samples, grid * grid))
        sy = torch.randint(0, ch, (n_samples, 1), generator=g,
                           device=g.device)
        sx = torch.randint(0, cw, (n_samples, 1), generator=g,
                           device=g.device)
        return MaskSet(kind="rise", packed=pack_mask(bits),
                       n_cells=grid * grid, grid=(grid, grid), hw=(h, w),
                       shifts=torch.cat([sy, sx], dim=-1).to(torch.int32))

    return _per_example(gen, one)
