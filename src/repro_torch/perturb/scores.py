"""Fold-and-score driver and heatmap aggregation for the perturbation
explainers, as ``repro.perturb.scores`` has them.

:func:`perturb_scores` builds the N masked variants of each input, folds
them into the leading batch axis (``[N*B, ...]``, as IG folds its steps)
and runs ONE forward pass: no backward, so it runs on the int16 kernels of
``precision="fxp16"`` and on any black-box ``f``.  ``batched=False`` runs
one B-row forward per mask instead (the reference and memory-constrained
path); both score the same masked tensor.

Aggregators turn the per-mask target scores back into input heatmaps:

  * ``occlusion``: coverage-normalized score drop per occluded window;
  * ``lime``: ridge-regularized weighted least squares on the cell bits,
    the fitted coefficients being the cell importances (one batched
    ``torch.linalg.solve`` over the examples' Gram matrices);
  * ``rise``: probability-weighted mask average, normalized by the mask
    mass at each pixel.

``masks=`` takes a :class:`MaskSet` (for example the JAX package's, byte
for byte) or, for :func:`perturb_scores` and :func:`rise`, dense
``[N, H, W]`` / ``[B, N, H, W]`` multipliers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.perturb.masks import (MaskSet, lime_masks, occlusion_masks,
                                       occlusion_positions, rise_masks)

PERTURB_DEFAULTS = {
    "occlusion": dict(window=4, stride=2),
    "lime": dict(n_samples=256, cells=8, sigma=0.25, ridge=1e-3),
    "rise": dict(n_samples=256, grid=7, p=0.5),
}


def n_masks(method: str, hw, **opts) -> int:
    """Fan-out N of a method: the factor the fold multiplies the batch by."""
    merged = {**PERTURB_DEFAULTS[method],
              **{k: v for k, v in opts.items() if v is not None}}
    if method == "occlusion":
        nh, nw = occlusion_positions(
            hw, window=merged["window"],
            stride=merged["stride"] or merged["window"])
        return nh * nw
    return int(merged["n_samples"])


def _logits_of(f, xb):
    out = f(xb)
    if isinstance(out, (tuple, list)):
        out = out[0]    # a pair forward returns (logits, residuals)
    return out


def _dense(masks, device) -> torch.Tensor:
    d = masks.dense() if isinstance(masks, MaskSet) else torch.as_tensor(
        masks, dtype=torch.float32)
    return d.to(device)


def _masked_fold(x, dense, baseline):
    """x blended with the baseline under each mask: ``[N, B, ...]``,
    contiguous (each ``[B, ...]`` slice is a kernel operand as it is)."""
    b = x.shape[0]
    if dense.dim() == 3:    # shared masks [N, H, W] -> per example
        dense = dense[None].expand((b,) + tuple(dense.shape))
    m = dense.transpose(0, 1)                          # [N, B, H, W]
    if x.dim() == 4:
        m = m[..., None]                               # over channels
    xf = x.to(torch.float32)
    bf = (torch.zeros_like(xf) if baseline is None
          else torch.as_tensor(baseline, dtype=torch.float32,
                               device=x.device).expand(x.shape))
    mixed = xf[None] * m + bf[None] * (1.0 - m)
    if not x.dtype.is_floating_point:                  # Q-format inputs
        mixed = torch.round(mixed)
    return mixed.to(x.dtype).contiguous()


@torch.no_grad()
def perturb_scores(f, x, masks, *, baseline=None, target=None,
                   select: str = "logit", batched: bool = True):
    """Score N masked variants of each example in one folded forward.

    ``masks``: a :class:`MaskSet` or dense ``[N, H, W]`` / ``[B, N, H, W]``
    multipliers.  Returns ``(logits [B, C], target [B], scores [N, B]
    float32)``, ``scores`` the target logit (``select="logit"``) or softmax
    probability (``select="prob"``) of each masked variant.
    """
    if select not in ("logit", "prob"):
        raise ValueError(f"select must be 'logit' or 'prob', got {select!r}")
    dense = _dense(masks, x.device)
    b = x.shape[0]
    logits = _logits_of(f, x)
    if target is None:
        tgt = torch.argmax(logits, dim=-1)
    else:
        tgt = torch.as_tensor(target, device=logits.device).to(
            torch.long).expand(b)
    masked = _masked_fold(x, dense, baseline)          # [N, B, ...]
    n = masked.shape[0]
    if batched:
        out = _logits_of(f, masked.reshape((n * b,) + tuple(x.shape[1:])))
        out = out.reshape((n, b) + tuple(out.shape[1:]))
    else:
        out = torch.stack([_logits_of(f, masked[i]) for i in range(n)])
    out = out.to(torch.float32)
    if select == "prob":
        out = torch.softmax(out, dim=-1)
    scores = torch.gather(out, -1, tgt[None, :, None].expand(n, b, 1))[..., 0]
    return logits, tgt, scores


def _upsample_cells(c, hw):
    gh, gw = c.shape[-2:]
    h, w = hw
    return c.repeat_interleave(h // gh, dim=-2).repeat_interleave(
        w // gw, dim=-1)


@torch.no_grad()
def occlusion(f, x, *, window: int = 4, stride: Optional[int] = 2,
              baseline=None, target=None, batched: bool = True,
              masks: Optional[MaskSet] = None):
    """Sliding-window occlusion: heat = coverage-normalized logit drop."""
    hw = tuple(x.shape[1:3])
    ms = masks if masks is not None else occlusion_masks(
        hw, window=window, stride=stride or window, device=x.device)
    logits, tgt, scores = perturb_scores(
        f, x, ms, baseline=baseline, target=target, batched=batched)
    base = torch.gather(logits.to(torch.float32), -1, tgt[:, None])[:, 0]
    drop = base[None, :] - scores                      # [N, B]
    region = 1.0 - ms.dense().to(x.device)             # occluded windows
    heat = torch.einsum("nb,nhw->bhw", drop, region)
    coverage = region.sum(dim=0)                       # windows a pixel
    return logits, heat / torch.clamp_min(coverage, 1.0)[None]


@torch.no_grad()
def lime(f, x, key, *, n_samples: int = 256, cells: int = 8,
         sigma: float = 0.25, ridge: float = 1e-3, baseline=None,
         target=None, batched: bool = True, masks: Optional[MaskSet] = None):
    """LIME-style fit: weighted ridge regression of the target scores on
    the cell bits; each cell's coefficient is its importance.  ``key``: a
    generator, or one per example."""
    hw = tuple(x.shape[1:3])
    b = x.shape[0]
    ms = masks if masks is not None else lime_masks(key, n_samples, hw,
                                                    cells=cells)
    logits, tgt, scores = perturb_scores(
        f, x, ms, baseline=baseline, target=target, batched=batched)
    z = ms.cells().to(device=x.device, dtype=torch.float32)
    n, feat = z.shape[-3], z.shape[-2] * z.shape[-1]
    z = z.reshape(tuple(z.shape[:-2]) + (feat,))
    zb = z[None].expand(b, n, feat) if z.dim() == 2 else z
    y = scores.T                                       # [B, N]
    # proximity kernel: masks keeping more cells are closer to x
    wts = torch.exp(-((1.0 - zb.mean(dim=-1)) ** 2) / (sigma ** 2))
    zw = zb * wts[..., None]
    eye = torch.eye(feat, dtype=torch.float32, device=x.device)
    gram = zw.transpose(1, 2) @ zb + ridge * n * eye
    beta = torch.linalg.solve(gram, zw.transpose(1, 2) @ y[..., None])[..., 0]
    gh = gw = int(round(feat ** 0.5))
    return logits, _upsample_cells(beta.reshape(b, gh, gw), hw)


@torch.no_grad()
def rise(f, x, key, *, n_samples: int = 256, grid: int = 7, p: float = 0.5,
         baseline=None, target=None, batched: bool = True, masks=None):
    """RISE: the masks averaged with the target class probability of each
    masked variant as weights, normalized by the mask mass at each pixel.
    ``key``: a generator, or one per example."""
    hw = tuple(x.shape[1:3])
    ms = masks if masks is not None else rise_masks(key, n_samples, hw,
                                                    grid=grid, p=p)
    dense = _dense(ms, x.device)
    logits, tgt, scores = perturb_scores(
        f, x, dense, baseline=baseline, target=target, select="prob",
        batched=batched)
    if dense.dim() == 3:
        heat = torch.einsum("nb,nhw->bhw", scores, dense)
        mass = dense.sum(dim=0)[None]
    else:
        heat = torch.einsum("nb,bnhw->bhw", scores, dense)
        mass = dense.sum(dim=1)
    return logits, heat / torch.clamp_min(mass, 1e-6)
