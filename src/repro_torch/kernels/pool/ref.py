"""Plain PyTorch version of the 2x2 max-pool / unpool kernels (Fig. 5), and
of the pool fused with the ReLU + mask before it."""
import torch

from repro_torch.core import masks
from repro_torch.kernels.relu_mask import ref as relu_ref

#: Window candidate order; the first maximum wins (``jnp.argmax``).
OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _candidates(x: torch.Tensor):
    return [x[:, di::2, dj::2, :] for di, dj in OFFSETS]


def maxpool_fwd(x: torch.Tensor):
    """NHWC -> (pooled, 2-bit packed argmax indices along C).

    The argmax scans the candidates in :data:`OFFSETS` order and replaces
    only on a strictly greater value, so ties (all-zero post-ReLU windows)
    go to the first candidate, as ``jnp.argmax`` does.
    """
    cands = _candidates(x)
    best = cands[0]
    idx = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for k, c in enumerate(cands[1:], start=1):
        gt = c > best
        best = torch.where(gt, c, best)
        idx = torch.where(gt, k, idx)
    return best, masks.pack_crumbs(idx)


def relu_pool_fwd(x: torch.Tensor, mask: bool = True):
    """NHWC -> (pooled ReLU, 1-bit mask [N, H, W, ceil(C/8)] or None, 2-bit
    packed argmax): the two plain versions composed."""
    n, h, w, c = x.shape
    y, m = relu_ref.relu_fwd(x.reshape(-1, c))
    pooled, idx = maxpool_fwd(y.reshape(x.shape))
    return pooled, (m.reshape(n, h, w, -1) if mask else None), idx


def unpool_scatter(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Route pooled grads [..., H/2, W/2, C] -> [..., H, W, C] (Fig. 5b).

    ``idx`` ([..., H/2, W/2, C], values 0..3) broadcasts against ``g``'s
    leading axes — seed-batched gradients share one stored index map.
    """
    hp, wp, c = g.shape[-3:]
    out = torch.zeros(g.shape[:-3] + (2 * hp, 2 * wp, c), dtype=g.dtype,
                      device=g.device)
    for k, (di, dj) in enumerate(OFFSETS):
        out[..., di::2, dj::2, :] = torch.where(idx == k, g, 0)
    return out


def unpool_bwd(packed: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Route the pooled gradient to the stored argmax position (Fig. 5b)."""
    return unpool_scatter(masks.unpack_crumbs(packed, g.shape[-1]), g)
