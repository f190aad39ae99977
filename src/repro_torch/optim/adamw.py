"""AdamW + schedules on parameter trees, as ``repro.optim.adamw`` has them.

A tree is a tensor or a dict / list / tuple of trees (the CNN's
``{"conv": [{"w", "b"}], "fc": [...]}``).  Updates are functional: new
parameter and moment trees are returned, nothing is changed in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor         # scalar int32
    mu: Any                    # tree like params, f32
    nu: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return AdamWState(step=step, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """Returns ``(new_params, new_state)``.  ``lr`` may be a scalar tensor.
    Weight decay (decoupled) applies to tensors with ndim >= 2 only."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                          leaves(state.nu), leaves(params)):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        wd = weight_decay if p.dim() >= 2 else 0.0
        p32 = p.to(torch.float32)
        new_p.append((p32 - lr * (delta + wd * p32)).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (unflatten(params, new_p),
            AdamWState(step=step, mu=unflatten(params, new_m),
                       nu=unflatten(params, new_v)))


def clip_by_global_norm(grads, max_norm: float, gnorm=None):
    """Returns ``(clipped_grads, global_norm)``; ``gnorm``: the global
    norm where the caller has it (of gradients split over ranks), else
    that of ``grads``."""
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                grads), gnorm


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    min_ratio=0.1):
    """Linear warmup -> cosine decay to ``min_ratio * peak_lr``."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * t / max(1.0, warmup_steps)
    prog = torch.clamp((t - warmup_steps) / max(1.0, total_steps
                                                - warmup_steps), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup_steps, warm, cos)
