"""Seed batching for the explainers that draw masks or noise per example,
as ``repro.perturb.keys`` batches PRNG keys.

A torch generator cannot replay a JAX key, so the port's keys are int seeds
or :class:`torch.Generator` objects.  A single key (one seed, one
generator) draws one mask set shared by the batch; a sequence of B keys
draws one set per example, which is how the serve layer folds per-request
seeds along the batch so stochastic requests co-batch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

Key = Union[int, torch.Generator]


def key_batch_size(key) -> Optional[int]:
    """None for one seed or one generator, B for a sequence of B keys."""
    if isinstance(key, torch.Generator):
        return None
    if isinstance(key, torch.Tensor):
        if key.dim() > 1:
            raise ValueError(f"a seed tensor must be rank <= 1, got "
                             f"{tuple(key.shape)}")
        return None if key.dim() == 0 else int(key.shape[0])
    if isinstance(key, (list, tuple)):
        return len(key)
    if np.ndim(key) == 0:
        return None
    if np.ndim(key) == 1:
        return len(key)
    raise ValueError(f"a key is a seed, a generator or a sequence of them, "
                     f"got {type(key).__name__} of rank {np.ndim(key)}")


def _copy(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def pad_keys(key: Sequence[Key], n: int) -> List[Key]:
    """A batch of keys padded to ``n`` rows: the pad rows draw under the
    first key (a generator is copied, so row 0's draws do not move), as the
    JAX package pads a key stack with its first key."""
    key = list(key)
    first = key[0]
    return key + [_copy(first) if isinstance(first, torch.Generator)
                  else first for _ in range(n - len(key))]


def generators(key, device) -> Union[torch.Generator, List[torch.Generator]]:
    """Keys -> generators on ``device``: one seed gives one generator, a
    sequence of seeds one generator per example; generators pass through
    (they draw on their own device)."""
    dev = torch.device(device)

    def gen(k) -> torch.Generator:
        if isinstance(k, torch.Generator):
            return k
        return torch.Generator(device=dev).manual_seed(int(k))

    if key_batch_size(key) is None:
        return gen(key)
    return [gen(k) for k in key]
