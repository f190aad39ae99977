"""Synthetic data pipelines (``repro.data``): pure functions of
``(seed, step, host_id)``."""
from repro_torch.data.synthetic import (CifarLikeImages, TokenStream,
                                        host_shard_bounds)

__all__ = ["CifarLikeImages", "TokenStream", "host_shard_bounds"]
