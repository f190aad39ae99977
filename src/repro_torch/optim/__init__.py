"""Optimizers of the port (``repro.optim``): AdamW and its schedules."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule"]
