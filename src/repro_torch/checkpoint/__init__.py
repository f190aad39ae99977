"""Atomic, async checkpoints (``repro.checkpoint``), readable by either
package."""
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
