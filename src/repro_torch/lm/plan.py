"""LM-side planning surface: the SSM scan's launch knobs.

One import for the planning pieces LM consumers use (``repro.lm.plan``):

  * :func:`repro_torch.plan.plan_lm` — a ``ScanTile(d_tile, chunk)`` per
    mamba / hybrid segment that fits the device profile
    (``InfeasiblePlanError`` when nothing does); on the card the rule's
    ``(d_inner, ssm_chunk)``, or with ``autotune=True`` the fastest
    measured;
  * :func:`repro_torch.plan.lm_plan_footprints` — the audited footprints
    of a plan (or of the unplanned whole-D launch, ``plan=None``);
  * :func:`repro_torch.launch.steps.ssm_scan_tiles` — a plan's entries as
    the per-segment launch knobs the model stack consumes.
"""
from repro_torch.launch.steps import ssm_scan_tiles
from repro_torch.plan import (LM_PLAN_SEQ, InfeasiblePlanError, ScanTile,
                              lm_kernel_shapes, lm_plan_footprints, plan_lm)

__all__ = [
    "InfeasiblePlanError", "LM_PLAN_SEQ", "ScanTile", "lm_kernel_shapes",
    "lm_plan_footprints", "plan_lm", "ssm_scan_tiles",
]
