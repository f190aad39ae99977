"""repro_torch.plan — the tile planner and autotuner (``repro.plan``).

The paper's resource-aware tiling (configurable tiles that use the
on-chip resources as far as the target allows) as a subsystem:

  * :mod:`.profiles` — :class:`DeviceProfile` envelopes: the JAX package's
    analytic TPU / edge profiles, and ``h100``, the card read at run time;
  * :mod:`.model` — the footprint / cost model per kernel family: the JAX
    package's TPU formulas, and the card's (shared memory a block,
    compulsory bytes, operations, the grid's fill);
  * :mod:`.planner` — enumerate, reject over-budget, rank, optionally
    measure (``autotune=True``), returning a :class:`TilePlan`: TPU tiles
    (audits on the card) or the CUDA kernels' own launch objects;
  * :mod:`.cache` — the persistent JSON tuning cache;
  * :mod:`.drift` — measured kernel times against the cost model.

Plans thread through ``EngineSpec(device=..., plan=..., autotune=...)``::

    eng = build(EngineSpec(model=CNNModel(params, cfg), batch=32,
                           targets=TopK(3), device="h100", autotune=True))
    eng.plan            # the TilePlan the kernels launch under
"""
from repro_torch.plan.cache import TuningCache, cache_key, default_cache_path
from repro_torch.plan.model import (CardFootprint, Footprint,
                                    card_footprint, conv2d_bwd_footprint,
                                    conv2d_fwd_footprint, pool_footprint,
                                    ssm_scan_footprint, vmm_bwd_footprint,
                                    vmm_fwd_footprint)
from repro_torch.plan.planner import (AUTOTUNE_TOP_K, LM_PLAN_SEQ, ConvTile,
                                      InfeasiblePlanError, ScanTile,
                                      TilePlan, VmmBwdTile, VmmTile,
                                      cnn_kernel_shapes, cnn_plan_footprints,
                                      lm_kernel_shapes, lm_plan_footprints,
                                      measure_kernel, plan_cnn, plan_conv2d,
                                      plan_lm, plan_vmm, shard_batch_seeds)
from repro_torch.plan.profiles import (PROFILES, DeviceProfile,
                                       GpuMeshProfile, GpuProfile,
                                       MeshProfile, detect, get_profile,
                                       gpu_profile, mesh_profile,
                                       profile_names)

__all__ = [
    "AUTOTUNE_TOP_K", "CardFootprint", "ConvTile", "DeviceProfile",
    "Footprint", "GpuMeshProfile", "GpuProfile", "InfeasiblePlanError", "LM_PLAN_SEQ",
    "MeshProfile", "PROFILES", "ScanTile", "TilePlan", "TuningCache",
    "VmmBwdTile", "VmmTile", "cache_key", "card_footprint",
    "cnn_kernel_shapes", "cnn_plan_footprints", "conv2d_bwd_footprint",
    "conv2d_fwd_footprint", "default_cache_path", "detect", "get_profile",
    "gpu_profile", "lm_kernel_shapes", "lm_plan_footprints",
    "measure_kernel", "mesh_profile", "plan_cnn", "plan_conv2d", "plan_lm",
    "plan_vmm", "pool_footprint", "profile_names", "shard_batch_seeds",
    "ssm_scan_footprint", "vmm_bwd_footprint", "vmm_fwd_footprint",
]
