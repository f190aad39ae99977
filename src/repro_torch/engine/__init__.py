"""repro_torch.engine — the configure-once attribution engine (configure ->
build -> explain), as ``repro.engine`` has it::

    from repro_torch.engine import CNNModel, EngineSpec, TopK, build

    eng = build(EngineSpec(model=CNNModel(params, cfg), method="guided",
                           targets=TopK(5)))
    logits = eng.predict(images)
    logits, rel = eng.explain(images)            # K-panel via spec.targets
    logits, ig = eng.ig(images, steps=16)        # composites, same model

Backends: :class:`ManualSeedBatchedBackward` (the fused kernels' pair,
auto-selected for ``CNNModel(use_pallas=True)`` and required for fxp16)
and :class:`VjpBackward` (autograd, any differentiable model:
``backward="vjp"``, ``CNNModel(use_pallas=False)``, :class:`FnModel`).
The method math lives in :mod:`repro_torch.engine.methods`;
``Engine.perturb`` runs the forward-only perturbation explainers of
:mod:`repro_torch.perturb` over the model's mask-free fold forward.
"""
from repro_torch.engine import methods
from repro_torch.engine.backward import ManualSeedBatchedBackward, VjpBackward
from repro_torch.engine.engine import Engine, build, cache_size, clear_cache
from repro_torch.engine.spec import (PERTURB_METHODS, Argmax, CNNModel,
                                     EngineSpec, Fixed, FnModel, LMModel,
                                     TopK)

__all__ = [
    "Argmax", "CNNModel", "Engine", "EngineSpec", "Fixed", "FnModel",
    "LMModel",
    "ManualSeedBatchedBackward", "PERTURB_METHODS", "TopK", "VjpBackward",
    "build", "cache_size", "clear_cache", "methods",
]
