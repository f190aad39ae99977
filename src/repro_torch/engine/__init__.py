"""repro_torch.engine — the configure-once attribution engine (configure ->
build -> explain), as ``repro.engine`` has it::

    from repro_torch.engine import CNNModel, EngineSpec, TopK, build

    eng = build(EngineSpec(model=CNNModel(params, cfg), method="guided",
                           targets=TopK(5)))
    logits = eng.predict(images)
    logits, rel = eng.explain(images)            # K-panel via spec.targets
"""
from repro_torch.engine.backward import ManualSeedBatchedBackward
from repro_torch.engine.engine import Engine, build, cache_size, clear_cache
from repro_torch.engine.spec import (PERTURB_METHODS, Argmax, CNNModel,
                                     EngineSpec, Fixed, TopK)

__all__ = [
    "Argmax", "CNNModel", "Engine", "EngineSpec", "Fixed",
    "ManualSeedBatchedBackward", "PERTURB_METHODS", "TopK", "build",
    "cache_size", "clear_cache",
]
