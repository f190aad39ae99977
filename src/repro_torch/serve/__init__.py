"""repro_torch.serve — the explanation-serving subsystem, as
``repro.serve`` has it, on the port's engine and kernels.

Turns the paper's FP+BP attribution engine into a server: an inseq-style
explainer registry (one ``Explainer.attribute`` interface over every method
in :mod:`repro_torch.core.attribution`), a shape-bucketed micro-batcher
with a max-latency deadline, and an LRU cache of the bit-packed forward
residuals so an explain request that follows a predict for the same input
skips the forward pass entirely — the serving-time realization of the
paper's compute-block reuse (§III.F).

Adapters are engine-backed: every engine comes from
``repro_torch.engine.build(EngineSpec(...))``, so method x precision x
backend x device is decided by the spec in one place.

Quickstart::

    import torch
    from repro_torch import engine
    from repro_torch.models import cnn
    from repro_torch.serve import CNNAdapter, ExplanationServer, Request

    cfg = cnn.CNNConfig()
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    eng = engine.build(engine.EngineSpec(
        model=engine.CNNModel(params, cfg), method="saliency"))  # the card
    server = ExplanationServer(CNNAdapter.from_engine(eng))
    server.submit(Request(uid="r0", kind="predict", x=image))  # [32, 32, 3]
    server.submit(Request(uid="r0", kind="explain", x=image,
                          method="guided", topk=5))
    responses = server.drain()        # explain hits the residual cache
    print(server.cache.stats.snapshot(), server.stats.snapshot())
"""
from repro_torch.serve.adapters import CNNAdapter
from repro_torch.serve.admission import (AdmissionConfig, AdmissionController,
                                         DegradePolicy, RateLimit,
                                         ServiceEstimator, TokenBucket)
from repro_torch.serve.api import (EXPLAIN, PREDICT, InvalidRequestError,
                                   Request, Response, ServeError, ShedError,
                                   shed_response)
from repro_torch.serve.batcher import Batch, MicroBatcher, bucket_key
from repro_torch.serve.registry import (Explainer, get, make,
                                        mask_reuse_methods, names, register,
                                        token_methods)
from repro_torch.serve.residual_cache import (CacheEntry, ResidualCache,
                                              residual_bits)
from repro_torch.serve.server import ExplanationServer
from repro_torch.serve.stats import ServerStats

__all__ = [
    "CNNAdapter", "EXPLAIN", "PREDICT", "Request", "Response", "Batch",
    "MicroBatcher", "bucket_key", "Explainer", "get", "make",
    "mask_reuse_methods", "names", "register", "token_methods", "CacheEntry",
    "ResidualCache", "residual_bits", "ExplanationServer", "ServerStats",
    "AdmissionConfig", "AdmissionController", "DegradePolicy", "RateLimit",
    "ServiceEstimator", "TokenBucket", "ServeError", "ShedError",
    "InvalidRequestError", "shed_response",
]
