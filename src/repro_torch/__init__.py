"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of :mod:`repro`.

Same layout as ``src/repro``, so each module's counterpart is found by
path.  This package imports ``torch`` and NumPy only — never ``jax`` and
nothing of ``repro``; the tests hold it against the JAX package on the same
NumPy inputs.

What runs here: the Table III CNN (``models/cnn.py``) explained through the
configure-once engine (``engine/``) in f32 and in the paper's true-int16
fixed point (``precision="fxp16"``, bit for bit with the JAX package), and
through autograd (``backward="vjp"``, ``FnModel``, the composite methods,
training with ``optim/``), and by perturbation (``perturb/``: occlusion,
LIME and RISE, one folded forward), with the hand-written CUDA kernels of
``csrc/`` on the card::

    import torch
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.models import cnn

    cfg = cnn.CNNConfig()
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    eng = build(EngineSpec(CNNModel(params, cfg), method="guided",
                           targets=TopK(3)))
    logits, rel = eng.explain(images)        # images: [B, 32, 32, 3] NHWC

Dispatch is by tensor device: a CPU tensor runs the plain PyTorch version
of each kernel, a CUDA tensor the kernel (built with ``nvcc`` at first use,
see :mod:`repro_torch.kernels._build`) or an exception.  Nothing is built or
loaded at import time.
"""
