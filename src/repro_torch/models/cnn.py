"""The paper's Table III CNN (CIFAR-10), on the port's kernels.

Layer stack:  Conv(3->32) Conv(32->32) Pool Conv(32->64) Conv(64->64) Pool
              FC(4096->128) ReLU FC(128->10)

On the kernel path every layer runs as a fused block, as on the JAX
package's Pallas path:

* forward block: conv (+bias) -> ReLU (+1-bit mask) -> pool (+2-bit
  argmax); FC blocks: matmul (+bias) -> ReLU (+mask).  The residuals are
  the packed masks and indices only (the paper's BRAM store).
* backward block: ONE kernel launch per layer — unpool scatter, mask gate
  (Eq. 3-5) and the flip-transposed conv or transposed matmul — for all S
  seeds at once.

The seed-batched pair (:func:`forward_with_residuals`,
:func:`backward_seeds`) runs the blocks by hand.  :func:`apply` runs them
under autograd, with the JAX signature and its three branches: the fused
blocks as autograd Functions (``_ConvBlock``/``_FCBlock``, whose weight
gradients are computed only when asked for), the standalone kernel ops of
``kernels/*/ops.py`` (``fused=False``, and the ``"autodiff"`` training
path), and the plain reference ops (``use_pallas=False``: ``F.conv2d``,
matmul, ``core.rules``).

Layouts are the JAX package's: NHWC activations, HWIO conv kernels,
``[in, out]`` FC weights, and the residual dict of
``repro.models.cnn.forward_with_residuals``, byte for byte, so residuals
replay across the two packages.  Parameters are
``{"conv": [{"w", "b"}], "fc": [{"w", "b"}]}`` of f32 (or bf16) tensors.

Precisions: ``"f32"``; ``"bf16"``, params, input and seeds cast to bf16
as the JAX package casts them, through the bf16 instances of the same
kernels (f32 sums, each layer's output rounded once to bf16, the bias added
after that rounding); and ``"fxp16"``, the paper's true 16-bit
fixed-point datapath (§IV): params quantized to Q1.14 weights / Q7.8
biases, Q7.8 int16 feature maps and gradients, int32 accumulation with one
requantize per layer, through the int16 kernels (``kernels/*/fxp.py``) and
the int16 instances of ReLU+mask and pool; it matches the JAX package bit
for bit.  ``CNNConfig.dtype`` is the params' type (``"float32"`` or
``"bfloat16"``, as the JAX package's ``init`` makes them); the precision
casts them.  The seed-batched pair runs every precision; autograd
(``apply`` with a gradient, the vjp engine) runs f32 and bf16: under bf16
the cotangent flows in bf16 through each block's backward (the bf16
instances of the same kernels) and back through the casts, so the
gradient of an f32 input or parameter is f32 holding bf16 values, as the
JAX package's.  Integers have no gradient: fxp16 runs the pair only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint, rules
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import conv2d, conv2d_bwd_fused
from repro_torch.kernels.conv2d.fxp import conv2d_bwd_fused_fxp, conv2d_fxp
from repro_torch.kernels.pool import ops as pool_ops
from repro_torch.kernels.pool.fxp import maxpool_fwd_fxp, relu_pool_fwd_fxp
from repro_torch.kernels.pool.pool import (maxpool_fwd, relu_pool_fwd,
                                           unpool_bwd)
from repro_torch.kernels.relu_mask import ops as relu_ops
from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd
from repro_torch.kernels.vmm import ops as vmm_ops
from repro_torch.kernels.vmm import ref as vmm_ref
from repro_torch.kernels.vmm.fxp import vmm_bwd_fused_fxp, vmm_fxp
from repro_torch.kernels.vmm.vmm import vmm, vmm_bwd_fused

#: ``CNNConfig.dtype`` -> the params' torch type.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: Precision -> the ``CNNConfig.dtype`` its datapath runs in (fxp16: int16,
#: none of DTYPES).
PRECISIONS = {"f32": "float32", "bf16": "bfloat16", "fxp16": None}


@dataclass(frozen=True)
class CNNConfig:
    in_hw: Tuple[int, int] = (32, 32)
    in_ch: int = 3
    channels: Tuple[int, ...] = (32, 32, 64, 64)   # conv channels, pool every 2
    kernel: int = 3
    fc: Tuple[int, ...] = (128,)
    num_classes: int = 10
    conv_relu: bool = True
    pool_every: int = 2
    dtype: str = "float32"

    def feature_hw(self) -> Tuple[int, int]:
        h, w = self.in_hw
        n_pools = len(self.channels) // self.pool_every
        return h // (2 ** n_pools), w // (2 ** n_pools)

    def flat_features(self) -> int:
        h, w = self.feature_hw()
        return h * w * self.channels[-1]

    def param_count(self) -> int:
        n, cin = 0, self.in_ch
        for c in self.channels:
            n += self.kernel * self.kernel * cin * c + c
            cin = c
        fin = self.flat_features()
        for f in self.fc + (self.num_classes,):
            n += fin * f + f
            fin = f
        return n


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r} not in "
                         f"{tuple(PRECISIONS)}")


def _check_cfg(cfg: CNNConfig) -> None:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"CNNConfig.dtype={cfg.dtype!r} not in "
                         f"{tuple(DTYPES)}")


def init(generator: torch.Generator, cfg: CNNConfig,
         device="cpu") -> dict:
    """He-init conv (HWIO) and FC params from ``generator``, of
    ``cfg.dtype``.

    Same shapes and scales as ``repro.models.cnn.init``, not the same
    numbers (a ``torch.Generator`` is not ``jax.random``); to hold the two
    packages against each other use :func:`params_from_jax`.
    """
    _check_cfg(cfg)
    dt = DTYPES[cfg.dtype]
    params = {"conv": [], "fc": []}
    cin = cfg.in_ch
    for c in cfg.channels:
        fan_in = cfg.kernel * cfg.kernel * cin
        w = torch.randn((cfg.kernel, cfg.kernel, cin, c),
                        generator=generator) * math.sqrt(2.0 / fan_in)
        params["conv"].append({"w": w.to(device, dt),
                               "b": torch.zeros(c, dtype=dt, device=device)})
        cin = c
    fin = cfg.flat_features()
    for f in cfg.fc + (cfg.num_classes,):
        w = torch.randn((fin, f), generator=generator) * math.sqrt(2.0 / fin)
        params["fc"].append({"w": w.to(device, dt),
                             "b": torch.zeros(f, dtype=dt, device=device)})
        fin = f
    return params


def params_from_jax(params_np, device="cpu") -> dict:
    """The JAX package's params tree (as NumPy arrays) -> this package's.

    Same layouts (HWIO, ``[in, out]``), so it is a copy and nothing else;
    f32 tensors (bf16 params widen exactly, and a precision casts back).
    """
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {k: [{"w": t(p["w"]), "b": t(p["b"])} for p in params_np[k]]
            for k in ("conv", "fc")}


def params_to(params, device) -> dict:
    """Params tree moved to ``device`` (no copy where already there)."""
    return {k: [{n: v.to(device) for n, v in p.items()} for p in params[k]]
            for k in ("conv", "fc")}


def prepare_params(params, precision: str) -> dict:
    """The params the forward blocks read under ``precision``: the tree
    cast to f32 or to bf16 (the same tensors where they already are), or
    under fxp16 its int16 quantization (Q1.14 weights, Q7.8 biases,
    ``fixedpoint.quantize_params_int``)."""
    if precision == "fxp16":
        return fixedpoint.quantize_params_int(params)
    dt = DTYPES[PRECISIONS[precision]]
    return {k: [{n: v.to(dt) for n, v in p.items()} for p in params[k]]
            for k in ("conv", "fc")}


def backward_weights(params) -> dict:
    """The weights the backward blocks read, made once per model from
    :func:`prepare_params`: flip-transposed conv kernels ``[K, K, Cout,
    Cin]`` and contiguous ``W^T [out, in]`` FC weights."""
    return {"conv": [conv_ref.flip_transpose(p["w"]) for p in params["conv"]],
            "fc": [p["w"].T.contiguous() for p in params["fc"]]}


def residuals_to(residuals, device) -> dict:
    """A residual dict with every packed tensor moved to ``device``."""
    def mv(t):
        return None if t is None else t.to(device)

    return {"conv": [(mv(m), mv(i)) for m, i in residuals["conv"]],
            "fc": [mv(m) for m in residuals["fc"]],
            "feat_shape": tuple(residuals["feat_shape"])}


# ---------------------------------------------------------------------------
# fused blocks
# ---------------------------------------------------------------------------

#: The kernels each precision's blocks run: f32 and bf16 share the
#: wrappers, which launch their bf16 instances on bf16 tensors; fxp16 runs
#: the int16 kernels (ReLU+mask is one wrapper for every element type).
#: ``relu_pool`` is ReLU (+mask) and pool in one launch, at the pooled
#: layers.
_FLOAT_KERNELS = dict(conv=conv2d, pool=maxpool_fwd, relu_pool=relu_pool_fwd,
                      fc=vmm, conv_bwd=conv2d_bwd_fused, fc_bwd=vmm_bwd_fused)
_KERNELS = {
    "f32": _FLOAT_KERNELS,
    "bf16": _FLOAT_KERNELS,
    "fxp16": dict(conv=conv2d_fxp, pool=maxpool_fwd_fxp,
                  relu_pool=relu_pool_fwd_fxp, fc=vmm_fxp,
                  conv_bwd=conv2d_bwd_fused_fxp, fc_bwd=vmm_bwd_fused_fxp),
}


def _relu_fwd_mask4(y):
    """relu(y) + NHWC-packed 1-bit mask [N, H, W, ceil(C/8)]."""
    n, h, w, c = y.shape
    y2, m2 = relu_fwd(y.reshape(-1, c))
    return y2.reshape(y.shape), m2.reshape(n, h, w, -1)


def _launch_plan(plan, key: str, *dims):
    """The card's launch object a tile plan holds for this launch
    (:meth:`repro_torch.plan.TilePlan.at`: an ``h100`` entry planned at
    exactly these dims), or None: the kernel's own rule.  A TPU plan (the
    JAX package's profiles) is an audit and never reaches a launch."""
    return None if plan is None else plan.at(key, dims)


def _conv_fwd_plan(plan, i: int, x, w):
    n, h, wd, cin = x.shape
    return _launch_plan(plan, f"conv{i}.fwd", n, h, wd, w.shape[0], cin,
                        w.shape[3])


def _conv_bwd_plan(plan, i: int, g, wt, pooled: bool, gated: bool):
    s, n, hg, wg, c = g.shape if g.dim() == 5 else (1,) + tuple(g.shape)
    return _launch_plan(plan, f"conv{i}.bwd", s, n, hg, wg, wt.shape[0], c,
                        wt.shape[3], int(pooled), int(gated))


def _fc_fwd_plan(plan, i: int, x, w):
    return _launch_plan(plan, f"fc{i}.fwd", x.shape[0], x.shape[1],
                        w.shape[1])


def _fc_bwd_plan(plan, i: int, g, wt, gated: bool):
    s, m, k = g.shape if g.dim() == 3 else (1,) + tuple(g.shape)
    return _launch_plan(plan, f"fc{i}.bwd", s, m, k, wt.shape[1],
                        int(gated))


def _conv_block_fwd_res(k, x, w, b, method, do_relu, do_pool, plan=None):
    """conv (+bias) -> ReLU (+mask) -> pool (+argmax); residuals = packed.
    A pooled layer's ReLU and pool run as one launch (the ReLU'd map never
    reaches memory); Table II: deconvnet stores no ReLU mask.  ``plan``:
    the conv's launch object, or None for its rule."""
    y = k["conv"](x, w, b, plan=plan)
    if do_relu and do_pool:
        return k["relu_pool"](y, mask=method != "deconvnet")
    mask4 = idx = None
    if do_relu:
        if method == "deconvnet":          # Table II: no ReLU mask stored
            y = torch.clamp_min(y, 0)
        else:
            y, mask4 = _relu_fwd_mask4(y)
    if do_pool:
        y, idx = k["pool"](y)
    return y, mask4, idx


def _conv_block_bwd_fused(k, wt, mask4, idx, g, method, do_relu, plan=None):
    """A conv layer's whole backward step, one launch for all seeds."""
    return k["conv_bwd"](g, wt, pool_idx=idx, relu_mask=mask4, gate=do_relu,
                         method=method, plan=plan)


def _fc_block_fwd_res(k, x, w, b, method, do_relu, plan=None):
    y = k["fc"](x, w, b, plan=plan)
    mask = None
    if do_relu:
        if method == "deconvnet":
            y = torch.clamp_min(y, 0)
        else:
            y, mask = relu_fwd(y)
    return y, mask


def _fc_block_bwd_fused(k, wt, mask, g, method, do_relu, plan=None):
    return k["fc_bwd"](g, wt, relu_mask=mask, gate=do_relu, method=method,
                       plan=plan)


# ---------------------------------------------------------------------------
# the fused blocks under autograd (f32 and bf16)
# ---------------------------------------------------------------------------


def _kernels_of(t: torch.Tensor) -> dict:
    """The kernels of ``t``'s precision, looked up at each call:
    ``_KERNELS["bf16"]`` for a bf16 tensor, ``_KERNELS["f32"]`` else."""
    return _KERNELS["bf16" if t.dtype == torch.bfloat16 else "f32"]


def _gate(mask, g, method):
    """The rule's gate on g [..., C] by a packed mask [..., ceil(C/8)] (None
    for deconvnet), through the gate kernel's wrapper."""
    c = g.shape[-1]
    m2 = None if mask is None else mask.reshape(-1, mask.shape[-1])
    return relu_bwd(m2, g.reshape(-1, c), method).reshape(g.shape)


class _ConvBlock(torch.autograd.Function):
    """conv -> ReLU -> pool as one autograd node, on f32 or bf16 operands
    (the kernels of their precision, :func:`_kernels_of`).  Saves the
    packed mask and crumbs, the weight, and ``x`` only when ``w`` needs a
    gradient.  Its backward is the fused conv-backward kernel at S = 1 for
    ``dx``; ``dw`` and ``db`` (training) are computed only when asked for:
    the gradient unpooled and gated through the B12/B11 wrappers, then f32
    sums rounded once to the weight's type, as the JAX package's
    references compute them."""

    @staticmethod
    def forward(ctx, x, w, b, method, do_relu, do_pool, plan=None, i=0):
        y, mask4, idx = _conv_block_fwd_res(_kernels_of(x), x, w, b,
                                            method, do_relu, do_pool,
                                            _conv_fwd_plan(plan, i, x, w))
        ctx.rule = (method, do_relu, do_pool, plan, i)
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                              mask4, idx)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, mask4, idx = ctx.saved_tensors
        method, do_relu, do_pool, plan, i = ctx.rule
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wt = conv_ref.flip_transpose(w)
            dx = _conv_block_bwd_fused(
                _kernels_of(g), wt, mask4, idx, g, method, do_relu,
                _conv_bwd_plan(plan, i, g, wt, do_pool, do_relu))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gg = unpool_bwd(idx, g) if do_pool else g
            if do_relu:
                gg = _gate(mask4, gg, method)
            if ctx.needs_input_grad[1]:
                dw = conv_ref.conv2d_weight_grad(x, w, gg)
            if ctx.needs_input_grad[2]:
                db = gg.float().sum(dim=(0, 1, 2)).to(w.dtype)
        return dx, dw, db, None, None, None, None, None


class _FCBlock(torch.autograd.Function):
    """matmul -> ReLU as one autograd node, on f32 or bf16 operands;
    backward: the fused FC-backward kernel at S = 1 for ``dx``, and
    ``dw``/``db`` (training) only when asked for, f32 sums rounded once to
    the weight's type."""

    @staticmethod
    def forward(ctx, x, w, b, method, do_relu, plan=None, i=0):
        y, mask = _fc_block_fwd_res(_kernels_of(x), x, w, b, method,
                                    do_relu, _fc_fwd_plan(plan, i, x, w))
        ctx.rule = (method, do_relu, plan, i)
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                              mask)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, mask = ctx.saved_tensors
        method, do_relu, plan, i = ctx.rule
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wt = w.T.contiguous()
            dx = _fc_block_bwd_fused(_kernels_of(g), wt, mask, g,
                                     method, do_relu,
                                     _fc_bwd_plan(plan, i, g, wt, do_relu))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gg = _gate(mask, g, method) if do_relu else g
            if ctx.needs_input_grad[1]:
                dw = vmm_ref.vmm_weight_grad(x, gg, w.dtype)
            if ctx.needs_input_grad[2]:
                db = gg.float().sum(dim=0).to(w.dtype)
        return dx, dw, db, None, None, None, None


def _apply_fused(params, x, cfg: CNNConfig, method: str, plan=None):
    # the kernels' gate reads "autodiff" as saliency, as the Pallas gate does
    rule = "saliency" if method == "autodiff" else method
    for i, p in enumerate(params["conv"]):
        do_pool = (i + 1) % cfg.pool_every == 0
        x = _ConvBlock.apply(x, p["w"], p["b"], rule, cfg.conv_relu, do_pool,
                             plan, i)
    x = x.reshape(x.shape[0], -1)
    n_fc = len(params["fc"])
    for i, p in enumerate(params["fc"]):
        x = _FCBlock.apply(x, p["w"], p["b"], rule, i < n_fc - 1, plan, i)
    return x


# ---------------------------------------------------------------------------
# the seed-batched pair
# ---------------------------------------------------------------------------


def forward_with_residuals(params, x, cfg: CNNConfig, method: str,
                           precision: str = "f32", fwd_params=None,
                           plan=None):
    """Forward that RETURNS the packed residuals (masks + indices).

    ``x`` [N, H, W, Cin] f32 -> ``(logits [N, classes] f32, residuals)``,
    with ``residuals = {"conv": [(mask4 | None, idx | None)], "fc": [mask |
    None], "feat_shape": (h, w, c)}`` — per conv layer a 1-bit ReLU mask and
    2-bit pool indices, per hidden FC a 1-bit mask, no activations.

    ``precision="bf16"`` casts the params and the input to bf16 and runs
    the bf16 blocks: the masks are computed on the bf16 maps, and the
    logits come back bf16, as the JAX package's do.
    ``precision="fxp16"`` quantizes the params and the input (Q7.8) and runs
    the int16 blocks: the masks are computed in the quantized domain, and
    the logits come back dequantized (exact).  ``fwd_params`` is
    :func:`prepare_params` of ``params``, made once by the caller; None
    makes it here.  ``plan`` is a :class:`repro_torch.plan.TilePlan`: a
    launch runs its ``h100`` entry where the entry was planned for that
    shape, and its kernel's rule otherwise.
    """
    check_precision(precision)
    _check_cfg(cfg)
    if fwd_params is None:
        fwd_params = prepare_params(params, precision)
    k = _KERNELS[precision]
    if precision == "fxp16":
        x = fixedpoint.to_fixed(x)
    else:
        x = x.to(DTYPES[PRECISIONS[precision]])
    res_conv, res_fc = [], []
    for i, p in enumerate(fwd_params["conv"]):
        do_pool = (i + 1) % cfg.pool_every == 0
        x, mask4, idx = _conv_block_fwd_res(
            k, x, p["w"], p["b"], method, cfg.conv_relu, do_pool,
            _conv_fwd_plan(plan, i, x, p["w"]))
        res_conv.append((mask4, idx))
    feat_shape = tuple(x.shape[1:])
    x = x.reshape(x.shape[0], -1)        # NHWC flatten, as FC0's rows expect
    n_fc = len(fwd_params["fc"])
    for i, p in enumerate(fwd_params["fc"]):
        x, mask = _fc_block_fwd_res(k, x, p["w"], p["b"], method,
                                    i < n_fc - 1,
                                    _fc_fwd_plan(plan, i, x, p["w"]))
        res_fc.append(mask)
    if precision == "fxp16":
        x = fixedpoint.from_fixed(x)
    return x, {"conv": res_conv, "fc": res_fc, "feat_shape": feat_shape}


def backward_seeds(params, residuals, seeds, cfg: CNNConfig, method: str,
                   precision: str = "f32", bwd_weights=None, plan=None):
    """Seed-batched BP: seeds [S, N, classes] -> relevance [S, N, H, W, Cin].

    One fused launch per layer for ALL S seeds, every stored mask and index
    shared.  ``bwd_weights`` is :func:`backward_weights` of
    :func:`prepare_params`, made once by the caller; None makes it here.

    ``precision="bf16"`` casts the seeds to bf16 and replays the BP on
    the bf16 kernels: relevance in bf16, as the JAX package's.
    ``precision="fxp16"`` replays the whole BP in int16: the f32 seeds are
    quantized to Q7.8 pre-scaled by ``fixedpoint.SEED_GAIN``, every layer
    runs the int16 fused kernel, and the relevance is dequantized with the
    gain divided back out exactly.  ``plan`` as in
    :func:`forward_with_residuals`.
    """
    check_precision(precision)
    if bwd_weights is None:
        bwd_weights = backward_weights(prepare_params(params, precision))
    k = _KERNELS[precision]
    if precision == "fxp16":
        g = fixedpoint.to_fixed(seeds * fixedpoint.SEED_GAIN)
    else:
        g = seeds.to(DTYPES[PRECISIONS[precision]])
    n_fc = len(bwd_weights["fc"])
    for i in reversed(range(n_fc)):
        wt, gated = bwd_weights["fc"][i], i < n_fc - 1
        g = _fc_block_bwd_fused(k, wt, residuals["fc"][i], g, method, gated,
                                _fc_bwd_plan(plan, i, g, wt, gated))
    s, n = g.shape[:2]
    g = g.reshape((s, n) + tuple(residuals["feat_shape"]))
    for i in reversed(range(len(bwd_weights["conv"]))):
        mask4, idx = residuals["conv"][i]
        wt = bwd_weights["conv"][i]
        g = _conv_block_bwd_fused(
            k, wt, mask4, idx, g, method, cfg.conv_relu,
            _conv_bwd_plan(plan, i, g, wt, idx is not None, cfg.conv_relu))
    if precision == "fxp16":
        g = fixedpoint.from_fixed(g) / fixedpoint.SEED_GAIN
    return g


def apply_fold(params, x, cfg: CNNConfig, precision: str = "f32",
               fwd_params=None, plan=None):
    """Logits only, at a folded batch: the forward the perturbation
    explainers run over their ``[N*B, ...]`` fan-out (``Engine.perturb``),
    the counterpart of ``repro.models.cnn._apply_fold``.

    It stores nothing for a backward: the deconvnet blocks of
    :func:`forward_with_residuals` (Table II: no ReLU mask), that is, per
    conv layer the conv kernel (B1, its bf16 instance, or B7 under fxp16),
    then ``clamp_min`` at an unpooled layer or the mask-free fused ReLU +
    pool at a pooled one, and the FC kernel (B4, B4 bf16, B9) with
    ``clamp_min`` after the hidden layers.  The ReLU output does not depend
    on the rule set, so the logits are those of every method.  The pool
    crumbs are written and dropped (the template has no instance without
    them).  ``fwd_params`` is :func:`prepare_params` of ``params``, or
    None; ``plan`` as in :func:`forward_with_residuals` (at a folded
    batch a plan made for the unfolded one leaves the rules).
    """
    with torch.no_grad():
        logits, _ = forward_with_residuals(params, x, cfg, "deconvnet",
                                           precision, fwd_params, plan)
    return logits


def apply(params, x, cfg: CNNConfig, *, method: str = "autodiff",
          use_pallas: bool = False, fused: Optional[bool] = None,
          precision: str = "f32", fwd_params=None, plan=None):
    """Forward pass, differentiable: ``x [N, H, W, Cin] -> [N, classes]``.

    ``method`` selects the backward rules at the rectifiers
    (``"autodiff"`` is the plain derivative, for training).  On the kernel
    path (``use_pallas``) with a rule set bound, ``fused`` (default on) runs
    each layer as a fused block whose backward is one kernel launch;
    ``fused=False`` (and ``"autodiff"``) runs the standalone kernel ops, whose
    backward reuses the forward kernels (Table I) and runs the gate and
    unpool kernels.  ``use_pallas=False`` runs the plain reference ops.

    ``precision="bf16"`` casts the params and ``x`` to bf16, as the JAX
    package does, and runs the same three branches on bf16 (the kernels'
    bf16 instances; the reference ops as f32 sums of the widened operands,
    rounded once): the logits are bf16, and the gradient of an f32 ``x``
    or parameter comes back through the casts as f32.  Under fxp16 the
    knobs do not apply: the dequantized logits of the int16 forward under
    the deconvnet rule set, which stores no masks (Table II) — the ReLU
    output is rule-invariant, so the logits are those of every method, as
    in the JAX package; integers have no gradient.  Under f32, params of a
    bfloat16 config are widened (exactly), as the JAX package's f32 blocks
    promote them.  ``fwd_params`` is :func:`prepare_params` of ``params``
    for that precision (made once by the caller, and then no gradient
    reaches ``params``), or None.  ``plan`` (a
    :class:`repro_torch.plan.TilePlan`) reaches the fused blocks'
    launches, as in :func:`forward_with_residuals`.
    """
    check_precision(precision)
    _check_cfg(cfg)
    if precision == "fxp16":
        logits, _ = forward_with_residuals(params, x, cfg, "deconvnet",
                                           precision, fwd_params, plan)
        return logits
    params = (prepare_params(params, precision) if fwd_params is None
              else fwd_params)
    bf16 = precision == "bf16"
    if bf16:
        x = x.to(torch.bfloat16)
    if fused is None:
        fused = use_pallas and method != "autodiff"
    if fused:
        return _apply_fused(params, x, cfg, method, plan)
    if use_pallas:
        relu_fn, pool_fn = relu_ops.relu, pool_ops.maxpool2x2
        conv_fn, fc_fn = conv_ops.conv2d, vmm_ops.vmm
    else:
        relu_fn, pool_fn = rules.relu, rules.maxpool2x2
        conv_fn, fc_fn = ((conv_ref.conv2d_bf16, vmm_ref.vmm_bf16) if bf16
                          else (conv_ref.conv2d, torch.matmul))
    for i, p in enumerate(params["conv"]):
        x = conv_fn(x, p["w"]) + p["b"]
        if cfg.conv_relu:
            x = relu_fn(x, method)
        if (i + 1) % cfg.pool_every == 0:
            x = pool_fn(x, method)
    x = x.reshape(x.shape[0], -1)
    n_fc = len(params["fc"])
    for i, p in enumerate(params["fc"]):
        x = fc_fn(x, p["w"]) + p["b"]
        if i < n_fc - 1:
            x = relu_fn(x, method)       # Table III: ReLU after FC1
    return x
