"""The paper's Table III CNN (CIFAR-10), f32, on the port's kernels.

Layer stack:  Conv(3->32) Conv(32->32) Pool Conv(32->64) Conv(64->64) Pool
              FC(4096->128) ReLU FC(128->10)

Every layer runs as a fused block, as on the JAX package's Pallas path:

* forward block: conv (+bias) -> ReLU (+1-bit mask) -> pool (+2-bit
  argmax); FC blocks: matmul (+bias) -> ReLU (+mask).  The residuals are
  the packed masks and indices only (the paper's BRAM store).
* backward block: ONE kernel launch per layer — unpool scatter, mask gate
  (Eq. 3-5) and the flip-transposed conv or transposed matmul — for all S
  seeds at once.

Layouts are the JAX package's: NHWC activations, HWIO conv kernels,
``[in, out]`` FC weights, and the residual dict of
``repro.models.cnn.forward_with_residuals``, byte for byte, so residuals
replay across the two packages.  Parameters are
``{"conv": [{"w", "b"}], "fc": [{"w", "b"}]}`` of f32 tensors.

Only ``precision="f32"`` is ported (bf16 and fxp16 are ROADMAP A6).  The
training branches of the JAX blocks (``custom_vjp`` dw/db) are not: the
explain path needs no autograd.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.conv2d import ref as conv_ref
from repro_torch.kernels.conv2d.conv2d import conv2d, conv2d_bwd_fused
from repro_torch.kernels.pool.pool import maxpool_fwd
from repro_torch.kernels.relu_mask.relu_mask import relu_fwd
from repro_torch.kernels.vmm.vmm import vmm, vmm_bwd_fused

PRECISIONS = ("f32", "bf16", "fxp16")


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
        raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
    if precision != "f32":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP A6); the "
            f"port runs f32 only")


def _check_cfg(cfg: CNNConfig) -> None:
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"CNNConfig.dtype={cfg.dtype!r} is not ported yet (ROADMAP A6)")


def init(generator: torch.Generator, cfg: CNNConfig,
         device="cpu") -> dict:
    """He-init conv (HWIO) and FC params from ``generator``.

    Same shapes and scales as ``repro.models.cnn.init``, not the same
    numbers (a ``torch.Generator`` is not ``jax.random``); to hold the two
    packages against each other use :func:`params_from_jax`.
    """
    _check_cfg(cfg)
    params = {"conv": [], "fc": []}
    cin = cfg.in_ch
    for c in cfg.channels:
        fan_in = cfg.kernel * cfg.kernel * cin
        w = torch.randn((cfg.kernel, cfg.kernel, cin, c),
                        generator=generator) * math.sqrt(2.0 / fan_in)
        params["conv"].append({"w": w.to(device),
                               "b": torch.zeros(c, device=device)})
        cin = c
    fin = cfg.flat_features()
    for f in cfg.fc + (cfg.num_classes,):
        w = torch.randn((fin, f), generator=generator) * math.sqrt(2.0 / fin)
        params["fc"].append({"w": w.to(device),
                             "b": torch.zeros(f, device=device)})
        fin = f
    return params


def params_from_jax(params_np, device="cpu") -> dict:
    """The JAX package's params tree (as NumPy arrays) -> this package's.

    Same layouts (HWIO, ``[in, out]``), so it is a copy and nothing else.
    """
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {k: [{"w": t(p["w"]), "b": t(p["b"])} for p in params_np[k]]
            for k in ("conv", "fc")}


def params_to(params, device) -> dict:
    """Params tree moved to ``device`` (no copy where already there)."""
    return {k: [{n: v.to(device) for n, v in p.items()} for p in params[k]]
            for k in ("conv", "fc")}


def backward_weights(params) -> dict:
    """The weights the backward blocks read, made once per model:
    flip-transposed conv kernels ``[K, K, Cout, Cin]`` and contiguous
    ``W^T [out, in]`` FC weights."""
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


def _relu_fwd_mask4(y):
    """relu(y) + NHWC-packed 1-bit mask [N, H, W, ceil(C/8)]."""
    n, h, w, c = y.shape
    y2, m2 = relu_fwd(y.reshape(-1, c))
    return y2.reshape(y.shape), m2.reshape(n, h, w, -1)


def _conv_block_fwd_res(x, w, b, method, do_relu, do_pool):
    """conv (+bias) -> ReLU (+mask) -> pool (+argmax); residuals = packed."""
    y = conv2d(x, w, b)
    mask4 = idx = None
    if do_relu:
        if method == "deconvnet":          # Table II: no ReLU mask stored
            y = torch.clamp_min(y, 0)
        else:
            y, mask4 = _relu_fwd_mask4(y)
    if do_pool:
        y, idx = maxpool_fwd(y)
    return y, mask4, idx


def _conv_block_bwd_fused(wt, mask4, idx, g, method, do_relu):
    """A conv layer's whole backward step, one launch for all seeds."""
    return conv2d_bwd_fused(g, wt, pool_idx=idx, relu_mask=mask4,
                            gate=do_relu, method=method)


def _fc_block_fwd_res(x, w, b, method, do_relu):
    y = vmm(x, w, b)
    mask = None
    if do_relu:
        if method == "deconvnet":
            y = torch.clamp_min(y, 0)
        else:
            y, mask = relu_fwd(y)
    return y, mask


def _fc_block_bwd_fused(wt, mask, g, method, do_relu):
    return vmm_bwd_fused(g, wt, relu_mask=mask, gate=do_relu, method=method)


# ---------------------------------------------------------------------------
# the seed-batched pair
# ---------------------------------------------------------------------------


def forward_with_residuals(params, x, cfg: CNNConfig, method: str,
                           precision: str = "f32"):
    """Forward that RETURNS the packed residuals (masks + indices).

    ``x`` [N, H, W, Cin] -> ``(logits [N, classes], residuals)``, with
    ``residuals = {"conv": [(mask4 | None, idx | None)], "fc": [mask |
    None], "feat_shape": (h, w, c)}`` — per conv layer a 1-bit ReLU mask and
    2-bit pool indices, per hidden FC a 1-bit mask, no activations.
    """
    check_precision(precision)
    _check_cfg(cfg)
    res_conv, res_fc = [], []
    for i, p in enumerate(params["conv"]):
        do_pool = (i + 1) % cfg.pool_every == 0
        x, mask4, idx = _conv_block_fwd_res(x, p["w"], p["b"], method,
                                            cfg.conv_relu, do_pool)
        res_conv.append((mask4, idx))
    feat_shape = tuple(x.shape[1:])
    x = x.reshape(x.shape[0], -1)        # NHWC flatten, as FC0's rows expect
    n_fc = len(params["fc"])
    for i, p in enumerate(params["fc"]):
        x, mask = _fc_block_fwd_res(x, p["w"], p["b"], method, i < n_fc - 1)
        res_fc.append(mask)
    return x, {"conv": res_conv, "fc": res_fc, "feat_shape": feat_shape}


def backward_seeds(params, residuals, seeds, cfg: CNNConfig, method: str,
                   precision: str = "f32", bwd_weights=None):
    """Seed-batched BP: seeds [S, N, classes] -> relevance [S, N, H, W, Cin].

    One fused launch per layer for ALL S seeds, every stored mask and index
    shared.  ``bwd_weights`` is :func:`backward_weights` of ``params``,
    made once by the caller; None makes it here.
    """
    check_precision(precision)
    if bwd_weights is None:
        bwd_weights = backward_weights(params)
    g = seeds
    n_fc = len(params["fc"])
    for i in reversed(range(n_fc)):
        g = _fc_block_bwd_fused(bwd_weights["fc"][i], residuals["fc"][i], g,
                                method, i < n_fc - 1)
    s, n = g.shape[:2]
    g = g.reshape((s, n) + tuple(residuals["feat_shape"]))
    for i in reversed(range(len(params["conv"]))):
        mask4, idx = residuals["conv"][i]
        g = _conv_block_bwd_fused(bwd_weights["conv"][i], mask4, idx, g,
                                  method, cfg.conv_relu)
    return g


def apply(params, x, cfg: CNNConfig, *, method: str = "saliency",
          precision: str = "f32"):
    """Logits only: ``x [N, H, W, Cin] -> [N, classes]``.

    The same fused forward blocks as :func:`forward_with_residuals` (same
    kernels, so the same logits bit for bit), residuals dropped.
    """
    logits, _ = forward_with_residuals(params, x, cfg, method, precision)
    return logits
