"""Opt-in timed wrappers around the kernel call sites, as
``repro.obs.profile`` has them.

The kernel wrappers (``conv2d``, ``conv2d_bwd_fused``, ``vmm``,
``vmm_bwd_fused``, their int16 twins, the pool and the fused ReLU + pool)
are decorated with :func:`instrument`.  The decorator's disabled path is
ONE module-global ``is None`` check — no fence, no clock read — so serving
pays nothing unless a profiler is installed.

When enabled (``with profiled(): ...`` or :func:`enable`), each call is
fenced with ``torch.cuda.synchronize()`` on both sides (CUDA operands; a
CPU call returns when it is done) and timed on the :mod:`repro_torch.obs.
clock` clock: the ``kernel_launch_seconds`` histogram labelled (family,
shape, precision) records the fenced wall time of the wrapper call, launch
and host work included, and an exact-shape aggregate table keeps count,
mean, min and max.  The fences serialize the stream, so a profiled run is
slower than an unprofiled one.

Shape signatures keep the keyword order of the JAX package's
``_sig_*`` (that of the planner's ``cnn_kernel_shapes``), so profiler keys
join with the tile planner's in the drift table
(:mod:`repro_torch.plan.drift`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.obs import clock as clock_lib
from repro_torch.obs import metrics as obsm

_PROFILER: Optional["KernelProfiler"] = None

_PRECISION_BY_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
                       torch.int16: "fxp16"}


def _precision_of(x) -> str:
    return _PRECISION_BY_DTYPE.get(x.dtype, str(x.dtype).split(".")[-1])


# Per-family shape signatures, each a kw dict in the order of the JAX
# package's, so ``tuple(kw.values())`` matches its keys.

def _sig_conv2d_fwd(args, kwargs):
    x, w = args[0], args[1]
    n, h, wi, cin = x.shape
    k, _, _, cout = w.shape
    return dict(n=n, h=h, w=wi, k=k, cin=cin, cout=cout)


def _gated(kwargs) -> bool:
    gate = kwargs.get("gate")
    if gate is not None:
        return bool(gate)
    return kwargs.get("relu_mask") is not None


def _sig_conv2d_bwd(args, kwargs):
    g, wt = args[0], args[1]
    seeded = g.dim() == 5
    s = g.shape[0] if seeded else 1
    n, hg, wg, c = g.shape[1:] if seeded else g.shape
    k, _, _, cout = wt.shape
    return dict(s=s, n=n, hg=hg, wg=wg, k=k, c=c, cout=cout,
                pooled=kwargs.get("pool_idx") is not None,
                gated=_gated(kwargs))


def _sig_vmm_fwd(args, kwargs):
    x, w = args[0], args[1]
    m, k = x.shape
    n = w.shape[1]
    return dict(m=m, k=k, n=n)


def _sig_vmm_bwd(args, kwargs):
    g, w = args[0], args[1]
    seeded = g.dim() == 3
    s = g.shape[0] if seeded else 1
    m, k = g.shape[-2], g.shape[-1]
    n = w.shape[1]
    return dict(s=s, m=m, k=k, n=n, gated=_gated(kwargs))


def _sig_pool(args, kwargs):
    x = args[0]
    n, h, w, c = x.shape[:4]
    return dict(n=n, h=h, w=w, c=c)


_SIG_FNS = {
    "conv2d_fwd": _sig_conv2d_fwd,
    "conv2d_bwd": _sig_conv2d_bwd,
    "vmm_fwd": _sig_vmm_fwd,
    "vmm_bwd": _sig_vmm_bwd,
    "pool": _sig_pool,
}


def _fence(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class KernelProfiler:
    """Aggregates fenced call times per (family, shape-sig, precision)."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else clock_lib.perf
        # (family, dims-tuple, precision) -> [count, total_s, min_s, max_s]
        self.records: Dict[Tuple[str, Tuple[int, ...], str], list] = {}

    def call(self, family: str, fn, args, kwargs):
        try:
            kw = _SIG_FNS[family](args, kwargs)
            precision = _precision_of(args[0])
        except Exception:           # unexpected operand shape: never break
            return fn(*args, **kwargs)      # the kernel over bookkeeping
        _fence(args[0])
        t0 = self.clock()
        out = fn(*args, **kwargs)
        _fence(args[0])
        dt = self.clock() - t0
        dims = tuple(int(v) for v in kw.values())
        rec = self.records.get((family, dims, precision))
        if rec is None:
            rec = self.records[(family, dims, precision)] = [0, 0.0, dt, dt]
        rec[0] += 1
        rec[1] += dt
        rec[2] = min(rec[2], dt)
        rec[3] = max(rec[3], dt)
        obsm.KERNEL_SECONDS.observe(
            dt, family=family, shape="x".join(str(d) for d in dims),
            precision=precision)
        return out

    def aggregates(self) -> dict:
        """{(family, dims, precision): {count, mean_us, min_us, max_us}}"""
        return {
            key: {"count": rec[0], "mean_us": 1e6 * rec[1] / rec[0],
                  "min_us": 1e6 * rec[2], "max_us": 1e6 * rec[3]}
            for key, rec in self.records.items()
        }


def instrument(family: str):
    """Decorate a kernel wrapper; disabled path is one ``is None`` check."""
    if family not in _SIG_FNS:
        raise ValueError(f"unknown kernel family {family!r}")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            prof = _PROFILER
            if prof is None:
                return fn(*args, **kwargs)
            return prof.call(family, fn, args, kwargs)
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def enable(profiler: Optional[KernelProfiler] = None) -> KernelProfiler:
    global _PROFILER
    _PROFILER = profiler if profiler is not None else KernelProfiler()
    return _PROFILER


def disable() -> None:
    global _PROFILER
    _PROFILER = None


def profiler() -> Optional[KernelProfiler]:
    return _PROFILER


def enabled() -> bool:
    return _PROFILER is not None


@contextlib.contextmanager
def profiled(profiler: Optional[KernelProfiler] = None):
    prev = _PROFILER
    prof = enable(profiler)
    try:
        yield prof
    finally:
        globals()["_PROFILER"] = prev


def format_aggregates(prof: KernelProfiler) -> str:
    """The aggregate table, one line a (family, shape, precision), by
    family then total time."""
    rows = sorted(prof.aggregates().items(),
                  key=lambda kv: (kv[0][0], -kv[1]["count"]
                                  * kv[1]["mean_us"]))
    lines = [f"{'family':11s} {'shape':28s} {'prec':5s} {'count':>6s} "
             f"{'mean_us':>10s} {'min_us':>10s} {'max_us':>10s}"]
    for (family, dims, precision), a in rows:
        lines.append(
            f"{family:11s} {'x'.join(map(str, dims)):28s} {precision:5s} "
            f"{a['count']:6d} {a['mean_us']:10.1f} {a['min_us']:10.1f} "
            f"{a['max_us']:10.1f}")
    return "\n".join(lines)
