#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
card: build every kernel, hold each against its plain PyTorch version at
the shapes its path gives it, then explain full-width batches of the Table
III CNN through the engine, in f32 and in the paper's true-int16 fixed
point (fxp16), then through autograd (the vjp backend), train a few steps,
and explain each generated token of falcon-mamba-7b at full width and
depth, and check them against the CPU.

    python3 chip_smoke.py                  # one card; exits 0 when all pass
    python3 chip_smoke.py --out DIR        # also writes DIR/chip_smoke.json
    python3 chip_smoke.py --sweep [--out DIR]

``--sweep`` runs phase 1, then times the launch choices of B4 (every K
split) and B1 (a grid of tile plans, all bitwise equal) beside the library
call at the main-path and vjp shapes, and stops.

Phases (every failed check raises; nothing is caught and carried on):

1. device: card name, ``nvidia-smi`` name, power limit and maximum SM
   clock, TF32 off for the plain versions, kernel build time, and the
   registers and spills ``ptxas`` reports for the redesigned B1/B4
   kernels;
2. kernels at batch 32, S = 3 seeds, against their plain versions: the f32
   kernels B1-B6 (bitwise for ReLU+mask and pool+argmax, within
   1e-5 * max|ref| for the dots; B1 and B4 also launched again on the same
   inputs, and B1 under a second tile plan, all bitwise equal; each time
   beside a library call prints its ratio to it), then the fxp16 kernels
   B7-B10 and the int16 instances of B2/B3, all bitwise, plus accumulators that wrap at
   ±32767 operands; then the gate (B11, three methods) and unpool (B12,
   f32 and int16) kernels of the autograd paths, bitwise; then the
   selective scan (B13) at falcon-mamba-7b's explain shape (B = 4, S = 72,
   D = 8192, N = 16; x bf16 and f32) and a ragged S = 13, within the JAX
   package's tolerance (atol 2e-4, rtol 2e-3; one bf16 step for a bf16 y),
   two (d_tile, chunk) pairs bitwise equal, and the time of its plain
   backward (autograd over the chunked scan); median kernel, plain and
   one-library-call times (CUDA events);
3. engine, full width: saliency / deconvnet / guided explains of a
   [32, 32, 32, 3] batch with top-3 seeds on the card against a CPU twin
   engine on the same parameters (logits, residual bits, cross-replay), and
   the launch count of each kernel per explain; under fxp16 every one of
   these must be equal bit for bit;
4. requests: predict / explain / top-k explain / predict-then-explain +
   replay, where the replay of a target must equal its cold explain bit
   for bit;
5. vjp: top-3 explains of the same batch through ``backward="vjp"``, (a)
   on the fused blocks (``CNNModel``) and (b) on the standalone kernel ops
   (``FnModel`` over ``cnn.apply(..., use_pallas=True, fused=False)``, B11
   and B12 in the backward), against the seed-batched card engine and a
   CPU twin: logits within 1e-5 * max|ref|, relevance within 1e-4 * max|rel|
   of the seed-batched engine's, of the CPU twin's on the examples whose
   stored bits the two devices agree on (a pre-activation within float
   noise of 0 or of its window's maximum can flip a bit, which changes
   that example's map), and of the CPU's replay of the card's stored bits
   on every example; the launches of each branch per explain;
6. train: three AdamW steps of ``cnn.apply(p, x, cfg, use_pallas=True)``
   (autodiff, cross-entropy, batch 32), each step's parameter gradients
   within 1e-4 * max|g| of a CPU twin's on the same parameters (over the
   examples whose ReLU signs and pool argmax the two devices agree on);
7. lm: falcon-mamba-7b's FULL config (64 layers, bf16, 7.27 B random
   parameters from ``torch.Generator(device="cuda").manual_seed(0)``):
   greedy ``decode`` of 4 prompts x 64 tokens, 8 new tokens, twice (equal
   tokens, no B13 launch); ``explain_generated`` in contrastive mode (8
   per-token explains over S = 72: scores after each seed exactly 0,
   finite); contrastive = ixg(a) - ixg(b) within LM_LINEARITY_TOL; the
   engine's ``explain_tokens`` on the prompts in ixg, grad_norm and
   contrastive (saliency) and ixg for deconvnet and guided; against the
   chunked scan on the same card: each layer's B13 output within phase
   2's tolerance of the chunked scan on the same operands, and the
   explain's last-position logits within LM_LOGITS_FACTOR times the
   chunked route's own bf16 error (its distance from the same weights in
   f32); 64 B13 launches per explain; host and device time per decode
   step and per explain;
8. lm twin: the same config at depth 2 in f32, batch 2 x 32 tokens, on the
   card against a CPU twin: logits within 1e-5 * max|ref|; the int8
   residual codes equal on MIN_BIT_AGREEMENT of them and one step apart
   elsewhere; scores within 1e-4 * max|scores| per mode of the CPU run on
   the card's int8 codes, and, with exact residuals, of the plain CPU
   twin (see ``check_lm_twin``); contrastive = ixg(a) - ixg(b) within
   1e-4 * max.

Last, one saliency explain of each CNN path, one training step, one LM
decode step and one per-token LM explain run under ``torch.profiler``:
kernel time by kernel and by family against the device time measured
before (the device's idle share).  This comes after every timing, since a
profiler session slows what runs after it.

Phases 3-4 run once per path, f32 then fxp16; phases 5 (per branch), 6, 7
and 8 are paths of their own.  Launch counters are set to 0 just before
each path (in phases 5-8: before each checked explain, training step or
decode) and read just after; the kernel-vs-plain launches of phase 2, and
the launches of the comparisons and timings of phases 5-8, are not
counted.  The last two lines are the
per-kernel JSON and the device JSON.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEEDS = 32, 3
METHODS = ("saliency", "deconvnet", "guided")
DOT_TOL = 1e-5          # reordered f32 sums of up to 4096 terms
REPLAY_TOL = 1e-4       # relevance after four layers of such sums
MIN_BIT_AGREEMENT = 0.9999
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores.  The bound is the larger of bytes/HBM and
# FLOP/f32 peak, at the card's full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The int16 kernels run 32-bit integer multiply-adds (IMAD) on the CUDA
# cores.  Their peak is not on the data sheet: it is taken as SM count x
# 64 IMAD lanes per SM per clock (compute capability 9.0) x the card's
# maximum SM clock, both read from the card in phase 1 (an assumption: the
# sustained clock under load may be lower).
IMAD_LANES_PER_SM = 64
# The scan's exponentials run on the SFU (MUFU.EX2): 16 per SM per clock on
# compute capability 9.0, times the SM count and maximum SM clock read in
# phase 1 (the same assumption as for IMAD).
MUFU_PER_SM = 16
REPS = 50
# B13 against its plain version: the JAX package's own tolerance
# (tests/test_kernels_ssm.py); a bf16 y is a rounding of such a value, so
# it may sit one bf16 step (at most 2^-7 relative) away.
SCAN_ATOL, SCAN_RTOL, SCAN_BF16_RTOL = 2e-4, 2e-3, 2.0 ** -7
# Phase 7: falcon-mamba-7b at full width and depth, bf16: 4 prompts of 64
# tokens, 8 greedy tokens, so each per-token explain runs over S = 72.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "falcon-mamba-7b", 4, 64, 8
# bf16 end to end.  The B13 route and the chunked scan compute the same f32
# recurrence in another order, so a y may land on the other side of a bf16
# rounding step.  In each layer of the B13 route's forward, B13's y is held
# against the chunked scan on the same operands at phase 2's tolerance
# (SCAN_*: one bf16 step).  Through the whole stack such one-step
# differences run on through 64 bf16 layers, each rounding again, so the
# explain's last-position logits are held to the chunked route's own bf16
# error, a bound that B13 does not enter: within LM_LOGITS_FACTOR times the
# chunked route's distance from the same weights evaluated in f32.
# Contrastive vs the ixg difference: the backward is linear in its seed but
# rounds every bf16 cotangent, so the two seeds' roundings differ; within
# LM_LINEARITY_TOL * max(|ixg a|, |ixg b|).
LM_LOGITS_FACTOR = 2.0
LM_LINEARITY_TOL = 5e-2
# Phase 8: two layers at full width in f32 against a CPU twin.
LM_TWIN_BATCH, LM_TWIN_SEQ = 2, 32

KERNELS = {   # counter -> (C source, replaced TPU kernel def)
    "conv2d_fwd": ("src/repro_torch/csrc/conv2d.cu",
                   "src/repro/kernels/conv2d/conv2d.py:66"),
    "relu_fwd": ("src/repro_torch/csrc/relu_mask.cu",
                 "src/repro/kernels/relu_mask/relu_mask.py:87"),
    "maxpool_fwd": ("src/repro_torch/csrc/pool.cu",
                    "src/repro/kernels/pool/pool.py:77"),
    "vmm_fwd": ("src/repro_torch/csrc/vmm.cu",
                "src/repro/kernels/vmm/vmm.py:49"),
    "conv2d_bwd_fused": ("src/repro_torch/csrc/conv2d.cu",
                         "src/repro/kernels/conv2d/conv2d.py:150"),
    "vmm_bwd_fused": ("src/repro_torch/csrc/vmm.cu",
                      "src/repro/kernels/vmm/vmm.py:117"),
    "conv2d_fxp_fwd": ("src/repro_torch/csrc/conv2d_fxp.cu",
                       "src/repro/kernels/conv2d/fxp.py:53"),
    "conv2d_bwd_fused_fxp": ("src/repro_torch/csrc/conv2d_fxp.cu",
                             "src/repro/kernels/conv2d/fxp.py:130"),
    "vmm_fxp_fwd": ("src/repro_torch/csrc/vmm_fxp.cu",
                    "src/repro/kernels/vmm/fxp.py:46"),
    "vmm_bwd_fused_fxp": ("src/repro_torch/csrc/vmm_fxp.cu",
                          "src/repro/kernels/vmm/fxp.py:116"),
    "relu_bwd": ("src/repro_torch/csrc/relu_mask.cu",
                 "src/repro/kernels/relu_mask/relu_mask.py:108"),
    "unpool_bwd": ("src/repro_torch/csrc/pool.cu",
                   "src/repro/kernels/pool/pool.py:97"),
    "selective_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                       "src/repro/kernels/ssm_scan/ssm_scan.py:56"),
}
#: The int16 instances of B2/B3 (fxp16 path) and of B12: timed and checked
#: on their own, launched under the ``relu_fwd`` / ``maxpool_fwd`` /
#: ``unpool_bwd`` counters.
INT16_INSTANCES = ("relu_fwd_i16", "maxpool_fwd_i16", "unpool_bwd_i16")


def fail(msg: str):
    raise AssertionError(msg)


#: Entry functions of the kernels redesigned for this card (B1's and B4's
#: forwards), whose registers and spills phase 1 reports.
REDESIGNED = ("conv_igemm_kernel", "vmm_splitk_kernel",
              "vmm_splitk_sum_kernel")


def kernel_resources(ptxas_log: str, names):
    """``(name<template args>, registers, spill store bytes, spill load
    bytes)`` of each compiled entry whose mangled name holds one of
    ``names``, read from ``nvcc -Xptxas=-v`` output."""
    found, entry, spill = [], None, (None, None)
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), (None, None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            for name in names:
                if re.search(rf"\d{name}(?:I|E|v|$)", entry):
                    targs = re.findall(r"Li(\d+)E", entry)
                    label = name + (f"<{','.join(targs)}>" if targs else "")
                    found.append((label, int(m.group(1))) + spill)
            entry = None
    return found


def bound_ms(nbytes: float, ops: float, rate: float) -> float:
    """The least time for ``nbytes`` at HBM speed and ``ops`` at ``rate``."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / rate)


def device_time_ms(fn, reps: int = REPS, cover_ms: float = 50.0) -> float:
    """Median device time of ``fn()`` over ``reps`` back-to-back runs.

    A sleep kernel of about ``cover_ms`` is queued first so the host
    enqueues every run before the card reaches them: the events then time
    the kernels, not Python.  Inputs are warm in L2 (all fit in its 50 MB),
    as on the main path.
    """
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e6 * cover_ms))       # cycles, ~2 GHz SM clock
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def profile_breakdown(fn, what: str, wall: float, reps: int = 5):
    """Device time of ``fn()`` by kernel under ``torch.profiler`` (CUPTI):
    the kernels' summed time per call against ``wall``, the CUDA-event
    device time per call measured before any profiler ran (a profiler
    session slows what runs after it); the gap is the device's idle share
    between kernels.  Returns None, and says so, where the profiler
    records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    if not by_name:
        print(f"  profile {what}: the profiler recorded no kernel; device "
              f"busy share not measured")
        return None
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profile {what}: kernels {busy:.4f} ms of {wall:.4f} ms device "
          f"per call (idle {100 * max(0.0, 1 - busy / wall):.1f} %); "
          + "; ".join(f"{n[:48]} {t:.4f}" for n, t in top))
    cats = {}
    for name, t in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + t
    print("    by category: " + "; ".join(
        f"{c} {t:.4f}" for c, t in sorted(cats.items(), key=lambda kv: -kv[1])))
    return dict(kernels_ms=busy, device_ms=wall, by_kernel=by_name,
                by_category=cats)


def _category(kernel_name: str) -> str:
    """A kernel's family, by its name: our kernels, cuBLAS/CUTLASS matrix
    products, or PyTorch's own (elementwise, reductions, copies)."""
    n = kernel_name.lower()
    if "selective_scan" in n:
        return "B13"
    if any(k in n for k in ("conv_kernel", "conv_igemm_kernel",
                            "vmm_splitk", "conv_fxp_kernel", "relu_fwd_kernel",
                            "relu_bwd_kernel", "maxpool_fwd_kernel",
                            "unpool_bwd_kernel", "vmm_kernel",
                            "vmm_fxp_kernel", "vmm_bwd")):
        return "B1-B12"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "cublas", "sm90_",
                            "gemv", "splitk")):
        return "matmul (cuBLAS)"
    return "torch (elementwise, reductions, copies)"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelCheck:
    """Per-kernel results, summed over its main-path shapes (saliency)."""

    def __init__(self, imad_per_s: float, mufu_per_s: float):
        self.imad_per_s = imad_per_s
        self.mufu_per_s = mufu_per_s
        self.scan_backward_ms = self.scan_backward_loop_ms = None
        self.rows = []            # one per compared case, for --out
        keys = tuple(KERNELS) + INT16_INSTANCES
        self.err = {k: 0.0 for k in keys}
        self.sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": None, "f32_reference_ms": None}
                     for k in keys}

    def record(self, counter, case, main, got, want, exact, kernel_fn,
               plain_fn, nbytes, flops, library_fn=None, rate=None,
               f32_reference_fn=None, close=None):
        """Compare, time and log one case.  ``rate`` is the peak for
        ``flops`` (f32 FLOP/s by default; IMAD/s for the int16 kernels,
        MUFU/s for the scan's exponentials); ``f32_reference_fn`` times an
        f32 library call on the same shapes, a reference point only, where
        no library computes the function; ``close(got, want)`` replaces the
        default ``DOT_TOL`` comparison of an inexact case, returning the
        error or failing."""
        rate = F32_FLOP_PER_S if rate is None else rate
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        err = 0.0
        for g, w in pairs:
            if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
                fail(f"{counter} {case}: {tuple(g.shape)}/{g.dtype} vs "
                     f"{tuple(w.shape)}/{w.dtype}")
            if exact:
                if not torch.equal(g, w):
                    fail(f"{counter} {case}: not bitwise equal to plain")
            elif close is not None:
                err = max(err, close(g, w))
            else:
                e = (g - w).abs().max().item()
                ref = w.abs().max().item()
                if not e <= DOT_TOL * ref:
                    fail(f"{counter} {case}: max|d| {e:.3e} > "
                         f"{DOT_TOL} * {ref:.3e}")
                err = max(err, e)
        ms = device_time_ms(kernel_fn)
        plain = device_time_ms(plain_fn)
        lib = device_time_ms(library_fn) if library_fn else None
        f32_ref = device_time_ms(f32_reference_fn) if f32_reference_fn \
            else None
        bnd = bound_ms(nbytes, flops, rate)
        self.err[counter] = max(self.err[counter], err)
        row = dict(kernel=counter, case=case, max_abs_err=err, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bytes=nbytes, flops=flops, rate=rate, main_path=main,
                   f32_reference_ms=f32_ref)
        self.rows.append(row)
        if main:
            s = self.sums[counter]
            s["ms"] += ms
            s["plain_ms"] += plain
            s["bound_ms"] += bnd
            # a library time only where every main-path shape has one
            if lib is None or s.get("no_library"):
                s["no_library"], s["library_ms"] = True, None
            else:
                s["library_ms"] = (s["library_ms"] or 0.0) + lib
            if f32_ref is not None:
                s["f32_reference_ms"] = (s["f32_reference_ms"] or 0.0) \
                    + f32_ref
        libs = (f" library {lib:.4f} (x{ms / lib:.2f})" if lib is not None
                else "")
        refs = f" f32-ref {f32_ref:.4f}" if f32_ref is not None else ""
        print(f"  {counter:20s} {case:34s} err {err:.2e}  kernel {ms:.4f} "
              f"plain {plain:.4f}{libs}{refs}  bound {bnd:.4f} ms")

    def summary(self):
        """One line per kernel: main-path sums per explain."""
        for k, s in self.sums.items():
            extra = "".join(f" {n} {s[n]:.4f}" for n in (
                "library_ms", "f32_reference_ms") if s[n] is not None)
            if s["library_ms"]:
                extra += f" (x{s['ms'] / s['library_ms']:.2f} of library)"
            print(f"  sum {k:20s} ms {s['ms']:.4f} plain_ms "
                  f"{s['plain_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
                  f"({_bound_by(self, k)}){extra}")


def randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _bitwise_repeat(counter, case, first, launches):
    """Fail unless every ``(what, fn)`` of ``launches`` returns ``first``
    bit for bit (the same inputs, launched again)."""
    for what, fn in launches:
        again = fn()
        torch.cuda.synchronize()
        if not torch.equal(again, first):
            fail(f"{counter} {case}: launched {what}, the bits differ")
    print(f"  {counter:20s} {case:34s} bitwise equal: "
          + "; ".join(what for what, _ in launches))


def check_kernels(kc: KernelCheck):
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (ConvPlan, conv2d,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv2d_planned, conv_plan)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.pool import maxpool_fwd
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                         relu_fwd,
                                                         unpack_bits)
    from repro_torch.kernels.tiling import crumb_bytes, mask_bytes
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import (vmm, vmm_bwd_fused,
                                             vmm_bwd_fused_plain, vmm_splits)
    from repro_torch.core import masks

    gen = torch.Generator(device="cuda").manual_seed(1234)
    n = BATCH

    # B1 conv forward: (H, Cin, Cout) of the four Table III layers, each
    # launched twice (bitwise equal run to run) and once more under
    # another tile plan (bitwise equal: no plan changes a sum's order)
    for h, cin, cout in ((32, 3, 32), (32, 32, 32), (16, 32, 64),
                         (16, 64, 64)):
        x = randn(gen, n, h, h, cin)
        w = randn(gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = randn(gen, cout, scale=0.1)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        nbytes = 4 * (x.numel() + w.numel() + cout + n * h * h * cout)
        flops = 2 * n * h * h * cout * 9 * cin
        case = f"[{n},{h},{h},{cin}->{cout}]"
        got = conv2d(x, w, b)
        plan = conv_plan(n, h, h, cin, cout, 3)
        other = ConvPlan(2 * plan.th, 4 if plan.px == 8 else 8, 16,
                         8 if cin % 4 == 0 else cin)
        _bitwise_repeat("conv2d_fwd", case, got, (
            (f"again under {plan}", lambda: conv2d(x, w, b)),
            (f"under {other}", lambda: conv2d_planned(x, w, b, plan=other))))
        kc.record("conv2d_fwd", case, True, got,
                  conv_ref.conv2d(x, w) + b, False,
                  lambda: conv2d(x, w, b), lambda: conv_ref.conv2d(x, w) + b,
                  nbytes, flops, lambda: F.conv2d(xn, wn, b, padding=1))

    # B2 relu + mask: the five rectifiers of the forward
    for r, c in ((n * 32 * 32, 32), (n * 32 * 32, 32), (n * 16 * 16, 64),
                 (n * 16 * 16, 64), (n, 128)):
        x = randn(gen, r, c)
        x[0] = 0.0                        # exact zeros: bit 0 (strict >)
        nbytes = 4 * 2 * r * c + r * mask_bytes(c)
        kc.record("relu_fwd", f"[{r},{c}]", True, relu_fwd(x),
                  relu_ref.relu_fwd(x), True, lambda: relu_fwd(x),
                  lambda: relu_ref.relu_fwd(x), nbytes, r * c)

    # B3 pool + argmax, on post-ReLU maps (many tied all-zero windows)
    for h, c in ((32, 32), (16, 64)):
        x = torch.clamp_min(randn(gen, n, h, h, c) - 0.5, 0)
        nbytes = (4 * x.numel() + 4 * x.numel() // 4
                  + n * (h // 2) ** 2 * crumb_bytes(c))
        kc.record("maxpool_fwd", f"[{n},{h},{h},{c}]", True, maxpool_fwd(x),
                  pool_ref.maxpool_fwd(x), True, lambda: maxpool_fwd(x),
                  lambda: pool_ref.maxpool_fwd(x), nbytes,
                  3 * x.numel() // 4)

    # B4 vmm: FC0 (split K) and FC1 (one slice) with bias, each launched
    # twice: bitwise equal run to run
    for k, m_out in ((4096, 128), (128, 10)):
        x = randn(gen, n, k)
        w = randn(gen, k, m_out, scale=(2.0 / k) ** 0.5)
        b = randn(gen, m_out, scale=0.1)
        nbytes = 4 * (x.numel() + w.numel() + m_out + n * m_out)
        case = f"[{n},{k}]@[{k},{m_out}]"
        got = vmm(x, w, b)
        _bitwise_repeat("vmm_fwd", case, got, (
            (f"again, K in {vmm_splits(n, k, m_out)} slice(s)",
             lambda: vmm(x, w, b)),))
        kc.record("vmm_fwd", case, True, got,
                  vmm_ref.vmm(x, w) + b, False, lambda: vmm(x, w, b),
                  lambda: vmm_ref.vmm(x, w) + b, nbytes, 2 * n * k * m_out,
                  lambda: torch.addmm(b, x, w))

    # B5 fused conv backward: (H, C, Cout', pooled) of layers 3, 2, 1, 0
    s = SEEDS
    for method in METHODS:
        for h, c, cout, pooled in ((16, 64, 64, True), (16, 64, 32, False),
                                   (32, 32, 32, True), (32, 32, 3, False)):
            y = randn(gen, n, h, h, c)                  # layer pre-activation
            mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
            idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                   if pooled else None)
            hg = h // 2 if pooled else h
            g = randn(gen, s, n, hg, hg, c, scale=1e-2)
            wt = randn(gen, 3, 3, c, cout, scale=(2.0 / (9 * c)) ** 0.5)
            kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method)
            gg = g
            if pooled:
                gg = pool_ref.unpool_scatter(masks.unpack_crumbs(idx, c), g)
            bits = None if mask is None else unpack_bits(mask)[..., :c]
            nnz = torch.count_nonzero(gate_gradient(gg, bits, method)).item()
            nbytes = (4 * (g.numel() + wt.numel() + s * n * h * h * cout)
                      + (idx.numel() if pooled else 0)
                      + (mask.numel() if mask is not None else 0))
            kc.record("conv2d_bwd_fused",
                      f"{method} [{s},{n},{hg},{hg},{c}]->{cout}"
                      + (" pool" if pooled else ""),
                      method == "saliency",
                      conv2d_bwd_fused(g, wt, **kw),
                      conv2d_bwd_fused_plain(g, wt, **kw), False,
                      lambda: conv2d_bwd_fused(g, wt, **kw),
                      lambda: conv2d_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * 9 * cout)
    # ... with the epilogue gate, and with no gate (the library yardstick)
    y = randn(gen, n, 16, 16, 64)
    prev = randn(gen, n, 16, 16, 32)
    g = randn(gen, s, n, 16, 16, 64, scale=1e-2)
    wt = randn(gen, 3, 3, 64, 32, scale=(2.0 / 576) ** 0.5)
    kw = dict(relu_mask=masks.pack_mask(y > 0), method="guided",
              out_relu_mask=masks.pack_mask(prev > 0))
    nbytes = 4 * (g.numel() * 1.5 + wt.numel()) + n * 256 * 12
    kc.record("conv2d_bwd_fused", "guided epilogue [3,32,16,16,64]->32",
              False, conv2d_bwd_fused(g, wt, **kw),
              conv2d_bwd_fused_plain(g, wt, **kw), False,
              lambda: conv2d_bwd_fused(g, wt, **kw),
              lambda: conv2d_bwd_fused_plain(g, wt, **kw), nbytes,
              2 * g.numel() * 9 * 32)
    gn = g.reshape(s * n, 16, 16, 64).permute(0, 3, 1, 2)
    wn = wt.permute(3, 2, 0, 1)      # wt is already flip-transposed
    kc.record("conv2d_bwd_fused", "no gate [3,32,16,16,64]->32", False,
              conv2d_bwd_fused(g, wt), conv2d_bwd_fused_plain(g, wt), False,
              lambda: conv2d_bwd_fused(g, wt),
              lambda: conv2d_bwd_fused_plain(g, wt),
              4 * (g.numel() * 1.5 + wt.numel()), 2 * g.numel() * 9 * 32,
              lambda: F.conv2d(gn, wn, padding=1))

    # B6 fused FC backward: FC1 (no gate) then FC0 (gate by its mask)
    for method in METHODS:
        for k, n_out, gated in ((10, 128, False), (128, 4096, True)):
            g = randn(gen, s, n, k)
            wt = randn(gen, k, n_out, scale=(2.0 / n_out) ** 0.5)
            mask = (masks.pack_mask(randn(gen, n, k) > 0)
                    if gated and method != "deconvnet" else None)
            kw = dict(relu_mask=mask, gate=gated, method=method)
            gg = g
            if gated:
                bits = None if mask is None else unpack_bits(mask)[:, :k]
                gg = gate_gradient(g, bits, method)
            nnz = torch.count_nonzero(gg).item()
            nbytes = (4 * (g.numel() + wt.numel() + s * n * n_out)
                      + (mask.numel() if mask is not None else 0))
            lib = None if gated else (lambda g=g, wt=wt: torch.matmul(g, wt))
            kc.record("vmm_bwd_fused",
                      f"{method} [{s},{n},{k}]@[{k},{n_out}]"
                      + (" gate" if gated else ""), method == "saliency",
                      vmm_bwd_fused(g, wt, **kw),
                      vmm_bwd_fused_plain(g, wt, **kw), False,
                      lambda: vmm_bwd_fused(g, wt, **kw),
                      lambda: vmm_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * n_out, lib)
    g = randn(gen, s, n, 128)
    wt = randn(gen, 128, 4096, scale=(2.0 / 4096) ** 0.5)
    kw = dict(relu_mask=masks.pack_mask(randn(gen, n, 128) > 0),
              method="saliency",
              out_relu_mask=masks.pack_mask(randn(gen, n, 4096) > 0))
    kc.record("vmm_bwd_fused", "saliency epilogue [3,32,128]@[128,4096]",
              False, vmm_bwd_fused(g, wt, **kw),
              vmm_bwd_fused_plain(g, wt, **kw), False,
              lambda: vmm_bwd_fused(g, wt, **kw),
              lambda: vmm_bwd_fused_plain(g, wt, **kw),
              4 * (g.numel() + wt.numel() + s * n * 4096),
              2 * g.numel() * 4096)


#: ``--sweep``: the B4 shapes (M, K, N) of the main and vjp paths, and the
#: B1 shapes (H, Cin, Cout) at batch 32: the Table III forward layers, then
#: the input gradients of the vjp path's standalone ops (B1 on the
#: flip-transposed weight).
SWEEP_VMM = ((32, 4096, 128), (32, 128, 10), (32, 128, 4096), (32, 10, 128))
SWEEP_CONV = {"fwd": ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64)),
              "dx": ((16, 64, 32), (32, 32, 3))}


def _sweep_plans(h, cin, cout):
    """A grid of B1 tile plans for one shape: rows, pixels a thread, Cout a
    block, Cin a stage, within the block's thread and memory limits."""
    from repro_torch.kernels.conv2d.conv2d import CONV_MAX_THREADS, ConvPlan
    from repro_torch.kernels.tiling import align_up
    cts = sorted({min(c, cin) if cin % 4 else min(c, cin) // 4 * 4
                  for c in (4, 8, 16, 32)} - {0})
    for th in (1, 2, 4, 8, 16, 32):
        for px in (4, 8):
            for tco in (4, 8, 16, 32, 64):
                for ct in cts:
                    p = ConvPlan(th, px, tco, ct)
                    if (th <= h and tco <= align_up(cout, 4)
                            and 32 <= p.threads <= CONV_MAX_THREADS
                            and p.smem_bytes(3) <= 227 * 1024):
                        yield p


def sweep_launch_choices(gen):
    """``--sweep``: time every listed B4 split and B1 tile plan beside the
    library call, and say where ``vmm_splits`` / ``conv_plan`` land.  Each
    split is held against the plain version at DOT_TOL; every plan of a
    shape must give the bits of ``conv_plan``'s."""
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import conv2d_planned, conv_plan
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import (vmm_max_splits, vmm_splits,
                                             vmm_with_splits)

    def close(got, want, what):
        torch.cuda.synchronize()
        e, ref = (got - want).abs().max().item(), want.abs().max().item()
        if not e <= DOT_TOL * ref:
            fail(f"sweep {what}: max|d| {e:.3e} > {DOT_TOL} * {ref:.3e}")

    rows = dict(vmm=[], conv=[])
    for m, k, n in SWEEP_VMM:
        x, w, b = randn(gen, m, k), randn(gen, k, n, scale=k ** -0.5), \
            randn(gen, n)
        lib = device_time_ms(lambda: torch.addmm(b, x, w))
        chosen = vmm_splits(m, k, n)
        for s in sorted({1, 2, 4, 8, 16, 32, 64, 96, 128, chosen}
                        & set(range(1, vmm_max_splits(k) + 1))):
            close(vmm_with_splits(x, w, b, splits=s), vmm_ref.vmm(x, w) + b,
                  f"vmm [{m},{k}]@[{k},{n}] splits {s}")
            ms = device_time_ms(lambda: vmm_with_splits(x, w, b, splits=s))
            rows["vmm"].append(dict(shape=[m, k, n], splits=s, ms=ms,
                                    library_ms=lib, chosen=s == chosen))
            print(f"  vmm [{m},{k}]@[{k},{n}] splits {s:4d}: {ms:.4f} ms "
                  f"(addmm {lib:.4f})"
                  + ("  <- vmm_splits" if s == chosen else ""))
    for kind, shapes in SWEEP_CONV.items():
        for h, cin, cout in shapes:
            x = randn(gen, BATCH, h, h, cin)
            w = randn(gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
            b = randn(gen, cout, scale=0.1)
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            lib = device_time_ms(lambda: F.conv2d(xn, wn, b, padding=1))
            chosen = conv_plan(BATCH, h, h, cin, cout, 3)
            first = conv2d_planned(x, w, b, plan=chosen)
            case = f"conv {kind} [{BATCH},{h},{h},{cin}->{cout}]"
            close(first, conv_ref.conv2d(x, w) + b, case)
            found = []
            for p in set(_sweep_plans(h, cin, cout)) | {chosen}:
                got = conv2d_planned(x, w, b, plan=p)
                torch.cuda.synchronize()
                if not torch.equal(got, first):
                    fail(f"sweep {case}: plan {p} changes the bits")
                found.append((device_time_ms(
                    lambda: conv2d_planned(x, w, b, plan=p)), p))
            found.sort(key=lambda t: (t[0], t[1].args()))
            rank = [p for _, p in found].index(chosen)
            print(f"  {case}: F.conv2d {lib:.4f} ms; conv_plan {chosen} "
                  f"{found[rank][0]:.4f} ms (rank {rank + 1} of "
                  f"{len(found)}); fastest:")
            for ms, p in found[:8]:
                print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d} "
                      f"blocks {p.blocks(BATCH, h, h, cout):5d} smem "
                      f"{p.smem_bytes(3)}")
            rows["conv"].append(dict(
                kind=kind, shape=[BATCH, h, h, cin, cout], library_ms=lib,
                chosen=chosen.args(), chosen_ms=found[rank][0],
                rank=rank + 1, plans=[dict(plan=p.args(), ms=ms)
                                      for ms, p in found]))
    return rows


def check_kernels_fxp(kc: KernelCheck):
    """The fxp16 path's kernels (B7-B10, int16 B2/B3), bitwise."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp,
                                                conv2d_bwd_fused_fxp_plain,
                                                conv2d_fxp)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.fxp import maxpool_fwd_fxp
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                         relu_fwd,
                                                         unpack_bits)
    from repro_torch.kernels.tiling import crumb_bytes, mask_bytes
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                             vmm_bwd_fused_fxp_plain,
                                             vmm_fxp)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    n, s, rate = BATCH, SEEDS, kc.imad_per_s
    lim = fixedpoint.INT16_LIM

    def qact(*shape, scale=1.0):
        return fixedpoint.to_fixed(randn(gen, *shape, scale=scale))

    def qwgt(*shape, scale):
        return fixedpoint.to_fixed(randn(gen, *shape, scale=scale),
                                   fixedpoint.WGT_FRAC)

    def rails(*shape):
        sign = torch.randint(0, 2, shape, generator=gen, device="cuda")
        return ((2 * sign - 1) * lim).to(torch.int16)

    def sat(y, b):
        return fixedpoint.sat_add(y, b)

    # B7 int16 conv forward (+ saturating bias): the four Table III layers
    for h, cin, cout in ((32, 3, 32), (32, 32, 32), (16, 32, 64),
                         (16, 64, 64)):
        x = torch.clamp_min(qact(n, h, h, cin), 0)   # post-ReLU, as fed
        w = qwgt(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = qact(cout, scale=0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        xn, wn = xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1)
        nbytes = 2 * (x.numel() + w.numel() + cout + n * h * h * cout)
        kc.record("conv2d_fxp_fwd", f"[{n},{h},{h},{cin}->{cout}]", True,
                  conv2d_fxp(x, w, b), sat(conv_ref.conv2d_fxp(x, w), b),
                  True, lambda: conv2d_fxp(x, w, b),
                  lambda: sat(conv_ref.conv2d_fxp(x, w), b), nbytes,
                  n * h * h * cout * 9 * cin, rate=rate,
                  f32_reference_fn=lambda: F.conv2d(xn, wn, bf, padding=1))
    x, w = rails(n, 16, 16, 64), rails(3, 3, 64, 64)   # 576 * 2^30 wraps
    kc.record("conv2d_fxp_fwd", "rails [32,16,16,64->64] wrap", False,
              conv2d_fxp(x, w), conv_ref.conv2d_fxp(x, w), True,
              lambda: conv2d_fxp(x, w), lambda: conv_ref.conv2d_fxp(x, w),
              2 * (x.numel() * 2 + w.numel()), x.numel() * 9 * 64,
              rate=rate)

    # int16 B2 relu + mask: the five rectifiers of the fxp16 forward
    for r, c in ((n * 32 * 32, 32), (n * 32 * 32, 32), (n * 16 * 16, 64),
                 (n * 16 * 16, 64), (n, 128)):
        x = qact(r, c)
        x[0] = 0                          # exact zeros: bit 0 (strict >)
        nbytes = 2 * 2 * r * c + r * mask_bytes(c)
        kc.record("relu_fwd_i16", f"[{r},{c}] int16", True, relu_fwd(x),
                  relu_ref.relu_fwd(x), True, lambda: relu_fwd(x),
                  lambda: relu_ref.relu_fwd(x), nbytes, r * c, rate=rate)

    # int16 B3 pool + argmax on post-ReLU int16 maps: ties on the grid
    for h, c in ((32, 32), (16, 64)):
        x = torch.clamp_min(qact(n, h, h, c, scale=0.05), 0)
        nbytes = (2 * x.numel() + 2 * x.numel() // 4
                  + n * (h // 2) ** 2 * crumb_bytes(c))
        kc.record("maxpool_fwd_i16", f"[{n},{h},{h},{c}] int16", True,
                  maxpool_fwd_fxp(x), pool_ref.maxpool_fwd(x), True,
                  lambda: maxpool_fwd_fxp(x),
                  lambda: pool_ref.maxpool_fwd(x), nbytes,
                  3 * x.numel() // 4, rate=rate)

    # B9 int16 FC forward (+ saturating bias): FC0 and FC1
    for k, m_out in ((4096, 128), (128, 10)):
        x = torch.clamp_min(qact(n, k), 0)
        w = qwgt(k, m_out, scale=(2.0 / k) ** 0.5)
        b = qact(m_out, scale=0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        nbytes = 2 * (x.numel() + w.numel() + m_out + n * m_out)
        kc.record("vmm_fxp_fwd", f"[{n},{k}]@[{k},{m_out}]", True,
                  vmm_fxp(x, w, b), sat(vmm_ref.vmm_fxp(x, w), b), True,
                  lambda: vmm_fxp(x, w, b),
                  lambda: sat(vmm_ref.vmm_fxp(x, w), b), nbytes,
                  n * k * m_out, rate=rate,
                  f32_reference_fn=lambda: torch.addmm(bf, xf, wf))
    x, w = rails(n, 4096), rails(4096, 128)           # 4096 * 2^30 wraps
    kc.record("vmm_fxp_fwd", "rails [32,4096]@[4096,128] wrap", False,
              vmm_fxp(x, w), vmm_ref.vmm_fxp(x, w), True,
              lambda: vmm_fxp(x, w), lambda: vmm_ref.vmm_fxp(x, w),
              2 * (x.numel() + w.numel() + n * 128), n * 4096 * 128,
              rate=rate)

    # B8 int16 fused conv backward: (H, C, Cout', pooled) of layers 3..0
    for method in METHODS:
        for h, c, cout, pooled in ((16, 64, 64, True), (16, 64, 32, False),
                                   (32, 32, 32, True), (32, 32, 3, False)):
            y = qact(n, h, h, c)                        # layer pre-activation
            mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
            idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                   if pooled else None)
            hg = h // 2 if pooled else h
            g = qact(s, n, hg, hg, c, scale=0.5)
            wt = qwgt(3, 3, c, cout, scale=(2.0 / (9 * c)) ** 0.5)
            kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method)
            gg = g
            if pooled:
                gg = pool_ref.unpool_scatter(masks.unpack_crumbs(idx, c), g)
            bits = None if mask is None else unpack_bits(mask)[..., :c]
            nnz = torch.count_nonzero(gate_gradient(gg, bits, method)).item()
            nbytes = (2 * (g.numel() + wt.numel() + s * n * h * h * cout)
                      + (idx.numel() if pooled else 0)
                      + (mask.numel() if mask is not None else 0))
            kc.record("conv2d_bwd_fused_fxp",
                      f"{method} [{s},{n},{hg},{hg},{c}]->{cout}"
                      + (" pool" if pooled else ""),
                      method == "saliency",
                      conv2d_bwd_fused_fxp(g, wt, **kw),
                      conv2d_bwd_fused_fxp_plain(g, wt, **kw), True,
                      lambda: conv2d_bwd_fused_fxp(g, wt, **kw),
                      lambda: conv2d_bwd_fused_fxp_plain(g, wt, **kw),
                      nbytes, nnz * 9 * cout, rate=rate)
    # ... with the epilogue gate after the requantize
    y, prev = qact(n, 16, 16, 64), qact(n, 16, 16, 32)
    g = qact(s, n, 16, 16, 64, scale=0.5)
    wt = qwgt(3, 3, 64, 32, scale=(2.0 / 576) ** 0.5)
    kw = dict(relu_mask=masks.pack_mask(y > 0), method="guided",
              out_relu_mask=masks.pack_mask(prev > 0))
    kc.record("conv2d_bwd_fused_fxp", "guided epilogue [3,32,16,16,64]->32",
              False, conv2d_bwd_fused_fxp(g, wt, **kw),
              conv2d_bwd_fused_fxp_plain(g, wt, **kw), True,
              lambda: conv2d_bwd_fused_fxp(g, wt, **kw),
              lambda: conv2d_bwd_fused_fxp_plain(g, wt, **kw),
              2 * (g.numel() * 1.5 + wt.numel()) + n * 256 * 12,
              g.numel() * 9 * 32, rate=rate)

    # B10 int16 fused FC backward: FC1 (no gate) then FC0 (gated)
    for method in METHODS:
        for k, n_out, gated in ((10, 128, False), (128, 4096, True)):
            g = qact(s, n, k, scale=4.0)
            wt = qwgt(k, n_out, scale=(2.0 / n_out) ** 0.5)
            mask = (masks.pack_mask(randn(gen, n, k) > 0)
                    if gated and method != "deconvnet" else None)
            kw = dict(relu_mask=mask, gate=gated, method=method)
            gg = g
            if gated:
                bits = None if mask is None else unpack_bits(mask)[:, :k]
                gg = gate_gradient(g, bits, method)
            nnz = torch.count_nonzero(gg).item()
            nbytes = (2 * (g.numel() + wt.numel() + s * n * n_out)
                      + (mask.numel() if mask is not None else 0))
            kc.record("vmm_bwd_fused_fxp",
                      f"{method} [{s},{n},{k}]@[{k},{n_out}]"
                      + (" gate" if gated else ""), method == "saliency",
                      vmm_bwd_fused_fxp(g, wt, **kw),
                      vmm_bwd_fused_fxp_plain(g, wt, **kw), True,
                      lambda: vmm_bwd_fused_fxp(g, wt, **kw),
                      lambda: vmm_bwd_fused_fxp_plain(g, wt, **kw),
                      nbytes, nnz * n_out, rate=rate)
    g = qact(s, n, 128, scale=4.0)
    wt = qwgt(128, 4096, scale=(2.0 / 4096) ** 0.5)
    kw = dict(relu_mask=masks.pack_mask(randn(gen, n, 128) > 0),
              method="saliency",
              out_relu_mask=masks.pack_mask(randn(gen, n, 4096) > 0))
    kc.record("vmm_bwd_fused_fxp", "saliency epilogue [3,32,128]@[128,4096]",
              False, vmm_bwd_fused_fxp(g, wt, **kw),
              vmm_bwd_fused_fxp_plain(g, wt, **kw), True,
              lambda: vmm_bwd_fused_fxp(g, wt, **kw),
              lambda: vmm_bwd_fused_fxp_plain(g, wt, **kw),
              2 * (g.numel() + wt.numel() + s * n * 4096),
              g.numel() * 4096, rate=rate)


def check_kernels_autograd(kc: KernelCheck):
    """B11 (three methods) and B12 (f32 and int16) at the shapes of the
    unfused backward, bitwise: they select and route, so any difference is
    a fault.  No PyTorch call computes either; ``F.max_unpool2d`` on the
    same routing (NCHW, int64 flat indices) is timed as a reference point."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.fxp import unpool_bwd_fxp
    from repro_torch.kernels.pool.pool import maxpool_fwd, unpool_bwd
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import relu_bwd, relu_fwd
    from repro_torch.kernels.tiling import mask_bytes

    gen = torch.Generator(device="cuda").manual_seed(2468)
    n = BATCH
    # B11: the five rectifiers of one unfused backward pass
    for method in METHODS:
        for r, c in ((n * 32 * 32, 32), (n * 32 * 32, 32), (n * 16 * 16, 64),
                     (n * 16 * 16, 64), (n, 128)):
            _, m = relu_fwd(randn(gen, r, c))
            m = None if method == "deconvnet" else m     # reads no mask
            g = randn(gen, r, c, scale=1e-2)
            g[0] = 0.0                    # exact zeros: g > 0 is strict
            nbytes = 4 * 2 * r * c + (0 if m is None else r * mask_bytes(c))
            kc.record("relu_bwd", f"{method} [{r},{c}]", method == "saliency",
                      relu_bwd(m, g, method), relu_ref.relu_bwd(m, g, method),
                      True, lambda: relu_bwd(m, g, method),
                      lambda: relu_ref.relu_bwd(m, g, method), nbytes, r * c)

    # B12: the two pools' unpool, on post-ReLU maps (tied zero windows)
    for h, c in ((32, 32), (16, 64)):
        hp = h // 2
        _, idx = maxpool_fwd(torch.clamp_min(randn(gen, n, h, h, c) - 0.5, 0))
        k = masks.unpack_crumbs(idx, c).permute(0, 3, 1, 2).to(torch.int64)
        ii = torch.arange(hp, device="cuda")
        flat = (2 * ii[:, None] + k // 2) * h + 2 * ii[None, :] + k % 2
        for dtype in (torch.float32, torch.int16):
            g = randn(gen, n, hp, hp, c, scale=1e-2)
            name, fn, size = "unpool_bwd", unpool_bwd, 4
            lib = None
            if dtype == torch.int16:
                g = fixedpoint.to_fixed(g * 100)
                name, fn, size = "unpool_bwd_i16", unpool_bwd_fxp, 2
            else:
                gn = g.permute(0, 3, 1, 2).contiguous()
                out = F.max_unpool2d(gn, flat, 2, output_size=(h, h))
                if not torch.equal(out.permute(0, 2, 3, 1),
                                   pool_ref.unpool_bwd(idx, g)):
                    fail("F.max_unpool2d on the crumbs' routing differs from "
                         "the plain unpool")

                def lib(gn=gn):
                    return F.max_unpool2d(gn, flat, 2, output_size=(h, h))
            nbytes = size * 5 * g.numel() + idx.numel()
            kc.record(name, f"[{n},{hp},{hp},{c}]->[{n},{h},{h},{c}]"
                      + (" int16" if dtype == torch.int16 else ""), True,
                      fn(idx, g), pool_ref.unpool_bwd(idx, g), True,
                      lambda: fn(idx, g), lambda: pool_ref.unpool_bwd(idx, g),
                      nbytes, 4 * g.numel(), f32_reference_fn=lib)


def _scan_close(got, want, what="selective_scan"):
    """|got - want| <= SCAN_ATOL + rtol * |want| elementwise (rtol one bf16
    step for a bf16 y); returns the largest |got - want|."""
    rtol = SCAN_BF16_RTOL if got.dtype == torch.bfloat16 else SCAN_RTOL
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not bool((d <= SCAN_ATOL + rtol * w.abs()).all()):
        fail(f"{what}: max|d| {d.max().item():.3e} beyond atol "
             f"{SCAN_ATOL} + rtol {rtol}")
    return d.max().item()


def check_kernels_scan(kc: KernelCheck):
    """B13 at falcon-mamba-7b's explain shape (B = 4 prompts, S = 72, D =
    8192, N = 16; x bf16 on the main path, f32 beside it), a ragged S = 13,
    and two knob pairs that must agree bit for bit.  No PyTorch call
    computes the scan: the library column is none.  The plain backward of
    the scan (autograd over the chunked scan, ``ssm_scan/ops.py``) is timed
    beside it."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan

    gen = torch.Generator(device="cuda").manual_seed(1357)
    b, d, n = LM_BATCH, 8192, 16
    tiles = ((d, 128), (256, 64))     # the explain's knobs, the default's

    def inputs(s, dtype):
        dt = F.softplus(randn(gen, b, s, d) - 4.6)      # as dt_bias sets
        x = randn(gen, b, s, d).to(dtype)
        return (dt, x, randn(gen, b, s, n), randn(gen, b, s, n),
                -torch.exp(randn(gen, d, n) * 0.3), randn(gen, b, d, n))

    for s, dtype in ((LM_PROMPT + LM_NEW, torch.bfloat16),
                     (LM_PROMPT + LM_NEW, torch.float32),
                     (13, torch.bfloat16)):
        args = inputs(s, dtype)
        xs = args[1].element_size()
        nbytes = (4 * b * s * d + 2 * xs * b * s * d + 2 * 4 * b * d * n
                  + 4 * d * n + 2 * 4 * b * s * n)
        main = s == LM_PROMPT + LM_NEW and dtype == torch.bfloat16
        got = [selective_scan(*args, d_tile=dtl, chunk=ck)
               for dtl, ck in tiles]
        torch.cuda.synchronize()
        for y, h in got[1:]:
            if not (torch.equal(y, got[0][0]) and torch.equal(h, got[0][1])):
                fail(f"selective_scan: knobs {tiles} change the bits")
        case = (f"[{b},{s},{d}]x[{d},{n}] "
                + ("bf16" if dtype == torch.bfloat16 else "f32"))
        kc.record("selective_scan", case, main, got[0],
                  scan_ref.selective_scan(*args), False,
                  lambda: selective_scan(*args, d_tile=d, chunk=128),
                  lambda: scan_ref.selective_scan(*args), nbytes,
                  b * s * d * n, rate=kc.mufu_per_s, close=_scan_close)
        if main:
            leaves = [t.detach().requires_grad_() for t in args]
            y, _ = scan_ops.selective_scan(*leaves, d_tile=d, chunk=128)
            gy = randn(gen, *y.shape).to(y.dtype)

            def backward():
                torch.autograd.grad(y, leaves, gy, retain_graph=True)

            kc.scan_backward_ms = _span_ms(backward)
            # the JAX package's form: autograd over the sequential loop
            y_loop, _ = scan_ref.selective_scan(*leaves)

            def backward_loop():
                torch.autograd.grad(y_loop, leaves, gy, retain_graph=True)

            kc.scan_backward_loop_ms = _span_ms(backward_loop)
            print(f"  {'(plain backward)':20s} {case:34s} autograd over the "
                  f"chunked scan (the port's): {kc.scan_backward_ms:.4f} ms "
                  f"per layer; over the sequential loop (the JAX "
                  f"package's form): {kc.scan_backward_loop_ms:.4f} ms")
    print(f"  selective_scan knobs {tiles[0]} and {tiles[1]}: bitwise equal")


def _span_ms(fn, reps: int = 5) -> float:
    """Median time from a CUDA event before ``fn()`` to one after it, each
    run on its own: for host-bound calls (thousands of launches), where
    queueing runs back to back behind a sleep would only time the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases 3-4: the engine, end to end
# ---------------------------------------------------------------------------

#: kernel launches per explain (forward + one seed-batched backward), per
#: path; every other counter must stay at 0
PER_EXPLAIN = {
    "f32": {"conv2d_fwd": 4, "relu_fwd": 5, "maxpool_fwd": 2, "vmm_fwd": 2,
            "conv2d_bwd_fused": 4, "vmm_bwd_fused": 2},
    "fxp16": {"conv2d_fxp_fwd": 4, "relu_fwd": 5, "maxpool_fwd": 2,
              "vmm_fxp_fwd": 2, "conv2d_bwd_fused_fxp": 4,
              "vmm_bwd_fused_fxp": 2},
}


def _residual_bit_flips(res_a, res_b):
    flips = total = 0
    tensors = [t for pair in zip(res_a["conv"], res_b["conv"])
               for t in zip(*pair)] + list(zip(res_a["fc"], res_b["fc"]))
    for a, b in tensors:
        if (a is None) != (b is None):
            fail("residual structure differs between card and CPU")
        if a is None:
            continue
        if a.shape != b.shape or a.dtype != torch.uint8:
            fail(f"residual bytes {tuple(a.shape)} vs {tuple(b.shape)}")
        x = torch.bitwise_xor(a.cpu(), b.cpu()).to(torch.int32)
        flips += sum(int(((x >> j) & 1).sum()) for j in range(8))
        total += 8 * a.numel()
    return flips, total


def check_engine(params, cfg, x_cpu, precision, to_profile):
    """Phase 3 for one path.  f32 within the stated tolerances; fxp16 is
    integer arithmetic, so logits, every residual bit, the relevance and
    both cross-replays must equal the CPU twin's bit for bit."""
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import cnn

    exact = precision == "fxp16"
    x = x_cpu.cuda()
    results = {}
    for method in METHODS:
        spec = dict(method=method, precision=precision, targets=TopK(SEEDS))
        eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"), **spec))
        twin = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        before = dict(LAUNCHES)
        logits, rel, res = eng.predict_then_explain(x)
        torch.cuda.synchronize()
        rose = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {k: 0 for k in LAUNCHES}
        want.update(PER_EXPLAIN[precision])
        if method == "deconvnet":
            want["relu_fwd"] = 0         # Table II: no mask stored
        if rose != want:
            fail(f"{precision} {method}: launches per explain {rose}, "
                 f"want {want}")
        if tuple(rel.shape) != (SEEDS, BATCH, 32, 32, 3) or not bool(
                torch.isfinite(rel).all()):
            fail(f"{method}: relevance {tuple(rel.shape)} not finite/shaped")

        logits_c, rel_c, res_c = twin.predict_then_explain(x_cpu)
        err = (logits.cpu() - logits_c).abs().max().item()
        ref = logits_c.abs().max().item()
        if not err <= (0.0 if exact else DOT_TOL * ref):
            fail(f"{precision} {method}: logits card vs CPU {err:.3e}")
        flips, bits = _residual_bit_flips(res, res_c)
        if flips > (0 if exact else (1 - MIN_BIT_AGREEMENT) * bits):
            fail(f"{precision} {method}: {flips} of {bits} residual bits "
                 f"differ")
        seeds_c, _ = twin._seeds(logits_c, None, SEEDS)
        rel_x = eng.replay(cnn.residuals_to(res_c, "cuda"), seeds_c.cuda())
        rerr = (rel_x.cpu() - rel_c).abs().max().item()
        rref = rel_c.abs().max().item()
        if not rerr <= (0.0 if exact else REPLAY_TOL * rref):
            fail(f"{precision} {method}: cross-replay {rerr:.3e} "
                 f"(max|rel| {rref:.3e})")
        direct = (rel.cpu() - rel_c).abs().max().item()
        if exact:
            back = twin.replay(cnn.residuals_to(res, "cpu"), seeds_c)
            if direct != 0.0 or not torch.equal(back, rel.cpu()):
                fail(f"fxp16 {method}: relevance or the CPU's replay of the "
                     f"card's residuals differs from the card's")

        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.explain(x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = statistics.median(times[2:])
        dev_ms = device_time_ms(lambda: eng.explain(x), reps=10)
        if method == "saliency":
            to_profile.append((f"{precision} {method} explain",
                               lambda eng=eng: eng.explain(x), dev_ms))
        results[method] = dict(logits_err=err, bit_flips=flips, bits=bits,
                               cross_replay_err=rerr,
                               card_vs_cpu_rel_err=direct, rel_max=rref,
                               explain_ms_host=ms, explain_ms_device=dev_ms,
                               launches_per_explain=rose)
        print(f"  {precision:5s} {method:9s} logits err {err:.2e}  "
              f"bit flips {flips}/{bits}"
              f"  cross-replay err {rerr:.2e} (max|rel| {rref:.2e})  "
              f"card-vs-CPU rel err {direct:.2e}  explain {ms:.3f} ms "
              f"host, {dev_ms:.3f} ms device (batch {BATCH}, top-{SEEDS})")
    return results


def serve_requests(params, cfg, x_cpu, precision):
    from repro_torch.engine import CNNModel, EngineSpec, build

    eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                           method="guided", precision=precision))
    x = x_cpu.cuda()
    n_req = 0

    def ok(t, shape):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            fail(f"request {n_req}: {tuple(t.shape)} != {shape} or "
                 f"not finite")

    for lo, hi in ((0, 1), (1, 9)):                       # 2 predicts
        n_req += 1
        ok(eng.predict(x[lo:hi]), (hi - lo, 10))
    for lo, hi in ((9, 10), (10, 14)):                    # 2 argmax explains
        n_req += 1
        logits, rel = eng.explain(x[lo:hi])
        ok(logits, (hi - lo, 10))
        ok(rel, (hi - lo, 32, 32, 3))
    for lo, hi in ((14, 15), (15, 32)):                   # 2 top-3 explains
        n_req += 1
        logits, rel = eng.explain(x[lo:hi], topk=3)
        ok(rel, (3, hi - lo, 32, 32, 3))
    n_req += 1                                            # explain + keep
    logits, rel, res = eng.predict_then_explain(x[:8])
    ok(rel, (8, 32, 32, 3))
    n_req += 1                                            # replay another
    other = (torch.argmax(logits, -1) + 1) % 10
    seeds = F.one_hot(other, 10).to(torch.float32)[None]
    replayed = eng.replay(res, seeds)[0]
    _, cold = eng.explain(x[:8], target=other)
    torch.cuda.synchronize()
    if not torch.equal(replayed, cold):
        fail("replay of a target differs from its cold explain")
    if torch.equal(replayed, rel):
        fail("replay of another target returned the first target's map")
    print(f"  {precision}: {n_req} requests served; replay == cold "
          f"explain bitwise")
    return n_req


# ---------------------------------------------------------------------------
# phases 5-6: the autograd paths
# ---------------------------------------------------------------------------

#: kernel launches per vjp explain with SEEDS seeds (one forward, then one
#: backward pass per seed), per branch; every other counter stays at 0
PER_EXPLAIN_VJP = {
    # (a) fused blocks: B5/B6 at S = 1 for dx, no weight gradient asked for
    "vjp_fused": {"conv2d_fwd": 4, "relu_fwd": 5, "maxpool_fwd": 2,
                  "vmm_fwd": 2, "conv2d_bwd_fused": 4 * SEEDS,
                  "vmm_bwd_fused": 2 * SEEDS},
    # (b) standalone ops: B1/B4 reused for dx (Table I), B11 at the five
    # rectifiers, B12 at the two pools
    "vjp_unfused": {"conv2d_fwd": 4 + 4 * SEEDS, "relu_fwd": 5,
                    "maxpool_fwd": 2, "vmm_fwd": 2 + 2 * SEEDS,
                    "relu_bwd": 5 * SEEDS, "unpool_bwd": 2 * SEEDS},
}
#: kernel launches per training step (autodiff: the ReLU is torch.maximum,
#: no mask; dx of conv layers 1-3 and both FC layers on B1/B4)
PER_TRAIN_STEP = {"conv2d_fwd": 4 + 3, "maxpool_fwd": 2, "vmm_fwd": 2 + 2,
                  "unpool_bwd": 2}
TRAIN_STEPS, TRAIN_LR = 3, 1e-3


def _count(fn, totals):
    """Run ``fn`` with the counters set to 0; add what it launched to
    ``totals`` and return ``(result, launches)``."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    rose = dict(LAUNCHES)
    for k, v in rose.items():
        totals[k] = totals.get(k, 0) + v
    return out, rose


def _expect(rose, want, what):
    from repro_torch.kernels import LAUNCHES
    full = {k: 0 for k in LAUNCHES}
    full.update(want)
    if rose != full:
        fail(f"{what}: launches {rose}, want {full}")


def _flipped_examples(res_a, res_b):
    """Indices of the examples whose stored residual bits differ."""
    tensors = [t for pair in zip(res_a["conv"], res_b["conv"])
               for t in zip(*pair)] + list(zip(res_a["fc"], res_b["fc"]))
    bad = torch.zeros(BATCH, dtype=torch.bool)
    for a, b in tensors:
        if a is not None:
            diff = torch.bitwise_xor(a.cpu(), b.cpu()) != 0
            bad |= diff.reshape(diff.shape[0], -1).any(dim=1)
    return bad


def _host_device_ms(fn):
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    host = statistics.median(times[2:])
    # autograd's host work can outlast the default sleep: cover it
    return host, device_time_ms(fn, reps=10, cover_ms=max(50.0, 30 * host))


def check_vjp(params, cfg, x_cpu, launches, to_profile):
    """Phase 5: the vjp backend on both kernel branches, per method."""
    from repro_torch.engine import CNNModel, EngineSpec, FnModel, TopK, build
    from repro_torch.models import cnn

    def unfused(p):
        return lambda m: (lambda v: cnn.apply(p, v, cfg, method=m,
                                              use_pallas=True, fused=False))

    make_card, make_cpu = unfused(cnn.params_to(params, "cuda")), \
        unfused(params)
    x = x_cpu.cuda()
    results = {}
    for method in METHODS:
        spec = dict(method=method, targets=TopK(SEEDS))
        pair = build(EngineSpec(CNNModel(params, cfg, device="cuda"), **spec))
        logits_sb, rel_sb, res = pair.predict_then_explain(x)
        twin = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        _, _, res_c = twin.predict_then_explain(x_cpu)
        # the CPU's backward on the card's stored bits, for every example
        rel_x = twin.replay(cnn.residuals_to(res, "cpu"),
                            pair._seeds(logits_sb, None, SEEDS)[0].cpu())
        bad = _flipped_examples(res, res_c)
        keep = ~bad
        spec["backward"] = "vjp"
        for branch, card, cpu in (
                ("vjp_fused", CNNModel(params, cfg, device="cuda"),
                 CNNModel(params, cfg, device="cpu")),
                ("vjp_unfused", FnModel(make_card, device="cuda"),
                 FnModel(make_cpu, device="cpu"))):
            eng = build(EngineSpec(card, **spec))
            (logits, rel), rose = _count(lambda: eng.explain(x),
                                         launches.setdefault(branch, {}))
            want = dict(PER_EXPLAIN_VJP[branch])
            if branch == "vjp_fused" and method == "deconvnet":
                want["relu_fwd"] = 0          # Table II: no mask stored
            _expect(rose, want, f"{branch} {method} explain")
            if tuple(rel.shape) != (SEEDS, BATCH, 32, 32, 3) or not bool(
                    torch.isfinite(rel).all()):
                fail(f"{branch} {method}: relevance {tuple(rel.shape)} not "
                     f"finite/shaped")
            err_sb = (logits - logits_sb).abs().max().item()
            rerr_sb = (rel - rel_sb).abs().max().item()
            if not (err_sb <= DOT_TOL * logits_sb.abs().max().item()
                    and rerr_sb <= REPLAY_TOL * rel_sb.abs().max().item()):
                fail(f"{branch} {method}: vs the seed-batched engine logits "
                     f"{err_sb:.3e}, relevance {rerr_sb:.3e}")
            logits_c, rel_c = build(EngineSpec(cpu, **spec)).explain(x_cpu)
            err = (logits.cpu() - logits_c).abs().max().item()
            if not err <= DOT_TOL * logits_c.abs().max().item():
                fail(f"{branch} {method}: logits card vs CPU {err:.3e}")
            rref = rel_c.abs().max().item()
            rerr = (rel.cpu() - rel_c)[:, keep].abs().max().item()
            if not rerr <= REPLAY_TOL * rref:
                fail(f"{branch} {method}: relevance card vs CPU {rerr:.3e} "
                     f"(max|rel| {rref:.3e})")
            rerr_all = (rel.cpu() - rel_c).abs().max().item()
            xerr = (rel.cpu() - rel_x).abs().max().item()
            if not xerr <= REPLAY_TOL * rel_x.abs().max().item():
                fail(f"{branch} {method}: relevance vs the CPU replay of the "
                     f"card's residuals {xerr:.3e}")
            ms, dev_ms = _host_device_ms(lambda: eng.explain(x))
            if method == "saliency":
                to_profile.append((f"{branch} {method} explain",
                                   lambda eng=eng: eng.explain(x), dev_ms))
            results[f"{branch} {method}"] = dict(
                logits_err=err, rel_err=rerr, rel_err_all=rerr_all,
                rel_err_cpu_replay=xerr, rel_max=rref,
                flipped_examples=int(bad.sum()),
                vs_seed_batched=(err_sb, rerr_sb), explain_ms_host=ms,
                explain_ms_device=dev_ms, launches_per_explain=rose)
            print(f"  {branch:11s} {method:9s} logits err {err:.2e}  rel err "
                  f"{rerr:.2e} on {int(keep.sum())} examples ({rerr_all:.2e} "
                  f"on all {BATCH}; max|rel| {rref:.2e}), {xerr:.2e} vs the "
                  f"CPU replay of the card's bits  vs seed-batched "
                  f"{err_sb:.2e}/{rerr_sb:.2e}  explain {ms:.3f} ms host, "
                  f"{dev_ms:.3f} ms device")
    return results


def check_train(params, cfg, x_cpu, launches, to_profile):
    """Phase 6: AdamW steps of the autodiff loss on the kernel path."""
    from repro_torch import optim
    from repro_torch.models import cnn

    y_cpu = torch.randint(0, cfg.num_classes, (BATCH,),
                          generator=torch.Generator().manual_seed(2))

    def loss_and_grads(p, x, y):
        p = {k: [{n: t.detach().requires_grad_() for n, t in q.items()}
                 for q in v] for k, v in p.items()}
        leaves = [q[n] for k in ("conv", "fc") for q in p[k]
                  for n in ("w", "b")]
        loss = F.cross_entropy(cnn.apply(p, x, cfg, use_pallas=True), y)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def tree(flat):
        it = iter(flat)
        return {k: [{n: next(it) for n in ("w", "b")} for _ in params[k]]
                for k in ("conv", "fc")}

    p = cnn.params_to(params, "cuda")
    state = optim.adamw_init(p)
    x, y = x_cpu.cuda(), y_cpu.cuda()
    losses, errs = [], []
    for step in range(TRAIN_STEPS):
        (loss, grads), rose = _count(lambda: loss_and_grads(p, x, y),
                                     launches.setdefault("train", {}))
        _expect(rose, PER_TRAIN_STEP, f"train step {step}")
        p_cpu = cnn.params_to(p, "cpu")
        _, res = cnn.forward_with_residuals(p, x, cfg, "saliency")
        _, res_c = cnn.forward_with_residuals(p_cpu, x_cpu, cfg, "saliency")
        keep = ~_flipped_examples(res, res_c)
        g_card, g_cpu = grads, loss_and_grads(p_cpu, x_cpu, y_cpu)[1]
        if not bool(keep.all()):      # compare on the agreeing examples
            g_card = loss_and_grads(p, x[keep.cuda()], y[keep.cuda()])[1]
            g_cpu = loss_and_grads(p_cpu, x_cpu[keep], y_cpu[keep])[1]
        worst = 0.0
        for i, (g, g_c) in enumerate(zip(g_card, g_cpu)):
            if not bool(torch.isfinite(g).all()):
                fail(f"train step {step}: gradient {i} not finite")
            e = (g.cpu() - g_c).abs().max().item()
            ref = g_c.abs().max().item()
            if not e <= REPLAY_TOL * ref:
                fail(f"train step {step}: gradient {i} card vs CPU {e:.3e} "
                     f"(max|g| {ref:.3e})")
            worst = max(worst, e / ref)
        losses.append(loss.item())
        errs.append(worst)
        print(f"  train step {step}: loss {loss.item():.6f}  grads card vs "
              f"CPU max rel err {worst:.2e} on {int(keep.sum())} of {BATCH} "
              f"examples")
        p, state = optim.adamw_update(tree(grads), state, p, lr=TRAIN_LR)

    def step_fn():
        optim.adamw_update(tree(loss_and_grads(p, x, y)[1]), state, p,
                           lr=TRAIN_LR)

    ms, dev_ms = _host_device_ms(step_fn)
    print(f"  train step {ms:.3f} ms host, {dev_ms:.3f} ms device "
          f"(batch {BATCH}, forward + backward + AdamW)")
    to_profile.append(("train step", step_fn, dev_ms))
    return dict(losses=losses, grad_rel_err=errs, step_ms_host=ms,
                step_ms_device=dev_ms)


# ---------------------------------------------------------------------------
# phases 7-8: LM token attribution (falcon-mamba-7b)
# ---------------------------------------------------------------------------


def _finite(t, what, shape=None):
    if shape is not None and tuple(t.shape) != tuple(shape):
        fail(f"{what}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not bool(torch.isfinite(t).all()):
        fail(f"{what}: not finite")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def check_lm(launches, to_profile):
    """Phase 7: falcon-mamba-7b, FULL config (64 layers, d_model 4096,
    d_inner 8192, N 16, vocab 65024, bf16), random weights."""
    from repro_torch import configs, lm
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.models import transformer as tf

    cfg = configs.get(LM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init(cfg, generator=torch.Generator(device="cuda")
                     .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(device="cuda")
                            .manual_seed(1), device="cuda")
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({cfg.param_count() / 1e9:.3f} B analytic), "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"drawn in {init_s:.1f} s")
    totals = launches.setdefault("lm", {})
    per_explain = {"selective_scan": cfg.n_layers}

    # greedy decode, twice: no B13 launch, the same tokens
    res, rose = _count(lambda: lm.decode(params, cfg, prompts,
                                         max_new=LM_NEW), {})
    _expect(rose, {}, "lm decode")
    again = lm.decode(params, cfg, prompts, max_new=LM_NEW)
    if not torch.equal(again.tokens, res.tokens):
        fail("lm: a second greedy decode gave other tokens")
    s_full = LM_PROMPT + LM_NEW
    if tuple(res.tokens.shape) != (LM_BATCH, s_full) or bool(
            (res.generated == res.runners_up).any()):
        fail("lm: decode result malformed")

    # one contrastive explain per generated token, S = 72
    scores, rose = _count(lambda: lm.explain_generated(params, cfg, res),
                          totals)
    _expect(rose, {"selective_scan": cfg.n_layers * LM_NEW},
            "lm explain_generated")
    _finite(scores, "lm per-token scores", (LM_BATCH, LM_NEW, s_full))
    for t in range(LM_NEW):
        if not bool((scores[:, t, LM_PROMPT + t:] == 0).all()):
            fail(f"lm: scores after the seed of token {t} are not 0")
        if not bool((scores[:, t, :LM_PROMPT + t] != 0).any()):
            fail(f"lm: token {t} has no relevance before its seed")

    # contrastive == ixg(a) - ixg(b), on the last generated token
    t, pos = LM_NEW - 1, LM_PROMPT + LM_NEW - 2
    ixg = lm.make_token_explain(cfg, mode="ixg")
    (sa, sb), rose = _count(lambda: (
        ixg(params, res.tokens, pos, res.tokens[:, pos + 1], None),
        ixg(params, res.tokens, pos, res.runners_up[:, t], None)), totals)
    _expect(rose, {"selective_scan": 2 * cfg.n_layers}, "lm ixg explains")
    lin_err = ((scores[:, t] - (sa - sb)).abs().max().item()
               / max(sa.abs().max().item(), sb.abs().max().item()))
    if not lin_err <= LM_LINEARITY_TOL:
        fail(f"lm: contrastive vs ixg(a) - ixg(b): {lin_err:.3e}")

    # the engine, on the prompts: three modes (saliency), two more methods
    results = {}
    for method, mode in (("saliency", "ixg"), ("saliency", "grad_norm"),
                         ("saliency", "contrastive"), ("deconvnet", "ixg"),
                         ("guided", "ixg")):
        eng = build(EngineSpec(LMModel(params, cfg), method=method))
        (lg, sc), rose = _count(lambda: eng.explain_tokens(
            {"tokens": prompts}, mode=mode), totals)
        _expect(rose, per_explain, f"lm engine {method} {mode}")
        _finite(lg, f"lm {method} {mode} logits", (LM_BATCH, cfg.vocab))
        _finite(sc, f"lm {method} {mode} scores", (LM_BATCH, LM_PROMPT))
        results[f"{method} {mode}"] = dict(max_abs_score=sc.abs().max()
                                           .item())
        if (method, mode) == ("saliency", "ixg"):
            with torch.no_grad():           # the chunked scan, no B13
                h = tf.embed_inputs(params, cfg, {"tokens": prompts})
                ref = tf.forward_from_embeddings(params, cfg, h)[0][:, -1]
                ref32 = _f32_last_logits(params, cfg, prompts)
            logit_err = _rel_err(lg, ref)
            chunk_err = _rel_err(ref, ref32)
            if not logit_err <= LM_LOGITS_FACTOR * chunk_err:
                fail(f"lm: B13-route logits vs the chunked scan's "
                     f"{logit_err:.3e} of max|logit|, beyond "
                     f"{LM_LOGITS_FACTOR} x the chunked route's bf16 error "
                     f"{chunk_err:.3e}")
            layer_errs = _b13_layer_errs(params, cfg, prompts)
            same_argmax = float((lg.argmax(-1) == ref.argmax(-1)).float()
                                .mean())
            eng_ixg = eng

    # times: a decode step, a per-token explain, an engine explain
    cache = tf.init_cache(cfg, LM_BATCH, s_full, device="cuda")
    with torch.no_grad():
        _, cache = tf.prefill(params, cfg, {"tokens": res.tokens[:, :-1]},
                              cache)
    last = res.tokens[:, -1:]

    def step():
        with torch.no_grad():
            tf.decode_step(params, cfg, last, cache, s_full - 1)

    contrastive = lm.make_token_explain(cfg, mode="contrastive")

    def token_explain():
        contrastive(params, res.tokens, pos, res.tokens[:, pos + 1],
                    res.runners_up[:, t])

    def engine_explain():
        eng_ixg.explain_tokens({"tokens": prompts})

    times = {}
    for what, fn in (("decode step", step),
                     ("per-token explain (S=72)", token_explain),
                     ("engine explain (S=64)", engine_explain)):
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
        dev = _span_ms(fn, reps=3)
        times[what] = dict(host_ms=statistics.median(host), device_ms=dev)
        print(f"  lm {what}: {statistics.median(host):.2f} ms host, "
              f"{dev:.2f} ms device span")
    to_profile.append(("lm decode step", step, times["decode step"]
                       ["device_ms"]))
    to_profile.append(("lm per-token explain", token_explain,
                       times["per-token explain (S=72)"]["device_ms"]))
    print(f"  lm: decode x2 equal, {LM_NEW} per-token explains + 2 ixg + "
          f"5 engine explains, {cfg.n_layers} B13 launches each and none "
          f"in decode; causal zeros exact; contrastive vs ixg difference "
          f"{lin_err:.2e}; B13 vs the chunked scan in each layer's "
          f"forward: max|dy| {max(layer_errs):.2e}; B13 vs chunked logits "
          f"{logit_err:.2e} of max (chunked vs f32 weights {chunk_err:.2e}; "
          f"argmax agrees on {same_argmax:.2f})")
    return dict(init_s=init_s, n_params=n_params, linearity_err=lin_err,
                layer_errs=layer_errs, logits_vs_chunked=logit_err,
                chunked_vs_f32=chunk_err, argmax_agree=same_argmax,
                times=times, engine=results,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _b13_layer_errs(params, cfg, tokens):
    """The B13-route forward of ``tokens`` (the explain's knobs), each
    layer's scan held against the chunked scan on the same operands, at
    phase 2's tolerance (:func:`_scan_close`).  Returns the largest |dy| per
    layer.  The scan is watched by swapping ``ops.selective_scan`` for a
    wrapper around it for this one forward; these launches are comparisons
    and are not counted."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.launch import steps
    from repro_torch.models import mamba
    from repro_torch.models import transformer as tf
    real, errs = scan_ops.selective_scan, []

    def held(dt, x, bmat, cmat, a, h0, *, d_tile, chunk):
        y, h = real(dt, x, bmat, cmat, a, h0, d_tile=d_tile, chunk=chunk)
        want = mamba.chunked_scan(dt, x, bmat, cmat, a, h0, chunk=chunk)[0]
        errs.append(_scan_close(y, want, f"lm layer {len(errs)}: B13 vs "
                                         f"the chunked scan"))
        return y, h

    scan_ops.selective_scan = held
    try:
        with torch.no_grad():
            h = tf.embed_inputs(params, cfg, {"tokens": tokens})
            tf.forward_from_embeddings(params, cfg, h,
                                       scan_tiles=steps.ssm_scan_tiles(cfg))
    finally:
        scan_ops.selective_scan = real
    if len(errs) != cfg.n_layers:
        fail(f"lm: {len(errs)} scans held, want {cfg.n_layers}")
    return errs


def _f32_last_logits(params, cfg, tokens):
    """Last-position logits of the same weights evaluated in f32, layer by
    layer (each layer's weights widened as it runs; chunked scan)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    c32 = cfg.with_(dtype="float32")

    def up(tree):
        return tf._tree_map(lambda t: t.to(torch.float32), tree)

    x = tf.embed_inputs(params, cfg, {"tokens": tokens}).to(torch.float32)
    for si, (kind, count, _) in enumerate(cfg.layer_plan()):
        for i in range(count):
            x, _ = tf._block(up(tf._layer(params["segments"][si], i)), x,
                             c32, kind, method="autodiff")
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return layers.lm_head(up(params["embed"]), x, c32)[:, -1]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _int8_codes(fn, replace=None):
    """Run ``fn`` and return its result and the int8 residual codes that
    autograd saved (the smooth gates' quantized inputs), in graph order.
    With ``replace`` (codes of the same graph from another run), each
    saved code tensor is swapped for its counterpart there, so the
    backward reads those codes."""
    codes = []

    def pack(t):
        if t.dtype == torch.int8:
            codes.append(t.detach().cpu())
            if replace is not None:
                t = replace[len(codes) - 1].to(t.device)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, codes


def check_lm_twin(launches):
    """Phase 8: ``FULL.with_(n_layers=2, dtype="float32")`` — full width,
    depth 2 — explained on the card and on a CPU twin with the same
    parameters.  Logits within DOT_TOL * max|ref|.

    The int8 residual codes: a pre-activation within float noise of a
    rounding boundary of its row's int8 grid can take the neighbouring
    code on the other device (as a ReLU bit flips in phase 5), which moves
    that example's slope there by one quantum.  An example holds ~10^6
    codes at full width, so at this size every example may hold such a
    code, and a comparison on the examples whose codes all agree may have
    none to compare.  So: the codes agree on at least MIN_BIT_AGREEMENT of
    them and lie one step apart where they differ; the scores lie within
    REPLAY_TOL * max|scores| of the CPU twin run on the card's codes (its
    backward reads them in place of its own), on every example; and the
    same config with ``residual_policy="exact"`` (the slope at the saved
    input itself, no grid to round to) within REPLAY_TOL of the plain CPU
    twin, on every example.  Contrastive = ixg(a) - ixg(b) within
    REPLAY_TOL in f32."""
    from repro_torch import configs
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.models import transformer as tf

    cfg = configs.get(LM_ARCH).with_(n_layers=2, dtype="float32")
    exact = cfg.with_(residual_policy="exact")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    card = tf.params_to(params, "cuda")
    toks = torch.randint(0, cfg.vocab, (LM_TWIN_BATCH, LM_TWIN_SEQ),
                         generator=torch.Generator().manual_seed(2))
    totals = launches.setdefault("lm_twin", {})
    results = {}

    def engines(c, method):
        return (build(EngineSpec(LMModel(card, c), method=method)),
                build(EngineSpec(LMModel(params, c, device="cpu"),
                                 method=method)))

    for method, mode in (("saliency", "ixg"), ("saliency", "grad_norm"),
                         ("saliency", "contrastive"), ("deconvnet", "ixg"),
                         ("guided", "ixg")):
        what = f"lm twin {method} {mode}"
        eng, twin = engines(cfg, method)
        ((lg, sc), codes), rose = _count(lambda: _int8_codes(
            lambda: eng.explain_tokens({"tokens": toks}, mode=mode)), totals)
        _expect(rose, {"selective_scan": cfg.n_layers}, what)
        (lg_c, sc_c), codes_c = _int8_codes(
            lambda: twin.explain_tokens({"tokens": toks}, mode=mode))
        if len(codes) != len(codes_c):
            fail("lm twin: residual structure differs between the devices")
        lerr = _rel_err(lg.cpu(), lg_c)
        if not lerr <= DOT_TOL:
            fail(f"{what}: logits {lerr:.3e} of max")
        _finite(sc, f"{what} scores")
        n_codes = sum(c.numel() for c in codes)
        n_flip = sum(int((a != b).sum()) for a, b in zip(codes, codes_c))
        step = max((int((a.short() - b.short()).abs().max())
                    for a, b in zip(codes, codes_c) if a.numel()), default=0)
        if n_flip > (1 - MIN_BIT_AGREEMENT) * n_codes or step > 1:
            fail(f"{what}: {n_flip} of {n_codes} int8 codes differ between "
                 f"the devices, by up to {step} steps")
        (_, sc_x), _ = _int8_codes(
            lambda: twin.explain_tokens({"tokens": toks}, mode=mode),
            replace=codes)
        xerr = _rel_err(sc.cpu(), sc_x)
        if not xerr <= REPLAY_TOL:
            fail(f"{what}: scores vs the CPU on the card's codes "
                 f"{xerr:.3e} of max")
        line = (f"  {what:33s} logits {lerr:.2e} of max; int8: scores "
                f"{xerr:.2e} of max vs the CPU on the card's codes "
                f"({_rel_err(sc.cpu(), sc_c):.2e} vs the plain CPU; {n_flip} "
                f"of {n_codes} codes differ, by at most {step})")
        results[f"{method} {mode}"] = dict(
            logits_err=lerr, scores_err_card_codes=xerr,
            scores_err_plain=_rel_err(sc.cpu(), sc_c), max_abs_score=sc_c
            .abs().max().item(), codes=n_codes, codes_flipped=n_flip)
        if n_codes:                 # deconvnet keeps no residual
            eng, twin = engines(exact, method)
            (_, sc_e), rose = _count(lambda: eng.explain_tokens(
                {"tokens": toks}, mode=mode), totals)
            _expect(rose, {"selective_scan": cfg.n_layers},
                    f"{what} exact")
            eerr = _rel_err(sc_e.cpu(), twin.explain_tokens(
                {"tokens": toks}, mode=mode)[1])
            if not eerr <= REPLAY_TOL:
                fail(f"{what}: exact residuals, scores vs the plain CPU "
                     f"{eerr:.3e} of max")
            line += f"; exact residuals: {eerr:.2e} vs the plain CPU"
            results[f"{method} {mode}"]["scores_err_exact"] = eerr
        print(line)
        if mode == "ixg" and method == "saliency":
            lg_full = tf.forward(card, cfg, {"tokens": toks.to("cuda")})[0]
            top = lg_full[:, -1].float().argsort(dim=-1, descending=True)
            ta, tb = top[:, 0], top[:, 1]
    # linearity in f32: contrastive = ixg(a) - ixg(b) at the last position
    from repro_torch import lm
    args = (card, toks.to("cuda"), LM_TWIN_SEQ - 1)
    con = lm.make_token_explain(cfg, mode="contrastive")(*args, ta, tb)
    ixg = lm.make_token_explain(cfg, mode="ixg")
    diff = ixg(*args, ta, None) - ixg(*args, tb, None)
    lin = _rel_err(con, diff)
    if not lin <= REPLAY_TOL:
        fail(f"lm twin: contrastive vs ixg(a) - ixg(b) {lin:.3e} of max")
    print(f"  lm twin: contrastive vs ixg(a) - ixg(b) {lin:.2e} of max (f32)")
    results["linearity_err"] = lin
    return results


# ---------------------------------------------------------------------------


#: The counters each path must launch; the others must stay at 0 there.
PATH_KERNELS = {"f32": tuple(PER_EXPLAIN["f32"]),
                "fxp16": tuple(PER_EXPLAIN["fxp16"]),
                "vjp_fused": tuple(PER_EXPLAIN_VJP["vjp_fused"]),
                "vjp_unfused": tuple(PER_EXPLAIN_VJP["vjp_unfused"]),
                "train": tuple(PER_TRAIN_STEP),
                "lm": ("selective_scan",),
                "lm_twin": ("selective_scan",)}
#: The path whose launches the kernel JSON reports for each kernel: the
#: first that runs it.
KERNEL_PATH = {k: next(p for p in PATH_KERNELS if k in PATH_KERNELS[p])
               for k in KERNELS}


def check_path_launches(path, got):
    never = [k for k in PATH_KERNELS[path] if got.get(k, 0) == 0]
    if never:
        fail(f"{path}: kernels of the path never launched: {never}")
    stray = [k for k, v in got.items() if v and k not in PATH_KERNELS[path]]
    if stray:
        fail(f"{path}: kernels of another path launched: {stray}")
    print(f"  {path} main-path launches: {got}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for chip_smoke.json (per-case numbers)")
    ap.add_argument("--sweep", action="store_true",
                    help="after phase 1, time the launch choices of B4 and "
                         "B1 (every K split, a grid of tile plans) and stop;"
                         " --out gets kernel_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.models import cnn

    # phase 1: device
    kind = torch.cuda.get_device_name(0)

    def query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]

    smi = query("name,power.limit")
    max_sm_mhz = float(query("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_per_s = sms * IMAD_LANES_PER_SM * max_sm_mhz * 1e6
    mufu_per_s = sms * MUFU_PER_SM * max_sm_mhz * 1e6
    print(f"phase 1: device {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {smi}; {sms} SMs, max SM "
          f"clock {max_sm_mhz:.0f} MHz -> IMAD peak {imad_per_s:.4e}/s, "
          f"MUFU peak {mufu_per_s:.4e}/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"  kernels built and loaded in {build_s:.2f} s "
          f"({_build.library_path().name})")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        text = log.read_text()
        for line in text.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill stores" in line):
                print("   ", line.strip())
        print("  redesigned B1/B4 kernels (ptxas): " + "; ".join(
            f"{name} {regs} registers, spill stores {st} B, loads {ld} B"
            for name, regs, st, ld in kernel_resources(text, REDESIGNED)))

    if args.sweep:
        print(f"sweep: B4 K splits and B1 tile plans (ms = median of {REPS} "
              f"back-to-back runs)")
        rows = sweep_launch_choices(torch.Generator(device="cuda")
                                    .manual_seed(0))
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "kernel_sweep.json").write_text(json.dumps(dict(
                device=kind, nvidia_smi=smi, **rows), indent=1))
        print(smi)
        return 0

    # phase 2: kernels vs plain
    print(f"phase 2: kernels vs plain versions (batch {BATCH}, S={SEEDS}; "
          f"ms = median of {REPS} back-to-back runs)")
    kc = KernelCheck(imad_per_s, mufu_per_s)
    check_kernels(kc)
    check_kernels_fxp(kc)
    check_kernels_autograd(kc)
    check_kernels_scan(kc)
    kc.summary()

    # phases 3-4: each main path, counted on its own
    cfg = cnn.CNNConfig()
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x_cpu = torch.randn((BATCH, 32, 32, 3),
                        generator=torch.Generator().manual_seed(1))
    engine_results, n_req, launches, to_profile = {}, {}, {}, []
    for precision in ("f32", "fxp16"):
        reset_launches()
        print(f"phase 3 ({precision}): engine end to end, full Table III "
              f"width")
        engine_results[precision] = check_engine(params, cfg, x_cpu,
                                                 precision, to_profile)
        print(f"phase 4 ({precision}): requests")
        n_req[precision] = serve_requests(params, cfg, x_cpu, precision)
        torch.cuda.synchronize()
        launches[precision] = dict(LAUNCHES)
        check_path_launches(precision, launches[precision])

    # phases 5-6: each checked explain / training step counted from 0
    print(f"phase 5 (vjp): autograd explains, full Table III width, batch "
          f"{BATCH}, top-{SEEDS}")
    vjp_results = check_vjp(params, cfg, x_cpu, launches, to_profile)
    for branch in ("vjp_fused", "vjp_unfused"):
        check_path_launches(branch, launches[branch])
    print(f"phase 6 (train): {TRAIN_STEPS} AdamW steps, autodiff "
          f"cross-entropy on the kernel path, batch {BATCH}")
    train_results = check_train(params, cfg, x_cpu, launches, to_profile)
    check_path_launches("train", launches["train"])

    # phases 7-8: LM token attribution, each explain counted from 0
    print(f"phase 7 (lm): {LM_ARCH} full width and depth, bf16, "
          f"{LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} greedy "
          f"tokens, per-token and engine explains")
    lm_results = check_lm(launches, to_profile)
    check_path_launches("lm", launches["lm"])
    torch.cuda.empty_cache()
    print(f"phase 8 (lm twin): {LM_ARCH} at full width, 2 layers, f32, "
          f"batch {LM_TWIN_BATCH} x {LM_TWIN_SEQ} tokens, card vs CPU")
    twin_results = check_lm_twin(launches)
    check_path_launches("lm_twin", launches["lm_twin"])

    # last, as it slows what runs after it: where each path's time goes
    print("profiles: one saliency explain per CNN path, one training step, "
          "one LM decode step and one per-token LM explain under "
          "torch.profiler")
    profiles = {what: profile_breakdown(fn, what, wall)
                for what, fn, wall in to_profile}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        s = kc.sums[name]
        path = KERNEL_PATH[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=launches[path][name],
                            max_abs_err=kc.err[name], ms=s["ms"],
                            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                            bound_by=_bound_by(kc, name),
                            library_ms=s["library_ms"]))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, sms=sms, max_sm_mhz=max_sm_mhz,
            imad_per_s=imad_per_s, mufu_per_s=mufu_per_s, build_s=build_s, cases=kc.rows,
            sums=kc.sums, engine=engine_results, requests=n_req,
            vjp=vjp_results, train=train_results, lm=lm_results,
            lm_twin=twin_results,
            scan_backward_ms=kc.scan_backward_ms,
            scan_backward_loop_ms=kc.scan_backward_loop_ms,
            profiles=profiles,
            launches=launches, kernels=kernels), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _bound_by(kc: KernelCheck, name: str) -> str:
    """Which roof bounds the kernel's main-path shapes, by summed time."""
    rows = [r for r in kc.rows if r["kernel"] == name and r["main_path"]]
    by_bytes = sum(r["bytes"] / HBM_BYTES_PER_S for r in rows)
    by_ops = sum(r["flops"] / r["rate"] for r in rows)
    return "bytes" if by_bytes >= by_ops else "operations"


if __name__ == "__main__":
    sys.exit(main())
