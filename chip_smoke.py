#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
card: build every kernel, hold each against its plain PyTorch version at
the shapes its path gives it, then explain full-width batches of the Table
III CNN through the engine, in f32, in bf16 and in the paper's true-int16
fixed point (fxp16), state the paper's own accounting (Table II / §V,
Table IV), then explain through autograd (the vjp backend), train a few
steps, explain each generated token of falcon-mamba-7b at full width
and depth and serve it, serve the CNN through the explanation server
(``repro_torch.serve``), and check them against the CPU.

    python3 chip_smoke.py                  # one card; exits 0 when all pass
    python3 chip_smoke.py --out DIR        # also writes DIR/chip_smoke.json
    python3 chip_smoke.py --sweep [--out DIR]

``--sweep`` runs phase 1, then times the launch choices of B4 (every K
split) and B1 (a grid of tile plans, all bitwise equal) beside the library
call at the main-path and vjp shapes, of the fused conv backward (B5 at
S = 3 and at the vjp path's S = 1, B8 at S = 3: a grid of tile plans, all
bitwise equal, beside the general kernel), of the int16 forwards (B7:
a grid of tile plans at the four Table III layers beside the general
kernel; B9: every K split at FC0; all bitwise equal to the plain version),
of the bf16 forwards (B1 bf16: every tensor-core tile of
``conv_mma_candidates`` at the Table III layers beside ``F.conv2d`` bf16
and the FFMA instance; B4 bf16: every cluster size and column tile of
``vmm_mma_candidates`` at FC0 and FC1 beside ``torch.addmm`` bf16;
within one bf16 step of the plain version, a route's tiles bitwise
equal), of the bf16 backwards on the tensor cores (B5 bf16: every tile of
``conv_bwd_mma_candidates`` at the four Table III launches beside the
FFMA instance; B6 bf16: every tile of ``vmm_bwd_mma_candidates`` at FC0
and FC1; within one bf16 step of the plain version, a launch's tiles
bitwise equal),
of the fused FC backward (B6 and B10 at FC0 with S = 3 and 1 and at
FC1 with S = 3: every plan of ``vmm_bwd_candidates`` beside the general
kernel, bitwise equal to it in f32 and to the plain version in int16),
and of the ReLU / pool template (B2, B3 and their fused pass, f32 and
int16, at the main-path shapes: every block size of ``RELU_POOL_THREADS``
beside the general route, bitwise equal, timed between events, back to
back and under the profiler), and stops.

Phases (every failed check raises; nothing is caught and carried on):

1. device: card name, ``nvidia-smi`` name, power limit and maximum SM
   clock, TF32 off for the plain versions, kernel build time, and the
   registers and spills ``ptxas`` reports for the redesigned B1/B2/B3/B4/
   B5/B6/B7/B8/B9/B10/B13 kernels and the bf16 tensor-core kernels of
   B1/B4/B5/B6 (B2, B3 and their fused pass: the instances of
   ``relu_pool_fwd_kernel``);
2. kernels at batch 32, S = 3 seeds, against their plain versions: the f32
   kernels B1-B6 (bitwise for ReLU+mask, pool+argmax and the two fused at
   the pooled layers, with and without the mask, each also bitwise equal
   to the general route (B2 / B3 on their first kernels) and under every
   block size, timed beside the general route; within 1e-5 * max|ref| for
   the dots; B1, B4 and B5 also launched again on the
   same inputs, B1 and B5 under a second tile plan, B5 on its general
   kernel (timed beside it), all bitwise equal; B6 likewise, again, under
   a second tile plan and on its general kernel, timed beside it and
   beside ``torch.matmul`` on the pre-gated gradient; each time beside a
   library call prints its ratio to it), then the bf16 instances of B1-B6
   and of the fused pass: first the tensor-core kernels (B1 bf16 where
   Cin is a multiple of 16, B4 bf16, and the backwards B5 bf16 and B6
   bf16, gated) against the f64 sum of the widened operands, beside the
   plain version, at the main-path shapes and at three long cancelling
   sums (conv C = 608 at K = 5, forward and gated backward, FC0's K =
   4096); then
   ReLU / pool bitwise, as above; conv and FC within
   one bf16 rounding step of the f32 sum plus one of the output,
   ``BF16_STEP * (|sum| + |plain|)``, and the f32 kernels' tolerance for
   the reordered sum, ``DOT_TOL * max|sum|``; bitwise again and under a
   second plan of the same route, the FFMA routes of B1 and B5 within that
   bound of the tensor cores (B5's FFMA route timed beside); B4 bf16
   allocating nothing but y; beside ``F.conv2d`` / ``torch.addmm`` in
   bf16), then the fxp16
   kernels B7-B10 and
   the int16 instances of B2/B3 and of their fused pass, all bitwise (B7, B8 and B10 also launched
   again, under a second plan and on their general kernels, timed beside
   them; B9 again and under a second K split), plus accumulators that wrap
   at ±32767 operands (B9's under several splits, B10's under three
   plans); then the gate (B11, three
   methods) and unpool (B12, f32 and int16) kernels of the autograd paths,
   bitwise; then the selective scan (B13) at falcon-mamba-7b's explain
   shape (B = 4, S = 72, D = 8192, N = 16; x bf16 and f32) and a ragged
   S = 13, within the JAX package's tolerance (atol 2e-4, rtol 2e-3; one
   bf16 step for a bf16 y), two (d_tile, chunk) pairs bitwise equal; then
   its backward kernel (B13 bwd) at the same shapes against the plain
   reverse recurrence, each gradient within 1e-4 * max|ref| (one bf16 step
   more for a bf16 gradient), bitwise equal under both knob pairs and run
   to run, beside the backward it replaced (autograd over the chunked
   scan) and autograd over the sequential loop; median kernel, plain and
   one-library-call times (CUDA events);
3. engine, full width: saliency / deconvnet / guided explains of a
   [32, 32, 32, 3] batch with top-3 seeds on the card against a CPU twin
   engine on the same parameters (logits, residual bits, cross-replay), and
   the launch count of each kernel per explain; under fxp16 every one of
   these must be equal bit for bit; bf16 (between f32 and fxp16) must
   give bf16 logits and relevance, launch every kernel through its bf16
   entry point (counted per entry point), and stay within
   BF16_TOL * max of the CPU twin, the relevance also against the CPU's
   replay of the card's stored bits, and its heatmaps against f32's on the
   same seeds (``fidelity.compare``, printed);
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
   f32); one per-token explain's scores through the B13 backward kernel
   within LM_ROUTE_TOL * max of the same explain through autograd over the
   chunked scan; 64 B13 and 64 B13 bwd launches per explain, none in
   prefill or decode; host and device time per decode step and per
   explain;
8. lm twin: the same config at depth 2 in f32, batch 2 x 32 tokens, on the
   card against a CPU twin: logits within 1e-5 * max|ref|; the int8
   residual codes equal on MIN_BIT_AGREEMENT of them and one step apart
   elsewhere; scores within 1e-4 * max|scores| per mode of the CPU run on
   the card's int8 codes, and, with exact residuals, of the plain CPU
   twin (see ``check_lm_twin``), the card's backward through the B13
   backward kernel and the CPU's through its plain reverse recurrence;
   contrastive = ixg(a) - ixg(b) within 1e-4 * max; one B13 and one B13
   bwd launch per layer and explain.
7b. lm serve (at the end of phase 7, on its model): an ``LMAdapter``
   ``ExplanationServer`` (``max_batch`` 4): 4 predicts bitwise the
   last-position logits of ``forward`` (no B13 launch), then batches of 4
   ``token_ixg`` and of 4 ``token_contrastive`` requests of 64 tokens,
   each response bitwise ``Engine.explain_tokens`` on the same padded
   batch, 64 B13 and 64 B13 bwd launches a batch; host ms through the
   server and device span a batch.

9. paper tables (after phase 4 of the last path): each config's
   ``core.residuals`` Ledger (``TABLE_III_LITERAL``, the paper's 24.7 Kb,
   and ``FULL``) equal to the bits of the residual tensors the card's
   forward returns, per example and method; the bf16 explain of
   ``TABLE_III_LITERAL`` (its pools run alone) against its CPU twin,
   counted from 0; the bytes autograd saves for the backward of the
   autodiff model against the packed residuals, and the peak device memory
   of a packed-residual explain against a ``backward="vjp"`` explain over
   ``method="autodiff"`` (§V); FP against FP+BP device ms at batch 1 and 32
   in f32, bf16 and fxp16 (Table IV).

10. serve (after phase 8): ``ExplanationServer(CNNAdapter.from_engine(
   eng), max_batch=32)`` on the card, f32, full Table III width, and a CPU
   twin server fed the same requests: 64 predicts (two batches), their
   explains (saliency, guided, deconvnet, top-3 panels, explicit targets:
   every one a cache hit), 32 cold explains of new uids and their top-3
   follow-ups; every response bitwise ``Engine.explain`` of the same
   padded batch; a hit batch launches 4 B5 and 2 B6 and no forward
   kernel, a cold BP batch both sets, a predict batch the forward's;
   against the twin, logits within 1e-5 * max and relevance within 1e-4 *
   max (examples whose stored bits differ replayed on the card's bits);
   8 integrated-gradients requests (steps 16) bitwise ``Engine.ig`` of
   their batch, 8 smoothgrad (n 8, per-request seeds) co-batched bitwise
   equal to singleton requests; the cache's bits = its entries x the
   Ledger's bits an example = the bytes its tensors own; a server under
   pressure rerouting to fxp16 (``DegradePolicy``), the rerouted responses
   flagged and bitwise the card's fxp16 engine and the CPU twin's; host ms
   through the server against device ms of the kernels for a 32-row
   predict, hit and cold BP batch, and the host ms of filling the cache;
   ``TimedAdapter`` replays of ``synthesize(2000, seed=0)`` without and
   with admission (capacity 256, 50 ms deadlines, fxp16 reroute): p50/p99
   by kind, sheds, degrades, hit rate, occupancy; any error response
   fails.  The server's launches go on a ``{"serve": ...}`` line before
   the kernels line, not into the kernels' counts.

Last, the profiler column of phase 2: every row's kernel (and general
route) 50 times under one profiler session, its CUPTI time per call;
then one saliency explain of each CNN path, Table IV's f32 FP+BP at
batch 1 and 32, one training step, one LM decode step and one per-token
LM explain under ``torch.profiler``: kernel time by kernel and by family
against the device time measured before (the device's idle share); the
bf16 explain's kernels by name must show the forwards and backwards on
the tensor cores, each FC layer one CUDA kernel (``BF16_MMA_KERNELS``).  This
comes after every timing, since a profiler session slows what runs after
it.

Phases 3-4 run once per path, f32, bf16, then fxp16; phase 9's literal
bf16 explain and phases 5 (per branch), 6, 7 and 8 are paths of their
own (phases 7b and 10 are the server's, reported on their own
line).  Launch counters are set to 0 just before
each path (in phases 5-8: before each checked explain, training step or
decode) and read just after, per wrapper counter and, on the bf16 paths,
per C entry point; the kernel-vs-plain launches of phase 2, and
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
import types
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
# bf16: an output is its f32 sum rounded once to bf16 (the forward's bias
# after that rounding, then once more), so a reordered sum can land one
# rounding step away: a kernel is held to within BF16_STEP * (|sum| +
# |plain|) of its plain version, plus DOT_TOL * max|sum| for the reordered
# f32 sum itself (phase 2), and an explain's logits and
# relevance, after four layers of such steps, to BF16_TOL * max|ref| of
# the CPU twin's (tests/test_torch_cnn_bf16.py holds the port to repro
# at the same bound)
BF16_STEP, BF16_TOL = 2.0 ** -7, 2.0 ** -6
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores and dense bf16 FLOP/s on the tensor cores.  The
# bound is the larger of bytes/HBM and FLOP/the peak for the operands'
# type, at the card's full 700 W limit: a bf16 product is bounded by the
# bf16 peak whatever units its kernel chooses.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
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
# B13's backward against its plain version: each gradient within
# SCAN_GRAD_TOL * max|ref| (f32 sums over up to D = 8192 channels and 72
# steps, in another order), plus one bf16 step where the gradient is bf16.
SCAN_GRAD_TOL = 1e-4
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
# Phase 7: a per-token explain's scores through the B13 backward kernel
# against the same explain through autograd over the chunked scan: the
# same bf16 stack, its cotangents rounded at other places, so within the
# bound tests/test_torch_lm.py holds bf16 scores to.
LM_ROUTE_TOL = 5e-2
# Phase 8: two layers at full width in f32 against a CPU twin.
LM_TWIN_BATCH, LM_TWIN_SEQ = 2, 32

KERNELS = {   # counter -> (C source, replaced TPU kernel def or function)
    "conv2d_fwd": ("src/repro_torch/csrc/conv_fwd.cuh",
                   "src/repro/kernels/conv2d/conv2d.py:66"),
    "relu_fwd": ("src/repro_torch/csrc/relu_pool.cuh",
                 "src/repro/kernels/relu_mask/relu_mask.py:87"),
    "maxpool_fwd": ("src/repro_torch/csrc/relu_pool.cuh",
                    "src/repro/kernels/pool/pool.py:77"),
    # the two above in one pass at the pooled layers
    "relu_pool_fwd": ("src/repro_torch/csrc/relu_pool.cuh",
                      "src/repro/kernels/relu_mask/relu_mask.py:87 + "
                      "src/repro/kernels/pool/pool.py:77"),
    "vmm_fwd": ("src/repro_torch/csrc/vmm.cu",
                "src/repro/kernels/vmm/vmm.py:49"),
    "conv2d_bwd_fused": ("src/repro_torch/csrc/conv_bwd.cuh",
                         "src/repro/kernels/conv2d/conv2d.py:150"),
    "vmm_bwd_fused": ("src/repro_torch/csrc/vmm_bwd.cuh",
                      "src/repro/kernels/vmm/vmm.py:117"),
    "conv2d_fxp_fwd": ("src/repro_torch/csrc/conv_fwd.cuh",
                       "src/repro/kernels/conv2d/fxp.py:53"),
    "conv2d_bwd_fused_fxp": ("src/repro_torch/csrc/conv_bwd.cuh",
                             "src/repro/kernels/conv2d/fxp.py:130"),
    "vmm_fxp_fwd": ("src/repro_torch/csrc/vmm_fxp.cu",
                    "src/repro/kernels/vmm/fxp.py:46"),
    "vmm_bwd_fused_fxp": ("src/repro_torch/csrc/vmm_bwd.cuh",
                          "src/repro/kernels/vmm/fxp.py:116"),
    "relu_bwd": ("src/repro_torch/csrc/relu_mask.cu",
                 "src/repro/kernels/relu_mask/relu_mask.py:108"),
    "unpool_bwd": ("src/repro_torch/csrc/pool.cu",
                   "src/repro/kernels/pool/pool.py:97"),
    "selective_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                       "src/repro/kernels/ssm_scan/ssm_scan.py:56"),
    # no Pallas kernel: the JAX package's backward is jax.vjp of its loop
    "selective_scan_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                           "src/repro/kernels/ssm_scan/ops.py:40"),
}
#: The int16 instances of B2/B3 and of their fused pass (fxp16 path) and of
#: B12: timed and checked on their own, launched under the ``relu_fwd`` /
#: ``maxpool_fwd`` / ``relu_pool_fwd`` / ``unpool_bwd`` counters.
INT16_INSTANCES = ("relu_fwd_i16", "maxpool_fwd_i16", "relu_pool_fwd_i16",
                   "unpool_bwd_i16")
#: The bf16 instances of B1-B6 and of the fused ReLU/pool pass (bf16 path):
#: timed and checked on their own (phase 2), launched under their f32
#: counters through entry points of their own (name -> (counter, entry)).
#: The bf16 paths must launch every kernel through these entries (phase 3
#: and phase 9 count per entry point); the kernel line lists each with the
#: launches of its entry on the bf16 path, B3 alone with those of the
#: Table-III-literal bf16 explain (conv_relu=False: the only bf16 path that
#: pools alone).  The bf16 conv forward's entry holds two kernels, each a
#: row of its own: the tensor cores (layers 1-3) and the FFMA instance
#: (layer 0), their launches told apart by route (:data:`BF16_ROUTES`).
BF16_INSTANCES = {
    "conv2d_fwd_bf16": ("conv2d_fwd", "repro_conv2d_fwd_bf16"),
    "conv2d_fwd_bf16_ffma": ("conv2d_fwd", "repro_conv2d_fwd_bf16"),
    "relu_fwd_bf16": ("relu_fwd", "repro_relu_fwd_bf16"),
    "maxpool_fwd_bf16": ("maxpool_fwd", "repro_maxpool_fwd_bf16"),
    "relu_pool_fwd_bf16": ("relu_pool_fwd", "repro_relu_pool_fwd_bf16"),
    "vmm_fwd_bf16": ("vmm_fwd", "repro_vmm_fwd_bf16"),
    "conv2d_bwd_fused_bf16": ("conv2d_bwd_fused",
                              "repro_conv2d_bwd_fused_bf16"),
    "vmm_bwd_fused_bf16": ("vmm_bwd_fused", "repro_vmm_bwd_fused_bf16")}


#: The bf16 instances whose main path runs a kernel of its own, on the
#: tensor cores: B1 bf16's layers 1-3, B4 bf16, and all four layers of B5
#: bf16 and both of B6 bf16 (B1 bf16's layer 0, ``conv2d_fwd_bf16_ffma``,
#: is ``conv_fwd.cuh``'s FFMA instance).
BF16_SOURCES = {"conv2d_fwd_bf16": "src/repro_torch/csrc/conv_fwd_mma.cu",
                "vmm_fwd_bf16": "src/repro_torch/csrc/vmm_fwd_bf16.cu",
                "conv2d_bwd_fused_bf16":
                    "src/repro_torch/csrc/conv_bwd_mma.cu",
                "vmm_bwd_fused_bf16": "src/repro_torch/csrc/vmm_bwd_bf16.cu"}
#: The rows whose launches are their route's (``_build.ROUTE_LAUNCHES``),
#: not their entry point's.
BF16_ROUTES = {"conv2d_fwd_bf16": "conv2d_fwd_bf16_mma",
               "conv2d_fwd_bf16_ffma": "conv2d_fwd_bf16_ffma",
               "conv2d_bwd_fused_bf16": "conv2d_bwd_fused_bf16_mma",
               "vmm_bwd_fused_bf16": "vmm_bwd_fused_bf16_mma"}
#: Per counter of the bf16 path, its launches a call (4 conv forwards a
#: forward, 4 conv and 2 FC backwards an explain) and each route's share:
#: the conv forward's layers 1-3 on the tensor cores and layer 0 on FFMA,
#: every backward on the tensor cores.
ROUTES_PER_CALL = {
    "conv2d_fwd": (4, {"conv2d_fwd_bf16_mma": 3, "conv2d_fwd_bf16_ffma": 1}),
    "conv2d_bwd_fused": (4, {"conv2d_bwd_fused_bf16_mma": 4,
                             "conv2d_bwd_fused_bf16_ffma": 0}),
    "vmm_bwd_fused": (2, {"vmm_bwd_fused_bf16_mma": 2})}


def bf16_entries(counts, entry_counts):
    """The per-entry-point launches a bf16 path must show: each counter's
    count on its bf16 entry, every other entry point at 0."""
    want = {k: 0 for k in entry_counts}
    for counter, entry in BF16_INSTANCES.values():
        want[entry] = counts.get(counter, 0)
    return want


def check_bf16_routes(what, routes, counts):
    """Fail unless the bf16 path's launches by kernel ``routes`` (a delta
    of ``_build.ROUTE_LAUNCHES``) match its launches per counter
    ``counts`` (a delta of ``LAUNCHES``) as :data:`ROUTES_PER_CALL` splits
    them: the conv forward's layers 1-3 on the tensor cores and layer 0 on
    FFMA, each conv and FC backward on the tensor cores."""
    want = {}
    for counter, (layers, split) in ROUTES_PER_CALL.items():
        calls, rest = divmod(counts.get(counter, 0), layers)
        if rest:
            fail(f"{what}: {counts.get(counter)} {counter} launches, not "
                 f"whole calls of {layers}")
        want.update({k: v * calls for k, v in split.items()})
    if routes != want:
        fail(f"{what}: bf16 launches by kernel {routes}, want {want}")


def fail(msg: str):
    raise AssertionError(msg)


#: Entry functions of the kernels redesigned for this card (the conv
#: forward of B1 and B7, and of B1 bf16 on the tensor cores, the ReLU /
#: pool template of B2, B3 and their fused pass, the FC forwards of B4 and
#: B9, and of B4 bf16 on the tensor cores, the fused conv backward of B5
#: and B8, and of B5 bf16 on the tensor cores, the fused FC backward of B6
#: and B10, and of B6 bf16 on the tensor cores, the scan B13 and its
#: backward), whose registers and spills phase 1 reports.
REDESIGNED = ("conv_igemm_kernel", "conv_mma_kernel",
              "relu_pool_fwd_kernel", "vmm_splitk_kernel", "vmm_mma_kernel",
              "vmm_splitk_sum_kernel", "conv_bwd_igemm_kernel",
              "conv_bwd_mma_kernel", "vmm_fxp_splitk_kernel",
              "vmm_fxp_splitk_sum_kernel", "vmm_bwd_tiled_kernel",
              "vmm_bwd_mma_kernel", "selective_scan_kernel",
              "selective_scan_bwd_kernel")
#: Itanium mangling of the element types a template is instantiated for.
MANGLED_TYPES = {"f": "float", "s": "int16_t", "13__nv_bfloat16": "bf16"}


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
                    targs = [MANGLED_TYPES[t] for t in re.findall(
                        rf"{name}I(f|s|13__nv_bfloat16)", entry)]
                    targs += re.findall(r"L[ib](\d+)E", entry)
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


def cupti_per_call(fns, reps: int = REPS):
    """The CUPTI duration of the kernels each ``fn()`` launches, per call:
    every ``fn`` run ``reps`` times under one ``torch.profiler`` session.
    A sleep kernel (``torch.cuda._sleep``, ATen's ``spin_kernel``) before
    each ``fn`` and after the last splits the card's kernel sequence into
    calls, so no host clock is matched with the device's; three more lead
    the session, whose first records CUPTI can lose (seen on the card).
    None where fewer groups than calls come out, or an empty one (the
    profiler recorded no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):      # a session can lose its first records
            torch.cuda._sleep(1000)
        for fn in fns:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    groups, cur = [], None
    for e in kernels:
        if "spin_kernel" in e.name:          # ATen's sleep kernel
            if cur is not None:
                groups.append(cur / reps)
            cur = 0.0
        elif cur is not None:
            cur += e.time_range.elapsed_us() / 1e3
    groups = groups[len(groups) - len(fns):]      # the calls' groups: last
    if len(groups) != len(fns) or not all(groups):
        spins = sum("spin_kernel" in e.name for e in kernels)
        print(f"  cupti_per_call: {len(groups)} groups of kernels between "
              f"sleep kernels for {len(fns)} calls, or an empty one "
              f"({len(kernels)} kernel records, {spins} of them sleeps); "
              f"not measured")
        return None
    return groups


def batched_ms(fn, reps: int = REPS) -> float:
    """Device time per call of ``reps`` calls of ``fn()`` back to back
    between one pair of CUDA events, queued behind a sleep kernel: the
    launches' own spacing without the events between them."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(int(2e6 * 50))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
            calls[e.name] = calls.get(e.name, 0) + 1 / reps
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
                by_category=cats, calls=calls)


#: The CUDA kernels a bf16 saliency explain must launch (name fragment ->
#: kernels an explain; no fragment is part of another's name): the
#: forwards' conv layers 1-3 on the tensor cores and layer 0 on the FFMA
#: instance, both FC layers on the tensor cores, each in one kernel, none
#: of the split-K's; the backwards' four conv and two FC layers on the
#: tensor cores, none on the FFMA templates.
BF16_MMA_KERNELS = {"conv_mma_kernel": 3, "conv_igemm_kernel": 1,
                    "vmm_mma_kernel": 2, "vmm_splitk": 0,
                    "conv_bwd_mma_kernel": 4, "vmm_bwd_mma_kernel": 2,
                    "conv_bwd_igemm_kernel": 0, "vmm_bwd_tiled_kernel": 0}


def check_bf16_kernel_names(profile, again):
    """The bf16 explain's profile read by kernel name: the forwards and
    backwards ran on the tensor cores, FC0 in one CUDA launch with no
    split-K sum kernel, no backward on an FFMA template.
    Where the profile is missing (CUPTI can lose a session), ``again()``
    profiles once more; fail if that is missing too."""
    if profile is None:
        profile = again()
    if profile is None:
        fail("bf16 explain: no profile in two sessions, so its kernels "
             "cannot be read by name")
    got = {frag: round(sum(c for name, c in profile["calls"].items()
                           if frag in name))
           for frag in BF16_MMA_KERNELS}
    if got != BF16_MMA_KERNELS:
        fail(f"bf16 explain: CUDA kernels by name {got}, want "
             f"{BF16_MMA_KERNELS}")
    print(f"  bf16 explain kernels by name (profiler, per explain): {got}")
    return got


def _category(kernel_name: str) -> str:
    """A kernel's family, by its name: our kernels, cuBLAS/CUTLASS matrix
    products, or PyTorch's own (elementwise, reductions, copies)."""
    n = kernel_name.lower()
    if "selective_scan_bwd" in n:
        return "B13 bwd"
    if "selective_scan" in n:
        return "B13"
    if any(k in n for k in ("conv_kernel", "conv_igemm_kernel",
                            "conv_bwd_igemm_kernel", "conv_mma_kernel",
                            "conv_bwd_mma_kernel",
                            "vmm_splitk", "vmm_fxp_splitk", "vmm_mma_kernel",
                            "conv_fxp_kernel", "relu_fwd_kernel",
                            "relu_pool_fwd_kernel",
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


def _frozen(fn):
    """``fn`` with the values its free variables hold now: phase 2's
    closures read loop variables, which later cases rebind before the
    profiler column runs them again."""
    if fn is None or not fn.__closure__:
        return fn
    cells = []
    for c in fn.__closure__:
        try:
            cells.append(types.CellType(c.cell_contents))
        except ValueError:                  # not bound yet: keep it
            cells.append(c)
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, tuple(cells))


class KernelCheck:
    """Per-kernel results, summed over its main-path shapes (saliency)."""

    def __init__(self, imad_per_s: float, mufu_per_s: float):
        self.imad_per_s = imad_per_s
        self.mufu_per_s = mufu_per_s
        self.scan_backward_ms = self.scan_backward_loop_ms = None
        self.accumulation = None  # check_mma_accumulation's rows
        self.rows = []            # one per compared case, for --out
        self.fns = []             # (kernel_fn, general_fn) per row
        keys = tuple(KERNELS) + INT16_INSTANCES + tuple(BF16_INSTANCES)
        self.err = {k: 0.0 for k in keys}
        self.sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": None, "f32_reference_ms": None,
                         "general_ms": None, "cupti_ms": None,
                         "cupti_general_ms": None}
                     for k in keys}

    def record(self, counter, case, main, got, want, exact, kernel_fn,
               plain_fn, nbytes, flops, library_fn=None, rate=None,
               f32_reference_fn=None, close=None, general_fn=None,
               general_what="general"):
        """Compare, time and log one case.  ``rate`` is the peak for
        ``flops`` (f32 FLOP/s by default; IMAD/s for the int16 kernels,
        MUFU/s for the scan's exponentials); ``f32_reference_fn`` times an
        f32 library call on the same shapes, a reference point only, where
        no library computes the function; ``general_fn`` times the same
        kernel's general route (the fused conv backward's design before
        its redesign; ``general_what`` names it where it is another route),
        launched on the same inputs; ``close(got, want)``
        replaces the default ``DOT_TOL`` comparison of an inexact case,
        returning the error or failing."""
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
        general = device_time_ms(general_fn) if general_fn else None
        bnd = bound_ms(nbytes, flops, rate)
        self.err[counter] = max(self.err[counter], err)
        row = dict(kernel=counter, case=case, max_abs_err=err, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=bnd,
                   bytes=nbytes, flops=flops, rate=rate, main_path=main,
                   f32_reference_ms=f32_ref, general_ms=general,
                   cupti_ms=None, cupti_general_ms=None)
        self.rows.append(row)
        self.fns.append((_frozen(kernel_fn), _frozen(general_fn)))
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
            for key, t in (("f32_reference_ms", f32_ref),
                           ("general_ms", general)):
                if t is not None:
                    s[key] = (s[key] or 0.0) + t
        libs = (f" library {lib:.4f} (x{ms / lib:.2f})" if lib is not None
                else "")
        refs = f" f32-ref {f32_ref:.4f}" if f32_ref is not None else ""
        if general is not None:
            refs += f" {general_what} {general:.4f}"
        print(f"  {counter:20s} {case:34s} err {err:.2e}  kernel {ms:.4f} "
              f"plain {plain:.4f}{libs}{refs}  bound {bnd:.4f} ms")

    def profile(self, reps: int = REPS):
        """The profiler column: each row's kernel (and general route) under
        one profiler session (:func:`cupti_per_call`), after every event
        timing of the run (a profiler session slows what runs after it)."""
        runs = [(i, key, fn) for i, fns in enumerate(self.fns)
                for key, fn in zip(("cupti_ms", "cupti_general_ms"), fns)
                if fn is not None]
        times = cupti_per_call([fn for _, _, fn in runs], reps)
        if times is None:       # one more session: CUPTI can lose records
            times = cupti_per_call([fn for _, _, fn in runs], reps)
        if times is None:
            return
        for (i, key, _), t in zip(runs, times):
            row = self.rows[i]
            row[key] = t
            if row["main_path"]:
                s = self.sums[row["kernel"]]
                s[key] = (s[key] or 0.0) + t
        for row in self.rows:
            gen = row["cupti_general_ms"]
            print(f"  {row['kernel']:20s} {row['case']:34s} CUPTI "
                  f"{row['cupti_ms']:.4f}"
                  + (f" general {gen:.4f}" if gen is not None else "")
                  + f" events {row['ms']:.4f} bound {row['bound_ms']:.4f}")

    def summary(self):
        """One line per kernel: main-path sums per explain."""
        for k, s in self.sums.items():
            extra = "".join(f" {n} {s[n]:.4f}" for n in (
                "library_ms", "f32_reference_ms", "general_ms", "cupti_ms",
                "cupti_general_ms")
                if s[n] is not None)
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


def _same_bits(a, b) -> bool:
    """Equal tuples (or tensors) of equal types, f32 and bf16 compared as
    bits (so +0.0 and -0.0 differ); None matches only None."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b, strict=True):
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        elif x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            return False
    return True


def check_relu_pool(kc, counter, case, x, kernel, plain, general, nbytes,
                    ops, main, rate=None):
    """One case of the ReLU / pool template: bitwise its plain version, the
    general route (B2 / B3 on their first kernels; B2 then B3 for the
    fused pass) and itself under every block size; timed beside the
    general route."""
    from repro_torch.kernels.tiling import RELU_POOL_THREADS
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for what, out in [("the plain version", want),
                      ("the general route", general())] + [
            (f"{t} threads", kernel(threads=t)) for t in RELU_POOL_THREADS]:
        torch.cuda.synchronize()
        if not _same_bits(out, got):
            fail(f"{counter} {case}: the bits differ from {what}")
    print(f"  {counter:20s} {case:34s} bitwise equal: plain, general, "
          f"threads {RELU_POOL_THREADS}")
    kc.record(counter, case, main, tuple(t for t in got if t is not None),
              tuple(t for t in want if t is not None), True, kernel, plain,
              nbytes, ops, rate=rate, general_fn=general)


def second_fwd_plan(plan, cin: int):
    """A valid tile plan of the conv forward other than ``plan``: twice
    the rows, the other pixel count a thread, 16 channels a block and a
    chunk of 8 (all of Cin where it is not a multiple of 4)."""
    from repro_torch.kernels.conv2d.conv2d import ConvPlan
    return ConvPlan(2 * plan.th, 4 if plan.px == 8 else 8, 16,
                    8 if cin % 4 == 0 else cin)


def second_bwd_plan(plan, c: int):
    """A valid tile plan of the fused conv backward other than ``plan``:
    the other pixel count a thread, the smallest whole chunk and one seed a
    group (so the ring also runs across seed groups)."""
    from repro_torch.kernels.conv2d.conv2d import (CONV_MAX_THREADS,
                                                   ConvBwdPlan, bwd_cin_step)
    th = plan.th
    while True:
        other = ConvBwdPlan(th, 12 - plan.px, plan.tco, bwd_cin_step(c), 1,
                            1)
        if other.threads <= CONV_MAX_THREADS:
            return other
        th //= 2


def second_vmm_bwd_plan(plan):
    """A valid tile plan of the fused FC backward other than ``plan``: 8
    rows x 128 columns a block, 2 rows a thread and 8-deep chunks (so the
    ring runs K = 10 in two chunks and K = 128 in sixteen), or 64 x 16 x 16
    at 4 rows a thread where ``plan`` is that one."""
    from repro_torch.kernels.vmm.vmm import VmmBwdPlan
    other = VmmBwdPlan(8, 128, 8, 2)
    return other if other != plan else VmmBwdPlan(64, 16, 16, 4)


def general_relu_pool(x, mask):
    """The fused pass on the general route: B2's first kernel, then B3's
    (two launches, the ReLU'd map written and read back)."""
    from repro_torch.kernels.pool.pool import maxpool_fwd
    from repro_torch.kernels.relu_mask.relu_mask import relu_fwd
    from repro_torch.kernels.tiling import RELU_POOL_GENERAL
    n, h, w, c = x.shape
    y, m = relu_fwd(x.reshape(-1, c), threads=RELU_POOL_GENERAL)
    y, idx = maxpool_fwd(y.reshape(x.shape), threads=RELU_POOL_GENERAL)
    return y, (m.reshape(n, h, w, -1) if mask else None), idx


def check_kernels(kc: KernelCheck):
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL, conv2d,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv2d_planned,
                                                   conv_bwd_plan, conv_plan)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                         relu_fwd,
                                                         unpack_bits)
    from repro_torch.kernels.tiling import (RELU_POOL_GENERAL, crumb_bytes,
                                            mask_bytes)
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL, vmm,
                                             vmm_bwd_fused,
                                             vmm_bwd_fused_plain,
                                             vmm_bwd_plan, vmm_splits)
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
        other = second_fwd_plan(plan, cin)
        _bitwise_repeat("conv2d_fwd", case, got, (
            (f"again under {plan}", lambda: conv2d(x, w, b)),
            (f"under {other}", lambda: conv2d_planned(x, w, b, plan=other))))
        kc.record("conv2d_fwd", case, True, got,
                  conv_ref.conv2d(x, w) + b, False,
                  lambda: conv2d(x, w, b), lambda: conv_ref.conv2d(x, w) + b,
                  nbytes, flops, lambda: F.conv2d(xn, wn, b, padding=1))

    # B2 relu + mask: the three rectifiers of the forward no pool follows
    # (conv 0, conv 2, FC0); exact zeros give bit 0 (strict >), -0.0 +0.0
    for r, c in ((n * 32 * 32, 32), (n * 16 * 16, 64), (n, 128)):
        x = randn(gen, r, c)
        x[0] = 0.0
        x[1] = -0.0
        check_relu_pool(
            kc, "relu_fwd", f"[{r},{c}]", x,
            lambda x=x, **kw: relu_fwd(x, **kw),
            lambda x=x: relu_ref.relu_fwd(x),
            lambda x=x: relu_fwd(x, threads=RELU_POOL_GENERAL),
            4 * 2 * r * c + r * mask_bytes(c), r * c, True)

    # B3 pool + argmax alone, on post-ReLU maps (many tied all-zero
    # windows): the vjp standalone ops' and training's pools
    for h, c in ((32, 32), (16, 64)):
        x = torch.clamp_min(randn(gen, n, h, h, c) - 0.5, 0)
        nbytes = (4 * x.numel() + 4 * x.numel() // 4
                  + n * (h // 2) ** 2 * crumb_bytes(c))
        check_relu_pool(
            kc, "maxpool_fwd", f"[{n},{h},{h},{c}]", x,
            lambda x=x, **kw: maxpool_fwd(x, **kw),
            lambda x=x: pool_ref.maxpool_fwd(x),
            lambda x=x: maxpool_fwd(x, threads=RELU_POOL_GENERAL),
            nbytes, 3 * x.numel() // 4, True)

    # B2 + B3 fused at the two pooled layers, on conv outputs (all-negative
    # windows give crumb 0), with the mask (saliency, guided) and without
    # (deconvnet); the general route is B2 then B3
    for h, c in ((32, 32), (16, 64)):
        x = randn(gen, n, h, h, c)
        x[:, 0, 0] = 0.0
        x[:, 0, 1] = -0.0
        for mask in (True, False):
            nbytes = (4 * x.numel() + 4 * x.numel() // 4
                      + n * (h // 2) ** 2 * crumb_bytes(c)
                      + (n * h * h * mask_bytes(c) if mask else 0))
            check_relu_pool(
                kc, "relu_pool_fwd",
                f"[{n},{h},{h},{c}]" + (" mask" if mask else " no mask"), x,
                lambda x=x, mask=mask, **kw: relu_pool_fwd(x, mask, **kw),
                lambda x=x, mask=mask: pool_ref.relu_pool_fwd(x, mask),
                lambda x=x, mask=mask: general_relu_pool(x, mask),
                nbytes, x.numel() + 3 * x.numel() // 4, mask)

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

    # B5 fused conv backward: (H, C, Cout', pooled) of layers 3, 2, 1, 0,
    # launched again, under a second tile plan and on the general kernel
    # (its design before the redesign, timed beside it): all bitwise equal
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
            case = (f"{method} [{s},{n},{hg},{hg},{c}]->{cout}"
                    + (" pool" if pooled else ""))
            got = conv2d_bwd_fused(g, wt, **kw)
            plan = conv_bwd_plan(s, n, h, h, c, cout, 3, pooled=pooled,
                                 esize=g.element_size())
            other = second_bwd_plan(plan, c)
            _bitwise_repeat("conv2d_bwd_fused", case, got, (
                (f"again under {plan}", lambda: conv2d_bwd_fused(g, wt, **kw)),
                (f"under {other}",
                 lambda: conv2d_bwd_fused(g, wt, plan=other, **kw)),
                ("on the general kernel", lambda: conv2d_bwd_fused(
                    g, wt, plan=CONV_BWD_GENERAL, **kw))))
            kc.record("conv2d_bwd_fused", case, method == "saliency", got,
                      conv2d_bwd_fused_plain(g, wt, **kw), False,
                      lambda: conv2d_bwd_fused(g, wt, **kw),
                      lambda: conv2d_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * 9 * cout,
                      general_fn=lambda: conv2d_bwd_fused(
                          g, wt, plan=CONV_BWD_GENERAL, **kw))
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

    # B6 fused FC backward: FC1 (no gate) then FC0 (gate by its mask),
    # launched again, under a second tile plan and on the general kernel
    # (its design before the redesign, timed beside it): all bitwise equal;
    # torch.matmul on the pre-gated gradient is timed beside it as a
    # reference point (the gated product is no one library call)
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
            case = (f"{method} [{s},{n},{k}]@[{k},{n_out}]"
                    + (" gate" if gated else ""))
            got = vmm_bwd_fused(g, wt, **kw)
            plan = vmm_bwd_plan(s, n, k, n_out)
            other = second_vmm_bwd_plan(plan)
            _bitwise_repeat("vmm_bwd_fused", case, got, (
                (f"again under {plan}", lambda: vmm_bwd_fused(g, wt, **kw)),
                (f"under {other}",
                 lambda: vmm_bwd_fused(g, wt, plan=other, **kw)),
                ("on the general kernel", lambda: vmm_bwd_fused(
                    g, wt, plan=VMM_BWD_GENERAL, **kw))))
            kc.record("vmm_bwd_fused", case, method == "saliency", got,
                      vmm_bwd_fused_plain(g, wt, **kw), False,
                      lambda: vmm_bwd_fused(g, wt, **kw),
                      lambda: vmm_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * n_out, lib,
                      f32_reference_fn=lambda gg=gg, wt=wt: torch.matmul(
                          gg, wt),
                      general_fn=lambda: vmm_bwd_fused(
                          g, wt, plan=VMM_BWD_GENERAL, **kw))
    g = randn(gen, s, n, 128)
    wt = randn(gen, 128, 4096, scale=(2.0 / 4096) ** 0.5)
    kw = dict(relu_mask=masks.pack_mask(randn(gen, n, 128) > 0),
              method="saliency",
              out_relu_mask=masks.pack_mask(randn(gen, n, 4096) > 0))
    case = "saliency epilogue [3,32,128]@[128,4096]"
    got = vmm_bwd_fused(g, wt, **kw)
    _bitwise_repeat("vmm_bwd_fused", case, got, (
        ("on the general kernel",
         lambda: vmm_bwd_fused(g, wt, plan=VMM_BWD_GENERAL, **kw)),))
    kc.record("vmm_bwd_fused", case, False, got,
              vmm_bwd_fused_plain(g, wt, **kw), False,
              lambda: vmm_bwd_fused(g, wt, **kw),
              lambda: vmm_bwd_fused_plain(g, wt, **kw),
              4 * (g.numel() + wt.numel() + s * n * 4096),
              2 * g.numel() * 4096,
              general_fn=lambda: vmm_bwd_fused(g, wt, plan=VMM_BWD_GENERAL,
                                               **kw))


#: ``--sweep``: the B4 shapes (M, K, N) of the main and vjp paths, and the
#: B1 shapes (H, Cin, Cout) at batch 32: the Table III forward layers, then
#: the input gradients of the vjp path's standalone ops (B1 on the
#: flip-transposed weight).
SWEEP_VMM = ((32, 4096, 128), (32, 128, 10), (32, 128, 4096), (32, 10, 128))
SWEEP_CONV = {"fwd": ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64)),
              "dx": ((16, 64, 32), (32, 32, 3))}
#: ``--sweep``: the fused conv backward's launches of an explain at batch
#: 32, (H, C, Cout', pooled) of layers 3, 2, 1, 0, at (element type, S):
#: the seed-batched f32 and fxp16 paths (S = 3) and the vjp path (S = 1).
SWEEP_BWD_SHAPES = ((16, 64, 64, True), (16, 64, 32, False),
                    (32, 32, 32, True), (32, 32, 3, False))
SWEEP_BWD = ((torch.float32, SEEDS), (torch.float32, 1), (torch.int16, SEEDS))
#: Back-to-back runs per backward plan (hundreds of plans a shape), and
#: the sleep that covers their enqueue.
SWEEP_BWD_REPS, SWEEP_BWD_COVER_MS = 20, 20.0


def _sweep_plans(h, cin, cout, esize=4):
    """A grid of conv forward tile plans (B1; B7 at ``esize`` 2) for one
    shape: rows, pixels a thread, Cout a block, Cin a stage, within the
    block's thread and memory limits."""
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
                            and p.smem_bytes(3, esize=esize) <= 227 * 1024):
                        yield p


def _sweep_bwd_plans(s, h, c, cout, pooled, esize):
    """A grid of fused-backward tile plans for one launch: rows, pixels a
    thread, Cout a block, C a stage, seeds a thread and thread slices (one
    seed, or all S up to 3 in a thread or across slices), within the
    block's thread and memory limits."""
    from repro_torch.kernels.conv2d.conv2d import (CONV_MAX_THREADS,
                                                   CONV_SMEM_LIMIT,
                                                   ConvBwdPlan)
    from repro_torch.kernels.tiling import align_up
    seeds = {(1, 1), (min(s, 3), 1), (1, min(s, 3))}   # (sg, st)
    for th in (1, 2, 4, 8, 16, 32):
        for px in (4, 8):
            for tco in (4, 8, 16, 32, 64):
                for ct in sorted({min(8, c), min(16, c), min(32, c)}):
                    for sg, st in sorted(seeds):
                        p = ConvBwdPlan(th, px, tco, ct, sg, st)
                        if (th <= h and tco <= align_up(cout, 4)
                                and (px == 4 or sg == 1)
                                and 32 <= p.threads <= CONV_MAX_THREADS
                                and p.smem_bytes(3, pooled=pooled,
                                                 esize=esize)
                                <= CONV_SMEM_LIMIT):
                            yield p


def sweep_bwd_plans(gen):
    """``--sweep``, fused conv backward: time a grid of tile plans at each
    launch of :data:`SWEEP_BWD` beside the general kernel, every plan held
    bitwise to ``conv_bwd_plan``'s (and that one to the plain version:
    within DOT_TOL in f32, bitwise in int16); say where the rule lands."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv_bwd_plan)
    from repro_torch.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp,
                                                conv2d_bwd_fused_fxp_plain)
    from repro_torch.kernels.pool import ref as pool_ref

    rows = []
    for dtype, s in SWEEP_BWD:
        fxp = dtype == torch.int16
        fn, plain = ((conv2d_bwd_fused_fxp, conv2d_bwd_fused_fxp_plain)
                     if fxp else (conv2d_bwd_fused, conv2d_bwd_fused_plain))
        for h, c, cout, pooled in SWEEP_BWD_SHAPES:
            y = randn(gen, BATCH, h, h, c)
            idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                   if pooled else None)
            hg = h // 2 if pooled else h
            g = randn(gen, s, BATCH, hg, hg, c, scale=0.5 if fxp else 1e-2)
            wt = randn(gen, 3, 3, c, cout, scale=(2.0 / (9 * c)) ** 0.5)
            if fxp:
                g = fixedpoint.to_fixed(g)
                wt = fixedpoint.to_fixed(wt, fixedpoint.WGT_FRAC)
            kw = dict(pool_idx=idx, relu_mask=masks.pack_mask(y > 0),
                      method="saliency")
            case = (f"bwd {'int16' if fxp else 'f32'} "
                    f"[{s},{BATCH},{hg},{hg},{c}]->{cout}"
                    + (" pool" if pooled else ""))
            chosen = conv_bwd_plan(s, BATCH, h, h, c, cout, 3,
                                   pooled=pooled, esize=g.element_size())
            first = fn(g, wt, **kw)
            want = plain(g, wt, **kw)
            torch.cuda.synchronize()
            if fxp and not torch.equal(first, want):
                fail(f"sweep {case}: not bitwise equal to plain")
            if not fxp:
                e = (first - want).abs().max().item()
                if not e <= DOT_TOL * want.abs().max().item():
                    fail(f"sweep {case}: max|d| {e:.3e} beyond DOT_TOL")
            general = device_time_ms(
                lambda: fn(g, wt, plan=CONV_BWD_GENERAL, **kw),
                reps=SWEEP_BWD_REPS, cover_ms=SWEEP_BWD_COVER_MS)
            found = []
            for p in set(_sweep_bwd_plans(s, h, c, cout, pooled,
                                          g.element_size())) | {chosen}:
                got = fn(g, wt, plan=p, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, first):
                    fail(f"sweep {case}: plan {p} changes the bits")
                found.append((device_time_ms(
                    lambda: fn(g, wt, plan=p, **kw), reps=SWEEP_BWD_REPS,
                    cover_ms=SWEEP_BWD_COVER_MS), p))
            found.sort(key=lambda t: (t[0], t[1].args()))
            rank = [p for _, p in found].index(chosen)
            print(f"  {case}: general kernel {general:.4f} ms; "
                  f"conv_bwd_plan {chosen} {found[rank][0]:.4f} ms (rank "
                  f"{rank + 1} of {len(found)}); fastest:")
            for ms, p in found[:8]:
                print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d} "
                      f"blocks {p.blocks(BATCH, h, h, cout):5d} smem "
                      f"{p.smem_bytes(3, pooled=pooled, esize=g.element_size())}")
            rows.append(dict(
                dtype=str(dtype), seeds=s, shape=[BATCH, h, h, c, cout],
                pooled=pooled, general_ms=general, chosen=chosen.args(),
                chosen_ms=found[rank][0], rank=rank + 1,
                plans=[dict(plan=p.args(), ms=ms) for ms, p in found]))
    return rows


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


#: ``--sweep``, the bf16 forwards: the Table III conv layers (H, Cin, Cout)
#: and FC layers (M, K, N) at batch 32.
SWEEP_BF16_CONV = ((32, 3, 32), (32, 32, 32), (16, 32, 64), (16, 64, 64))
SWEEP_BF16_VMM = ((32, 4096, 128), (32, 128, 10))


def sweep_bf16_choices(gen):
    """``--sweep``, the bf16 forwards: at the four Table III layers every
    tensor-core tile of ``conv_mma_candidates`` (Cin a multiple of 16)
    beside ``F.conv2d`` in bf16 and the FFMA instance (``conv_plan``'s
    tile), and at FC0 and FC1 every tensor-core launch of
    ``vmm_mma_candidates`` beside ``torch.addmm`` in bf16; each within
    :func:`bf16_close` of the plain version, every tile of a layer (FC: of
    one cluster size) the same bits."""
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (conv2d_planned,
                                                   conv_bf16_plan,
                                                   conv_mma_candidates,
                                                   conv_plan)
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import (vmm_mma_candidates,
                                             vmm_mma_plan, vmm_planned)
    bf = torch.bfloat16
    rows = dict(conv_bf16=[], vmm_bf16=[])
    for h, cin, cout in SWEEP_BF16_CONV:
        x = randn(gen, BATCH, h, h, cin).to(bf)
        w = randn(gen, 3, 3, cin, cout,
                  scale=(2.0 / (9 * cin)) ** 0.5).to(bf)
        b = randn(gen, cout, scale=0.1).to(bf)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        acc = conv_ref.conv2d_widened(x, w)
        want = conv_ref.conv2d_bf16(x, w) + b
        lib = device_time_ms(lambda: F.conv2d(xn, wn, b, padding=1))
        ffma_plan = conv_plan(BATCH, h, h, cin, cout, 3, esize=2)
        bf16_close(conv2d_planned(x, w, b, plan=ffma_plan), want, acc)
        ffma = device_time_ms(lambda: conv2d_planned(x, w, b,
                                                     plan=ffma_plan))
        chosen = conv_bf16_plan(BATCH, h, h, cin, cout, 3)
        case = f"conv bf16 [{BATCH},{h},{h},{cin}->{cout}]"
        found = []
        if cin % 16 == 0:
            first = conv2d_planned(x, w, b, plan=chosen)
            bf16_close(first, want, acc)
            for p in conv_mma_candidates(h, h, cin, cout, 3):
                got = conv2d_planned(x, w, b, plan=p)
                torch.cuda.synchronize()
                if not torch.equal(got, first):
                    fail(f"sweep {case}: plan {p} changes the bits")
                found.append((device_time_ms(
                    lambda: conv2d_planned(x, w, b, plan=p)), p))
            found.sort(key=lambda t: (t[0], t[1].args()))
        rank = ([p for _, p in found].index(chosen) if found else None)
        chosen_ms = found[rank][0] if found else ffma
        print(f"  {case}: F.conv2d {lib:.4f} ms; FFMA {ffma_plan} "
              f"{ffma:.4f} ms; conv_bf16_plan {chosen} {chosen_ms:.4f} ms"
              + (f" (rank {rank + 1} of {len(found)}); fastest:" if found
                 else ""))
        for ms, p in found[:8]:
            print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d} blocks "
                  f"{p.blocks(BATCH, h, h, cout):5d} smem "
                  f"{p.smem_bytes(3, cin)}")
        rows["conv_bf16"].append(dict(
            shape=[BATCH, h, h, cin, cout], library_ms=lib,
            ffma=ffma_plan.args(), ffma_ms=ffma, chosen=chosen.args(),
            chosen_ms=chosen_ms, rank=None if rank is None else rank + 1,
            plans=[dict(plan=p.args(), ms=ms) for ms, p in found]))
    for m, k, n in SWEEP_BF16_VMM:
        x = randn(gen, m, k).to(bf)
        w = randn(gen, k, n, scale=k ** -0.5).to(bf)
        b = randn(gen, n).to(bf)
        acc = vmm_ref.vmm_widened(x, w)
        want = vmm_ref.vmm_bf16(x, w) + b
        lib = device_time_ms(lambda: torch.addmm(b, x, w))
        chosen = vmm_mma_plan(m, k, n)
        case = f"vmm bf16 [{m},{k}]@[{k},{n}]"
        found, firsts = [], {}
        for p in vmm_mma_candidates(m, k, n):
            got = vmm_planned(x, w, b, plan=p)
            bf16_close(got, want, acc)
            first = firsts.setdefault(p.cluster, got)
            torch.cuda.synchronize()
            if not torch.equal(got, first):
                fail(f"sweep {case}: {p} changes the bits of its cluster "
                     f"size")
            found.append((device_time_ms(
                lambda: vmm_planned(x, w, b, plan=p)), p))
        found.sort(key=lambda t: (t[0], t[1].cluster, t[1].bn))
        rank = [p for _, p in found].index(chosen)
        print(f"  {case}: addmm {lib:.4f} ms; vmm_mma_plan {chosen} "
              f"{found[rank][0]:.4f} ms (rank {rank + 1} of {len(found)}):")
        for ms, p in found:
            print(f"      {ms:.4f} ms  {p}  blocks {p.blocks(m, n)}")
        rows["vmm_bf16"].append(dict(
            shape=[m, k, n], library_ms=lib,
            chosen=[chosen.bn, chosen.cluster],
            chosen_ms=found[rank][0], rank=rank + 1,
            plans=[dict(bn=p.bn, cluster=p.cluster, ms=ms)
                   for ms, p in found]))
    return rows


#: ``--sweep``: the bf16 backwards' launches at batch 32, S = 3: the four
#: Table III conv layers (H, C, Cout', pooled) and FC0 / FC1 (S, M, K, N,
#: gated).
SWEEP_BF16_BWD = ((16, 64, 64, True), (16, 64, 32, False),
                  (32, 32, 32, True), (32, 32, 3, False))
SWEEP_BF16_VMM_BWD = ((SEEDS, BATCH, 128, 4096, True),
                      (SEEDS, BATCH, 10, 128, False))


def sweep_bf16_bwd_choices(gen):
    """``--sweep``, the bf16 backwards on the tensor cores: at the four
    Table III conv launches every tile of ``conv_bwd_mma_candidates``
    beside the FFMA instance (``conv_bwd_plan``'s tile), and at FC0 and FC1
    every tile of ``vmm_bwd_mma_candidates``; each within
    :func:`bf16_close` of the plain version, every tile of a launch the
    same bits as the rule's (saliency, gated, all seeds)."""
    from repro_torch.core import masks
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (bwd_fused_plain,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv_bwd_bf16_plan,
                                                   conv_bwd_mma_candidates,
                                                   conv_bwd_plan)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import bwd_fused_plain as vbwd_plain
    from repro_torch.kernels.vmm.vmm import (vmm_bwd_fused,
                                             vmm_bwd_fused_plain,
                                             vmm_bwd_mma_candidates,
                                             vmm_bwd_mma_plan)
    bf, s, n = torch.bfloat16, SEEDS, BATCH

    def timed(fn):
        return device_time_ms(fn, reps=SWEEP_BWD_REPS,
                              cover_ms=SWEEP_BWD_COVER_MS)

    def ranked(case, fn, cands, chosen, first, extra):
        found = []
        for p in cands:
            got = fn(p)
            torch.cuda.synchronize()
            if not torch.equal(got, first):
                fail(f"sweep {case}: plan {p} changes the bits")
            found.append((timed(lambda: fn(p)), p))
        found.sort(key=lambda t: (t[0], t[1].args()))
        rank = [p for _, p in found].index(chosen)
        print(f"  {case}: {extra}; rule {chosen} {found[rank][0]:.4f} ms "
              f"(rank {rank + 1} of {len(found)}); fastest:")
        for ms, p in found[:8]:
            print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d}")
        return found, rank

    rows = dict(conv_bwd_bf16=[], vmm_bwd_bf16=[])
    for h, c, cout, pooled in SWEEP_BF16_BWD:
        y = randn(gen, n, h, h, c)
        hg = h // 2 if pooled else h
        g = randn(gen, s, n, hg, hg, c, scale=1e-2).to(bf)
        wt = randn(gen, 3, 3, c, cout, scale=(2.0 / (9 * c)) ** 0.5).to(bf)
        kw = dict(pool_idx=(pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                            if pooled else None),
                  relu_mask=masks.pack_mask(y > 0), gate=True,
                  method="saliency")
        acc = bwd_fused_plain(conv_ref.conv2d_widened, g, wt, **kw)
        want = conv2d_bwd_fused_plain(g, wt, **kw)
        ffma_plan = conv_bwd_plan(s, n, h, h, c, cout, 3, pooled=pooled,
                                  esize=2)
        bf16_close(conv2d_bwd_fused(g, wt, plan=ffma_plan, **kw), want, acc)
        ffma = timed(lambda: conv2d_bwd_fused(g, wt, plan=ffma_plan, **kw))
        chosen = conv_bwd_bf16_plan(s, n, h, h, c, cout, 3, pooled=pooled)
        first = conv2d_bwd_fused(g, wt, plan=chosen, **kw)
        bf16_close(first, want, acc)
        case = (f"conv bwd bf16 [{s},{n},{hg},{hg},{c}]->{cout}"
                + (" pool" if pooled else ""))
        found, rank = ranked(
            case, lambda p: conv2d_bwd_fused(g, wt, plan=p, **kw),
            conv_bwd_mma_candidates(s, h, h, c, cout, 3, pooled=pooled),
            chosen, first, f"FFMA {ffma_plan} {ffma:.4f} ms")
        rows["conv_bwd_bf16"].append(dict(
            shape=[s, n, h, h, c, cout, int(pooled)], ffma=ffma_plan.args(),
            ffma_ms=ffma, chosen=chosen.args(), chosen_ms=found[rank][0],
            rank=rank + 1, plans=[dict(plan=p.args(), ms=ms)
                                  for ms, p in found]))
    for s_, m, k, n_out, gated in SWEEP_BF16_VMM_BWD:
        g = randn(gen, s_, m, k).to(bf)
        wt = randn(gen, k, n_out, scale=(2.0 / n_out) ** 0.5).to(bf)
        kw = dict(relu_mask=(masks.pack_mask(randn(gen, m, k) > 0) if gated
                             else None), gate=gated, method="saliency")
        acc = vbwd_plain(vmm_ref.vmm_widened, g, wt, **kw)
        want = vmm_bwd_fused_plain(g, wt, **kw)
        chosen = vmm_bwd_mma_plan(s_, m, k, n_out)
        first = vmm_bwd_fused(g, wt, plan=chosen, **kw)
        bf16_close(first, want, acc)
        case = (f"vmm bwd bf16 [{s_},{m},{k}]@[{k},{n_out}]"
                + (" gate" if gated else ""))
        found, rank = ranked(
            case, lambda p: vmm_bwd_fused(g, wt, plan=p, **kw),
            vmm_bwd_mma_candidates(s_, m, k, n_out), chosen, first,
            "tensor cores only")
        rows["vmm_bwd_bf16"].append(dict(
            shape=[s_, m, k, n_out, int(gated)], chosen=chosen.args(),
            chosen_ms=found[rank][0], rank=rank + 1,
            plans=[dict(plan=p.args(), ms=ms) for ms, p in found]))
    return rows


def sweep_fxp_choices(gen):
    """``--sweep``, the int16 forwards: time a grid of B7 tile plans at the
    four Table III layers beside the general kernel, and every B9 K split
    at FC0; every plan and split held bitwise to the plain version."""
    from repro_torch.core import fixedpoint
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import CONV_GENERAL, conv_plan
    from repro_torch.kernels.conv2d.fxp import conv2d_fxp_planned
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.fxp import vmm_fxp_with_splits
    from repro_torch.kernels.vmm.vmm import vmm_max_splits, vmm_splits

    def same(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sweep {what}: not bitwise equal to plain")

    rows = dict(conv_fxp=[], vmm_fxp=[])
    for h, cin, cout in SWEEP_CONV["fwd"]:
        x = fixedpoint.to_fixed(torch.clamp_min(randn(gen, BATCH, h, h, cin),
                                                0))
        w = fixedpoint.to_fixed(
            randn(gen, 3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5),
            fixedpoint.WGT_FRAC)
        b = fixedpoint.to_fixed(randn(gen, cout, scale=0.1))
        want = fixedpoint.sat_add(conv_ref.conv2d_fxp(x, w), b)
        case = f"conv int16 [{BATCH},{h},{h},{cin}->{cout}]"
        chosen = conv_plan(BATCH, h, h, cin, cout, 3,
                           esize=x.element_size())
        general = device_time_ms(
            lambda: conv2d_fxp_planned(x, w, b, plan=CONV_GENERAL))
        found = []
        for p in set(_sweep_plans(h, cin, cout, esize=x.element_size())) \
                | {chosen}:
            same(conv2d_fxp_planned(x, w, b, plan=p), want, f"{case} {p}")
            found.append((device_time_ms(
                lambda: conv2d_fxp_planned(x, w, b, plan=p)), p))
        found.sort(key=lambda t: (t[0], t[1].args()))
        rank = [p for _, p in found].index(chosen)
        print(f"  {case}: general kernel {general:.4f} ms; conv_plan "
              f"{chosen} {found[rank][0]:.4f} ms (rank {rank + 1} of "
              f"{len(found)}); fastest:")
        for ms, p in found[:8]:
            print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d} blocks "
                  f"{p.blocks(BATCH, h, h, cout):5d} smem "
                  f"{p.smem_bytes(3, esize=x.element_size())}")
        rows["conv_fxp"].append(dict(
            shape=[BATCH, h, h, cin, cout], general_ms=general,
            chosen=chosen.args(), chosen_ms=found[rank][0], rank=rank + 1,
            plans=[dict(plan=p.args(), ms=ms) for ms, p in found]))
    m, k, n = SWEEP_VMM[0]
    x = fixedpoint.to_fixed(torch.clamp_min(randn(gen, m, k), 0))
    w = fixedpoint.to_fixed(randn(gen, k, n, scale=(2.0 / k) ** 0.5),
                            fixedpoint.WGT_FRAC)
    b = fixedpoint.to_fixed(randn(gen, n, scale=0.1))
    want = fixedpoint.sat_add(vmm_ref.vmm_fxp(x, w), b)
    chosen = vmm_splits(m, k, n)
    for z in range(1, vmm_max_splits(k) + 1):
        same(vmm_fxp_with_splits(x, w, b, splits=z), want,
             f"vmm int16 [{m},{k}]@[{k},{n}] splits {z}")
        ms = device_time_ms(lambda: vmm_fxp_with_splits(x, w, b, splits=z))
        rows["vmm_fxp"].append(dict(shape=[m, k, n], splits=z, ms=ms,
                                    chosen=z == chosen))
        print(f"  vmm int16 [{m},{k}]@[{k},{n}] splits {z:4d}: {ms:.4f} ms"
              + ("  <- vmm_splits" if z == chosen else ""))
    return rows


#: ``--sweep``: the fused FC backward's launches (S, M, K, N): FC0 at the
#: seed-batched S = 3 and at the vjp and training S = 1, and FC1 at S = 3.
SWEEP_VMM_BWD = ((3, 32, 128, 4096), (1, 32, 128, 4096), (3, 32, 10, 128))


def sweep_vmm_bwd_plans(gen):
    """``--sweep``, fused FC backward (B6 f32, B10 int16): time every plan of
    ``vmm_bwd_candidates`` at each launch of :data:`SWEEP_VMM_BWD` beside
    the general kernel; every plan must give the bits of ``vmm_bwd_plan``'s,
    and that one the general kernel's (f32) or the plain version's
    (int16)."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                             vmm_bwd_fused_fxp_plain)
    from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL,
                                             vmm_bwd_candidates,
                                             vmm_bwd_fused, vmm_bwd_plan)

    rows = []
    for dtype in (torch.float32, torch.int16):
        fxp = dtype == torch.int16
        fn = vmm_bwd_fused_fxp if fxp else vmm_bwd_fused
        for s, m, k, n in SWEEP_VMM_BWD:
            g = randn(gen, s, m, k, scale=4.0 if fxp else 1.0)
            wt = randn(gen, k, n, scale=(2.0 / n) ** 0.5)
            if fxp:
                g = fixedpoint.to_fixed(g)
                wt = fixedpoint.to_fixed(wt, fixedpoint.WGT_FRAC)
            kw = dict(relu_mask=masks.pack_mask(randn(gen, m, k) > 0),
                      gate=k > 10, method="saliency")
            case = (f"vmm_bwd {'int16' if fxp else 'f32'} "
                    f"[{s},{m},{k}]@[{k},{n}]" + (" gate" if k > 10 else ""))
            chosen = vmm_bwd_plan(s, m, k, n)
            first = fn(g, wt, plan=chosen, **kw)
            want = (vmm_bwd_fused_fxp_plain(g, wt, **kw) if fxp
                    else fn(g, wt, plan=VMM_BWD_GENERAL, **kw))
            torch.cuda.synchronize()
            if not torch.equal(first, want):
                fail(f"sweep {case}: not bitwise equal to the "
                     + ("plain version" if fxp else "general kernel"))
            general = device_time_ms(
                lambda: fn(g, wt, plan=VMM_BWD_GENERAL, **kw),
                reps=SWEEP_BWD_REPS, cover_ms=SWEEP_BWD_COVER_MS)
            found = []
            for p in set(vmm_bwd_candidates(s, m, k, n)) | {chosen}:
                got = fn(g, wt, plan=p, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, first):
                    fail(f"sweep {case}: plan {p} changes the bits")
                found.append((device_time_ms(
                    lambda: fn(g, wt, plan=p, **kw), reps=SWEEP_BWD_REPS,
                    cover_ms=SWEEP_BWD_COVER_MS), p))
            found.sort(key=lambda t: (t[0], t[1].args()))
            rank = [p for _, p in found].index(chosen)
            print(f"  {case}: general kernel {general:.4f} ms; vmm_bwd_plan "
                  f"{chosen} {found[rank][0]:.4f} ms (rank {rank + 1} of "
                  f"{len(found)}, every plan bitwise equal); fastest:")
            for ms, p in found[:8]:
                print(f"      {ms:.4f} ms  {p}  threads {p.threads:3d} "
                      f"blocks {p.blocks(s * m, n):5d} smem "
                      f"{p.smem_bytes(esize=g.element_size())}")
            rows.append(dict(
                dtype=str(dtype), shape=[s, m, k, n], general_ms=general,
                chosen=chosen.args(), chosen_ms=found[rank][0],
                rank=rank + 1,
                plans=[dict(plan=p.args(), ms=ms) for ms, p in found]))
    return rows


def sweep_relu_pool(gen):
    """``--sweep``, the ReLU / pool template (B2, B3, the fused pass with
    the mask; f32 and int16) at the main-path shapes: every block size of
    ``RELU_POOL_THREADS`` beside the general route, each bitwise equal to
    it, timed three ways: the median of single launches between CUDA
    events, 50 launches between one pair of events, and CUPTI (one
    profiler session after the event timings)."""
    from repro_torch.core import fixedpoint
    from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
    from repro_torch.kernels.relu_mask.relu_mask import relu_fwd
    from repro_torch.kernels.tiling import (RELU_POOL_GENERAL,
                                            RELU_POOL_THREADS, mask_bytes,
                                            relu_pool_threads)
    n = BATCH
    cases = []
    for dtype in (torch.float32, torch.int16):
        def make(*shape):
            x = randn(gen, *shape)
            return fixedpoint.to_fixed(x) if dtype == torch.int16 else x
        name = "int16" if dtype == torch.int16 else "f32"
        for r, c in ((n * 32 * 32, 32), (n * 16 * 16, 64), (n, 128)):
            x = make(r, c)
            cases.append((f"relu_fwd {name} [{r},{c}]", r * mask_bytes(c),
                          lambda x=x, t=None: relu_fwd(x, threads=t),
                          lambda x=x: relu_fwd(x, threads=RELU_POOL_GENERAL)))
        for h, c in ((32, 32), (16, 64)):
            x = make(n, h, h, c)
            work = n * (h // 2) ** 2 * mask_bytes(c)
            xr = torch.clamp_min(x, 0)
            cases.append((f"maxpool_fwd {name} [{n},{h},{h},{c}]", work,
                          lambda x=xr, t=None: maxpool_fwd(x, threads=t),
                          lambda x=xr: maxpool_fwd(
                              x, threads=RELU_POOL_GENERAL)))
            cases.append((f"relu_pool_fwd {name} [{n},{h},{h},{c}] mask",
                          work,
                          lambda x=x, t=None: relu_pool_fwd(x, threads=t),
                          lambda x=x: general_relu_pool(x, True)))
    runs, rows = [], []
    for case, work, fn, general_fn in cases:
        first, general = fn(), general_fn()
        torch.cuda.synchronize()
        if not _same_bits(first, general):
            fail(f"sweep {case}: not bitwise equal to the general route")
        row = dict(case=case, chosen=relu_pool_threads(work), threads={},
                   general=dict(events_ms=device_time_ms(general_fn),
                                batched_ms=batched_ms(general_fn)))
        runs.append((row, None, general_fn))
        for t in RELU_POOL_THREADS:
            if not _same_bits(fn(t=t), first):
                fail(f"sweep {case}: {t} threads change the bits")
            row["threads"][t] = dict(
                events_ms=device_time_ms(lambda: fn(t=t)),
                batched_ms=batched_ms(lambda: fn(t=t)))
            runs.append((row, t, lambda fn=fn, t=t: fn(t=t)))
        rows.append(row)
    times = cupti_per_call([f for _, _, f in runs])
    for (row, t, _), ms in zip(runs, times or [None] * len(runs)):
        (row["general"] if t is None else row["threads"][t])["cupti_ms"] = ms
    for row in rows:
        by = sorted(row["threads"].items(),
                    key=lambda kv: kv[1]["cupti_ms"] or kv[1]["batched_ms"])
        rank = [t for t, _ in by].index(row["chosen"]) + 1
        g = row["general"]
        print(f"  {row['case']}: rule {row['chosen']} threads, rank {rank} "
              f"of {len(by)} (every block size bitwise equal); general "
              f"route events {g['events_ms']:.4f} batched "
              f"{g['batched_ms']:.4f} CUPTI "
              + (f"{g['cupti_ms']:.4f}" if g["cupti_ms"] is not None
                 else "not measured") + "; "
              + "; ".join(f"{t}: events {v['events_ms']:.4f} batched "
                          f"{v['batched_ms']:.4f} CUPTI "
                          + (f"{v['cupti_ms']:.4f}" if v["cupti_ms"]
                             is not None else "not measured")
                          for t, v in by))
        row["rank"] = rank
    return rows


def check_kernels_fxp(kc: KernelCheck):
    """The fxp16 path's kernels (B7-B10, int16 B2/B3), bitwise."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                                   CONV_GENERAL,
                                                   conv_bwd_plan, conv_plan)
    from repro_torch.kernels.conv2d.fxp import (conv2d_bwd_fused_fxp,
                                                conv2d_bwd_fused_fxp_plain,
                                                conv2d_fxp,
                                                conv2d_fxp_planned)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.fxp import (maxpool_fwd_fxp,
                                              relu_pool_fwd_fxp)
    from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                         relu_fwd,
                                                         unpack_bits)
    from repro_torch.kernels.tiling import (RELU_POOL_GENERAL, crumb_bytes,
                                            mask_bytes)
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.fxp import (vmm_bwd_fused_fxp,
                                             vmm_bwd_fused_fxp_plain,
                                             vmm_fxp, vmm_fxp_with_splits)
    from repro_torch.kernels.vmm.vmm import (VMM_BWD_GENERAL, vmm_bwd_plan,
                                             vmm_splits)

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

    # B7 int16 conv forward (+ saturating bias): the four Table III layers,
    # bitwise equal to the plain version, and launched again, under a
    # second tile plan and on the general kernel (timed beside it)
    for h, cin, cout in ((32, 3, 32), (32, 32, 32), (16, 32, 64),
                         (16, 64, 64)):
        x = torch.clamp_min(qact(n, h, h, cin), 0)   # post-ReLU, as fed
        w = qwgt(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = qact(cout, scale=0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        xn, wn = xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1)
        nbytes = 2 * (x.numel() + w.numel() + cout + n * h * h * cout)
        case = f"[{n},{h},{h},{cin}->{cout}]"
        got = conv2d_fxp(x, w, b)
        plan = conv_plan(n, h, h, cin, cout, 3, esize=x.element_size())
        other = second_fwd_plan(plan, cin)
        _bitwise_repeat("conv2d_fxp_fwd", case, got, (
            (f"again under {plan}", lambda: conv2d_fxp(x, w, b)),
            (f"under {other}",
             lambda: conv2d_fxp_planned(x, w, b, plan=other)),
            ("on the general kernel",
             lambda: conv2d_fxp_planned(x, w, b, plan=CONV_GENERAL))))
        kc.record("conv2d_fxp_fwd", case, True, got,
                  sat(conv_ref.conv2d_fxp(x, w), b), True,
                  lambda: conv2d_fxp(x, w, b),
                  lambda: sat(conv_ref.conv2d_fxp(x, w), b), nbytes,
                  n * h * h * cout * 9 * cin, rate=rate,
                  f32_reference_fn=lambda: F.conv2d(xn, wn, bf, padding=1),
                  general_fn=lambda: conv2d_fxp_planned(x, w, b,
                                                        plan=CONV_GENERAL))
    x, w = rails(n, 16, 16, 64), rails(3, 3, 64, 64)   # 576 * 2^30 wraps
    got = conv2d_fxp(x, w)
    other = second_fwd_plan(conv_plan(n, 16, 16, 64, 64, 3, esize=2), 64)
    _bitwise_repeat("conv2d_fxp_fwd", "rails [32,16,16,64->64] wrap", got, (
        (f"under {other}", lambda: conv2d_fxp_planned(x, w, plan=other)),
        ("on the general kernel",
         lambda: conv2d_fxp_planned(x, w, plan=CONV_GENERAL))))
    kc.record("conv2d_fxp_fwd", "rails [32,16,16,64->64] wrap", False,
              got, conv_ref.conv2d_fxp(x, w), True,
              lambda: conv2d_fxp(x, w), lambda: conv_ref.conv2d_fxp(x, w),
              2 * (x.numel() * 2 + w.numel()), x.numel() * 9 * 64,
              rate=rate)

    # int16 B2 relu + mask: the three rectifiers of the fxp16 forward no
    # pool follows, exact zeros giving bit 0 (strict >), and the rails
    for r, c in ((n * 32 * 32, 32), (n * 16 * 16, 64), (n, 128)):
        x = qact(r, c)
        x[0] = 0                          # exact zeros: bit 0 (strict >)
        x[1] = rails(c)
        x[-1, ::3] = -lim - 1
        check_relu_pool(
            kc, "relu_fwd_i16", f"[{r},{c}] int16", x,
            lambda x=x, **kw: relu_fwd(x, **kw),
            lambda x=x: relu_ref.relu_fwd(x),
            lambda x=x: relu_fwd(x, threads=RELU_POOL_GENERAL),
            2 * 2 * r * c + r * mask_bytes(c), r * c, True, rate=rate)

    # int16 B3 pool + argmax alone on post-ReLU int16 maps: ties on the grid
    for h, c in ((32, 32), (16, 64)):
        x = torch.clamp_min(qact(n, h, h, c, scale=0.05), 0)
        nbytes = (2 * x.numel() + 2 * x.numel() // 4
                  + n * (h // 2) ** 2 * crumb_bytes(c))
        check_relu_pool(
            kc, "maxpool_fwd_i16", f"[{n},{h},{h},{c}] int16", x,
            lambda x=x, **kw: maxpool_fwd(x, **kw),
            lambda x=x: pool_ref.maxpool_fwd(x),
            lambda x=x: maxpool_fwd(x, threads=RELU_POOL_GENERAL),
            nbytes, 3 * x.numel() // 4, True, rate=rate)
        if not _same_bits(maxpool_fwd_fxp(x), maxpool_fwd(x)):
            fail(f"maxpool_fwd_fxp [{n},{h},{h},{c}]: differs from "
                 f"maxpool_fwd on int16")

    # int16 B2 + B3 fused at the two pooled layers, with and without the
    # mask, on int16 conv outputs with rails, beside B2 then B3
    for h, c in ((32, 32), (16, 64)):
        x = qact(n, h, h, c, scale=0.05)
        x[:, 0] = rails(n, h, c)
        x[:, 1, 0] = 0
        x[:, 1, 1] = -lim - 1
        for mask in (True, False):
            nbytes = (2 * x.numel() + 2 * x.numel() // 4
                      + n * (h // 2) ** 2 * crumb_bytes(c)
                      + (n * h * h * mask_bytes(c) if mask else 0))
            check_relu_pool(
                kc, "relu_pool_fwd_i16",
                f"[{n},{h},{h},{c}] int16" + (" mask" if mask else
                                              " no mask"), x,
                lambda x=x, mask=mask, **kw: relu_pool_fwd(x, mask, **kw),
                lambda x=x, mask=mask: pool_ref.relu_pool_fwd(x, mask),
                lambda x=x, mask=mask: general_relu_pool(x, mask),
                nbytes, x.numel() + 3 * x.numel() // 4, mask, rate=rate)
        got = relu_pool_fwd_fxp(x)
        if not _same_bits(got, relu_pool_fwd(x)):
            fail(f"relu_pool_fwd_fxp [{n},{h},{h},{c}]: differs from "
                 f"relu_pool_fwd on int16")

    # B9 int16 FC forward (+ saturating bias): FC0 (split K) and FC1 (one
    # slice), bitwise equal to the plain version, and launched again and
    # under a second K split (FC1: its one chunk in four slices)
    for k, m_out in ((4096, 128), (128, 10)):
        x = torch.clamp_min(qact(n, k), 0)
        w = qwgt(k, m_out, scale=(2.0 / k) ** 0.5)
        b = qact(m_out, scale=0.1)
        xf, wf, bf = x.float(), w.float(), b.float()
        nbytes = 2 * (x.numel() + w.numel() + m_out + n * m_out)
        case = f"[{n},{k}]@[{k},{m_out}]"
        got = vmm_fxp(x, w, b)
        splits = vmm_splits(n, k, m_out)
        other = 4 if splits == 1 else splits // 2
        _bitwise_repeat("vmm_fxp_fwd", case, got, (
            (f"again, K in {splits} slice(s)", lambda: vmm_fxp(x, w, b)),
            (f"K in {other} slices",
             lambda: vmm_fxp_with_splits(x, w, b, splits=other))))
        kc.record("vmm_fxp_fwd", case, True, got,
                  sat(vmm_ref.vmm_fxp(x, w), b), True,
                  lambda: vmm_fxp(x, w, b),
                  lambda: sat(vmm_ref.vmm_fxp(x, w), b), nbytes,
                  n * k * m_out, rate=rate,
                  f32_reference_fn=lambda: torch.addmm(bf, xf, wf))
    x, w = rails(n, 4096), rails(4096, 128)           # 4096 * 2^30 wraps
    got = vmm_fxp(x, w)
    _bitwise_repeat(
        "vmm_fxp_fwd", "rails [32,4096]@[4096,128] wrap", got, tuple(
            (f"K in {z} slice(s)",
             lambda z=z: vmm_fxp_with_splits(x, w, splits=z))
            for z in (1, 8, 128)))
    kc.record("vmm_fxp_fwd", "rails [32,4096]@[4096,128] wrap", False,
              got, vmm_ref.vmm_fxp(x, w), True,
              lambda: vmm_fxp(x, w), lambda: vmm_ref.vmm_fxp(x, w),
              2 * (x.numel() + w.numel() + n * 128), n * 4096 * 128,
              rate=rate)

    # B8 int16 fused conv backward: (H, C, Cout', pooled) of layers 3..0,
    # bitwise equal to the plain version, and launched again, under a
    # second tile plan and on the general kernel (timed beside it)
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
            case = (f"{method} [{s},{n},{hg},{hg},{c}]->{cout}"
                    + (" pool" if pooled else ""))
            got = conv2d_bwd_fused_fxp(g, wt, **kw)
            plan = conv_bwd_plan(s, n, h, h, c, cout, 3, pooled=pooled,
                                 esize=g.element_size())
            other = second_bwd_plan(plan, c)
            _bitwise_repeat("conv2d_bwd_fused_fxp", case, got, (
                (f"again under {plan}",
                 lambda: conv2d_bwd_fused_fxp(g, wt, **kw)),
                (f"under {other}",
                 lambda: conv2d_bwd_fused_fxp(g, wt, plan=other, **kw)),
                ("on the general kernel", lambda: conv2d_bwd_fused_fxp(
                    g, wt, plan=CONV_BWD_GENERAL, **kw))))
            kc.record("conv2d_bwd_fused_fxp", case, method == "saliency",
                      got, conv2d_bwd_fused_fxp_plain(g, wt, **kw), True,
                      lambda: conv2d_bwd_fused_fxp(g, wt, **kw),
                      lambda: conv2d_bwd_fused_fxp_plain(g, wt, **kw),
                      nbytes, nnz * 9 * cout, rate=rate,
                      general_fn=lambda: conv2d_bwd_fused_fxp(
                          g, wt, plan=CONV_BWD_GENERAL, **kw))
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
    # ... and at the rails: half the gradient channels and their weights
    # into output channel 0 at +32767, so its int32 sums pass 2^31 and wrap
    g, wt = rails(s, n, 8, 8, 64), rails(3, 3, 64, 64)
    g[..., :32], wt[:, :, :32, 0] = lim, lim
    y = torch.ones(n, 16, 16, 64, device="cuda")          # every bit set
    kw = dict(pool_idx=pool_ref.maxpool_fwd(y)[1], method="saliency",
              relu_mask=masks.pack_mask(y > 0))
    kc.record("conv2d_bwd_fused_fxp", "rails [3,32,8,8,64]->64 pool wrap",
              False, conv2d_bwd_fused_fxp(g, wt, **kw),
              conv2d_bwd_fused_fxp_plain(g, wt, **kw), True,
              lambda: conv2d_bwd_fused_fxp(g, wt, **kw),
              lambda: conv2d_bwd_fused_fxp_plain(g, wt, **kw),
              2 * (g.numel() + wt.numel() + s * n * 256 * 64),
              g.numel() * 9 * 64, rate=rate)

    # B10 int16 fused FC backward: FC1 (no gate) then FC0 (gated), launched
    # again, under a second tile plan and on the general kernel (timed
    # beside it), all bitwise equal; an f32 torch.matmul on the pre-gated
    # gradient beside it, a reference point only
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
            case = (f"{method} [{s},{n},{k}]@[{k},{n_out}]"
                    + (" gate" if gated else ""))
            got = vmm_bwd_fused_fxp(g, wt, **kw)
            plan = vmm_bwd_plan(s, n, k, n_out)
            other = second_vmm_bwd_plan(plan)
            _bitwise_repeat("vmm_bwd_fused_fxp", case, got, (
                (f"again under {plan}",
                 lambda: vmm_bwd_fused_fxp(g, wt, **kw)),
                (f"under {other}",
                 lambda: vmm_bwd_fused_fxp(g, wt, plan=other, **kw)),
                ("on the general kernel", lambda: vmm_bwd_fused_fxp(
                    g, wt, plan=VMM_BWD_GENERAL, **kw))))
            ggf, wtf = gg.float(), wt.float()
            kc.record("vmm_bwd_fused_fxp", case, method == "saliency", got,
                      vmm_bwd_fused_fxp_plain(g, wt, **kw), True,
                      lambda: vmm_bwd_fused_fxp(g, wt, **kw),
                      lambda: vmm_bwd_fused_fxp_plain(g, wt, **kw),
                      nbytes, nnz * n_out, rate=rate,
                      f32_reference_fn=lambda ggf=ggf, wtf=wtf: torch.matmul(
                          ggf, wtf),
                      general_fn=lambda: vmm_bwd_fused_fxp(
                          g, wt, plan=VMM_BWD_GENERAL, **kw))
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
              g.numel() * 4096, rate=rate,
              general_fn=lambda: vmm_bwd_fused_fxp(
                  g, wt, plan=VMM_BWD_GENERAL, **kw))
    # ... and at the rails: FC0's row 0 x column 0 sums 128 products of
    # 2^30 and wraps, under the rule's plan, a second one and the general
    # kernel
    g, wt = rails(s, n, 128), rails(128, 4096)
    g[:, 0], wt[:, 0] = lim, lim
    want = vmm_bwd_fused_fxp_plain(g, wt)
    plan = vmm_bwd_plan(s, n, 128, 4096)
    for p in (plan, second_vmm_bwd_plan(plan), VMM_BWD_GENERAL):
        got = vmm_bwd_fused_fxp(g, wt, plan=p)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"vmm_bwd_fused_fxp rails under {p}: not bitwise equal to "
                 f"plain")
    case = "rails [3,32,128]@[128,4096] wrap"
    print(f"  {'vmm_bwd_fused_fxp':20s} {case:34s} bitwise equal to plain "
          f"under {plan}, {second_vmm_bwd_plan(plan)} and the general kernel")


def second_mma_plan(plan):
    """A valid tile of the tensor-core conv forward other than ``plan``:
    one row a warp, 16-channel chunks and twice the rows (halved back
    while over 256 threads), or 64 channels a block where that is
    ``plan``."""
    from repro_torch.kernels.conv2d.conv2d import ConvMmaPlan
    th = 2 * plan.th
    while 32 * th * (plan.tco // 32) > 256:
        th //= 2
    other = ConvMmaPlan(th, 1, plan.tco, 16)
    return other if other != plan else ConvMmaPlan(plan.th, plan.mt, 64, 16)


def second_bwd_mma_plan(plan):
    """A valid tile of the tensor-core conv backward other than ``plan``:
    the seeds moved between the warps and the seed slices, 16-channel
    chunks (so the ring runs C = 32 and 64 in two and four), and as many
    rows as 256 threads allow; or half the rows where that is ``plan``."""
    from repro_torch.kernels.conv2d.conv2d import ConvBwdMmaPlan
    sg, st = ((1, plan.seeds) if plan.sg > 1 else (plan.seeds, 1))
    th = plan.th
    while th > 1 and ConvBwdMmaPlan(th, 1, plan.tco, 16, sg, st).threads \
            > 256:
        th //= 2
    other = ConvBwdMmaPlan(th, 1, plan.tco, 16, sg, st)
    return other if other != plan else ConvBwdMmaPlan(
        max(1, plan.th // 2), 1, plan.tco, 16, plan.sg, plan.st)


def second_vmm_bwd_mma_plan(plan):
    """A valid tile of the tensor-core FC backward other than ``plan``: 32
    rows x 64 columns a block, two m16 fragments a warp and 16-deep chunks
    (so FC0's 96 rows take three row blocks and its K eight chunks), or
    16 x 16 where that is ``plan``."""
    from repro_torch.kernels.vmm.vmm import VmmBwdMmaPlan
    other = VmmBwdMmaPlan(32, 64, 16, 2, 4)
    return other if other != plan else VmmBwdMmaPlan(16, 16, 16, 1, 2)


def _accumulation_row(what, got, plain, s64, acc):
    """One line of :func:`check_mma_accumulation`: the kernel's and the
    plain version's largest distance from the f64 sum, in units of
    max|sum|, their outputs off the correctly rounded bf16 of it, and the
    kernel's largest share of the :func:`bf16_close` bound."""
    torch.cuda.synchronize()
    top = s64.abs().max().item()
    near = s64.to(torch.bfloat16)
    err = (got.double() - s64).abs().max().item() / top
    perr = (plain.double() - s64).abs().max().item() / top
    off = int((got != near).sum().item())
    poff = int((plain != near).sum().item())
    bound = (BF16_STEP * (acc.abs() + plain.float().abs())
             + DOT_TOL * acc.abs().max())
    share = ((got.float() - plain.float()).abs() / bound).max().item()
    bf16_close(got, plain, acc)
    print(f"  {what:46s} |y - sum64| {err:.3e} of max|sum| (plain "
          f"{perr:.3e}); off the rounded f64 sum {off} of {got.numel()} "
          f"(plain {poff}); {share:.3f} of the bf16_close bound")
    return dict(case=what, err_of_max=err, plain_err_of_max=perr,
                off_rounding=off, plain_off_rounding=poff,
                outputs=got.numel(), bound_share=share)


def check_mma_accumulation(gen):
    """Phase 2, before any timing: the tensor-core kernels' outputs (no
    bias: the sum rounded once) against the f64 sum of the widened
    operands, beside the plain version's, at the main-path shapes (the
    forwards' conv layers 1-3, FC0 with its K = 4096, FC1; the backwards'
    four conv layers, gated, all S seeds, FC0 gated and FC1) and at three
    long sums that cancel (alternating signs): a conv over C = 608 at K =
    5, forward and gated backward, and FC0's K = 4096.  Each must be
    within :func:`bf16_close` of the plain version; the lines are what
    PERF.md quotes."""
    from repro_torch.core import masks
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (bwd_fused_plain, conv2d,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import bwd_fused_plain as vbwd_plain
    from repro_torch.kernels.vmm.vmm import (vmm, vmm_bwd_fused,
                                             vmm_bwd_fused_plain)

    print("  tensor-core accumulation (bf16 out, no bias) against the f64 "
          "sum of the widened operands:")

    def operands(shape_x, shape_w, scale, cancel):
        x = randn(gen, *shape_x).to(torch.bfloat16)
        w = randn(gen, *shape_w, scale=scale).to(torch.bfloat16)
        if cancel:       # channel c of x has sign (-1)^c, w is positive
            c = shape_x[-1]
            sign = (torch.arange(c, device=x.device) % 2 * 2 - 1).to(x.dtype)
            x, w = x.abs() * sign, w.abs()
        return x, w

    rows = []
    for h, cin, cout, k, cancel in ((32, 32, 32, 3, False),
                                    (16, 32, 64, 3, False),
                                    (16, 64, 64, 3, False),
                                    (16, 608, 64, 5, True)):
        nb = BATCH if not cancel else 4
        x, w = operands((nb, h, h, cin), (k, k, cin, cout),
                        (2.0 / (k * k * cin)) ** 0.5, cancel)
        s64 = conv_ref.conv2d(x.double(), w.double())
        rows.append(_accumulation_row(
            f"conv [{nb},{h},{h},{cin}->{cout}] K {k}"
            + (" cancelling" if cancel else ""), conv2d(x, w),
            conv_ref.conv2d_bf16(x, w), s64, conv_ref.conv2d_widened(x, w)))
    for k, m_out, cancel in ((4096, 128, False), (128, 10, False),
                             (4096, 128, True)):
        x, w = operands((BATCH, k), (k, m_out), (2.0 / k) ** 0.5, cancel)
        s64 = x.double() @ w.double()
        rows.append(_accumulation_row(
            f"fc [{BATCH},{k}]@[{k},{m_out}]"
            + (" cancelling" if cancel else ""), vmm(x, w),
            vmm_ref.vmm_bf16(x, w), s64, vmm_ref.vmm_widened(x, w)))

    def s64_conv(a, b):
        return conv_ref.conv2d(a.double(), b.double())

    for h, c, cout, pooled, k, cancel in ((16, 64, 64, True, 3, False),
                                          (16, 64, 32, False, 3, False),
                                          (32, 32, 32, True, 3, False),
                                          (32, 32, 3, False, 3, False),
                                          (16, 608, 64, False, 5, True)):
        nb = BATCH if not cancel else 4
        y = randn(gen, nb, h, h, c)
        idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1] if pooled
               else None)
        hg = h // 2 if pooled else h
        g, wt = operands((SEEDS, nb, hg, hg, c), (k, k, c, cout),
                         (2.0 / (k * k * c)) ** 0.5, cancel)
        kw = dict(pool_idx=idx, relu_mask=masks.pack_mask(y > 0), gate=True,
                  method="saliency")
        rows.append(_accumulation_row(
            f"conv bwd [{SEEDS},{nb},{hg},{hg},{c}]->{cout} K {k}"
            + (" pool" if pooled else "") + (" cancelling" if cancel
                                             else ""),
            conv2d_bwd_fused(g, wt, **kw), conv2d_bwd_fused_plain(g, wt, **kw),
            bwd_fused_plain(s64_conv, g, wt, **kw),
            bwd_fused_plain(conv_ref.conv2d_widened, g, wt, **kw)))
    for k, n_out, gated in ((128, 4096, True), (10, 128, False)):
        g, wt = operands((SEEDS, BATCH, k), (k, n_out), (2.0 / n_out) ** 0.5,
                         False)
        kw = dict(relu_mask=(masks.pack_mask(randn(gen, BATCH, k) > 0)
                             if gated else None),
                  gate=gated, method="saliency")
        rows.append(_accumulation_row(
            f"fc bwd [{SEEDS},{BATCH},{k}]@[{k},{n_out}]"
            + (" gate" if gated else ""),
            vmm_bwd_fused(g, wt, **kw), vmm_bwd_fused_plain(g, wt, **kw),
            vbwd_plain(lambda a, b: a.double() @ b.double(), g, wt, **kw),
            vbwd_plain(vmm_ref.vmm_widened, g, wt, **kw)))
    return rows


def bf16_close(got, want, acc):
    """Fail unless every bf16 output ``got`` is within one bf16 step of the
    unrounded f32 sum ``acc`` plus one of ``want`` (the plain version's),
    plus the f32 kernels' DOT_TOL for the reordered f32 sum itself:
    ``|got - want| <= BF16_STEP * (|acc| + |want|) + DOT_TOL * max|acc|``.
    Returns the largest ``|got - want|``."""
    err = (got.float() - want.float()).abs()
    bound = (BF16_STEP * (acc.abs() + want.float().abs())
             + DOT_TOL * acc.abs().max())
    over = (err - bound).max().item()
    if over > 0:
        fail(f"bf16 output off its plain version by {over:.3e} beyond one "
             f"rounding step of the sum and one of the output")
    return err.max().item()


def check_kernels_bf16(kc: KernelCheck):
    """The bf16 path's instances of B1-B6 and the fused ReLU/pool pass at
    the Table III shapes: the ReLU / pool instances bitwise (plain version,
    general route, every block size); the conv and FC instances within one
    bf16 rounding step (:func:`bf16_close`) of their plain versions (f32
    sums of the widened operands in cuDNN's or cuBLAS's order, rounded),
    bitwise run to run and under a second plan of their route, the FFMA
    routes of B1 layers 1-3 and of B5 within one bf16 step of the tensor
    cores (B5's timed beside them); each timed beside the bf16 library
    call where one computes the same function (``F.conv2d``,
    ``torch.addmm``, ungated FC1 ``torch.matmul``: tensor cores).  Bytes
    at 2 an element; the conv and FC products' operations at the card's
    bf16 peak (BF16_FLOP_PER_S), whatever units a kernel runs on, the
    compares at the f32 rate (those rows are bound by bytes)."""
    from repro_torch.core import masks
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.kernels.conv2d.conv2d import (ConvBwdMmaPlan,
                                                   ConvMmaPlan,
                                                   bwd_fused_plain, conv2d,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv2d_planned,
                                                   conv_bf16_plan,
                                                   conv_bwd_bf16_plan,
                                                   conv_bwd_plan, conv_plan)
    from repro_torch.kernels.pool import ref as pool_ref
    from repro_torch.kernels.pool.pool import maxpool_fwd, relu_pool_fwd
    from repro_torch.kernels.relu_mask import ref as relu_ref
    from repro_torch.kernels.relu_mask.relu_mask import (gate_gradient,
                                                         relu_fwd,
                                                         unpack_bits)
    from repro_torch.kernels.tiling import (RELU_POOL_GENERAL, crumb_bytes,
                                            mask_bytes)
    from repro_torch.kernels.vmm import ref as vmm_ref
    from repro_torch.kernels.vmm.vmm import bwd_fused_plain as vbwd_plain
    from repro_torch.kernels.vmm.vmm import (VmmMmaPlan, vmm, vmm_bwd_fused,
                                             vmm_bwd_fused_plain,
                                             vmm_bwd_mma_plan, vmm_mma_plan,
                                             vmm_planned)

    gen = torch.Generator(device="cuda").manual_seed(2718)
    n, s, bf = BATCH, SEEDS, torch.bfloat16

    def rb(*shape, scale=1.0):
        return randn(gen, *shape, scale=scale).to(bf)

    kc.accumulation = check_mma_accumulation(gen)

    # B1 bf16: the four Table III layers (+ bias after the rounding), run
    # to run and under a second tile plan of its route bitwise (layers 1-3
    # on the tensor cores, also the FFMA route within one bf16 step);
    # F.conv2d in bf16 beside
    for h, cin, cout in ((32, 3, 32), (32, 32, 32), (16, 32, 64),
                         (16, 64, 64)):
        x = rb(n, h, h, cin)
        w = rb(3, 3, cin, cout, scale=(2.0 / (9 * cin)) ** 0.5)
        b = rb(cout, scale=0.1)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        got = conv2d(x, w, b)
        plan = conv_bf16_plan(n, h, h, cin, cout, 3)
        mma = isinstance(plan, ConvMmaPlan)
        other = (second_mma_plan(plan) if mma
                 else second_fwd_plan(plan, cin))
        case = f"[{n},{h},{h},{cin}->{cout}] {'mma' if mma else 'ffma'}"
        row = "conv2d_fwd_bf16" if mma else "conv2d_fwd_bf16_ffma"
        _bitwise_repeat(row, case, got, (
            (f"again under {plan}", lambda: conv2d(x, w, b)),
            (f"under {other}", lambda: conv2d_planned(x, w, b, plan=other))))
        acc = conv_ref.conv2d_widened(x, w)
        if mma:
            ffma = conv_plan(n, h, h, cin, cout, 3, esize=2)
            err = bf16_close(conv2d_planned(x, w, b, plan=ffma), got, acc)
            print(f"  {'conv2d_fwd_bf16':20s} {case:34s} the FFMA route "
                  f"{ffma} within one bf16 step (max|d| {err:.2e})")
        kc.record(row, case, True, got,
                  conv_ref.conv2d_bf16(x, w) + b, False,
                  lambda: conv2d(x, w, b),
                  lambda: conv_ref.conv2d_bf16(x, w) + b,
                  2 * (x.numel() + w.numel() + cout + n * h * h * cout),
                  2 * n * h * h * cout * 9 * cin,
                  lambda: F.conv2d(xn, wn, b, padding=1),
                  rate=BF16_FLOP_PER_S,
                  close=lambda g, w_, acc=acc: bf16_close(g, w_, acc))

    # B2 bf16: the three rectifiers no pool follows; -0.0 gives +0.0
    for r, c in ((n * 32 * 32, 32), (n * 16 * 16, 64), (n, 128)):
        x = rb(r, c)
        x[0] = 0.0
        x[1] = -0.0
        check_relu_pool(
            kc, "relu_fwd_bf16", f"[{r},{c}]", x,
            lambda x=x, **kw: relu_fwd(x, **kw),
            lambda x=x: relu_ref.relu_fwd(x),
            lambda x=x: relu_fwd(x, threads=RELU_POOL_GENERAL),
            2 * 2 * r * c + r * mask_bytes(c), r * c, True)

    # B3 bf16 alone: the pool of a layer with no ReLU before it
    # (TABLE_III_LITERAL, conv_relu=False), on conv outputs
    for h, c in ((32, 32), (16, 64)):
        x = rb(n, h, h, c)
        check_relu_pool(
            kc, "maxpool_fwd_bf16", f"[{n},{h},{h},{c}]", x,
            lambda x=x, **kw: maxpool_fwd(x, **kw),
            lambda x=x: pool_ref.maxpool_fwd(x),
            lambda x=x: maxpool_fwd(x, threads=RELU_POOL_GENERAL),
            2 * x.numel() + 2 * x.numel() // 4
            + n * (h // 2) ** 2 * crumb_bytes(c), 3 * x.numel() // 4, True)

    # B2 + B3 fused bf16 at the two pooled layers, with and without the mask
    for h, c in ((32, 32), (16, 64)):
        x = rb(n, h, h, c)
        x[:, 0, 0] = 0.0
        x[:, 0, 1] = -0.0
        for mask in (True, False):
            nbytes = (2 * x.numel() + 2 * x.numel() // 4
                      + n * (h // 2) ** 2 * crumb_bytes(c)
                      + (n * h * h * mask_bytes(c) if mask else 0))
            check_relu_pool(
                kc, "relu_pool_fwd_bf16",
                f"[{n},{h},{h},{c}]" + (" mask" if mask else " no mask"), x,
                lambda x=x, mask=mask, **kw: relu_pool_fwd(x, mask, **kw),
                lambda x=x, mask=mask: pool_ref.relu_pool_fwd(x, mask),
                lambda x=x, mask=mask: general_relu_pool(x, mask),
                nbytes, x.numel() + 3 * x.numel() // 4, mask)

    # B4 bf16: FC0 and FC1 on the tensor cores, one launch and no
    # workspace (the device memory a call allocates is y's alone), run to
    # run and under the other column tile bitwise; torch.addmm in bf16
    # beside
    for k, m_out in ((4096, 128), (128, 10)):
        x = rb(n, k)
        w = rb(k, m_out, scale=(2.0 / k) ** 0.5)
        b = rb(m_out, scale=0.1)
        plan = vmm_mma_plan(n, k, m_out)
        case = f"[{n},{k}]@[{k},{m_out}] mma"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = vmm(x, w, b)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        if grew > -(-2 * got.numel() // 512) * 512:
            fail(f"vmm_fwd_bf16 {case}: a call allocated {grew} B, more "
                 f"than y's {2 * got.numel()} (a workspace?)")
        other = VmmMmaPlan(32 if plan.bn == 16 else 16, plan.cluster)
        _bitwise_repeat("vmm_fwd_bf16", case, got, (
            (f"again under {plan}", lambda: vmm(x, w, b)),
            (f"under {other}", lambda: vmm_planned(x, w, b, plan=other))))
        acc = vmm_ref.vmm_widened(x, w)
        print(f"  {'vmm_fwd_bf16':20s} {case:34s} allocates {grew} B (y "
              f"{2 * got.numel()} B)")
        kc.record("vmm_fwd_bf16", case, True, got,
                  vmm_ref.vmm_bf16(x, w) + b, False, lambda: vmm(x, w, b),
                  lambda: vmm_ref.vmm_bf16(x, w) + b,
                  2 * (x.numel() + w.numel() + m_out + n * m_out),
                  2 * n * k * m_out, lambda: torch.addmm(b, x, w),
                  rate=BF16_FLOP_PER_S,
                  close=lambda g, w_, acc=acc: bf16_close(g, w_, acc))

    # B5 bf16 on the tensor cores: layers 3, 2, 1, 0 under every method,
    # again and under a second tile plan bitwise; the FFMA route (conv_bwd.cuh
    # bf16 instance) on the same inputs within one bf16 step, timed beside
    for method in METHODS:
        for h, c, cout, pooled in ((16, 64, 64, True), (16, 64, 32, False),
                                   (32, 32, 32, True), (32, 32, 3, False)):
            y = rb(n, h, h, c)
            mask = None if method == "deconvnet" else masks.pack_mask(y > 0)
            idx = (pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                   if pooled else None)
            hg = h // 2 if pooled else h
            g = rb(s, n, hg, hg, c, scale=1e-2)
            wt = rb(3, 3, c, cout, scale=(2.0 / (9 * c)) ** 0.5)
            kw = dict(pool_idx=idx, relu_mask=mask, gate=True, method=method)
            gg = g
            if pooled:
                gg = pool_ref.unpool_scatter(masks.unpack_crumbs(idx, c), g)
            bits = None if mask is None else unpack_bits(mask)[..., :c]
            nnz = torch.count_nonzero(gate_gradient(gg, bits, method)).item()
            nbytes = (2 * (g.numel() + wt.numel() + s * n * h * h * cout)
                      + (idx.numel() if pooled else 0)
                      + (mask.numel() if mask is not None else 0))
            case = (f"{method} [{s},{n},{hg},{hg},{c}]->{cout}"
                    + (" pool" if pooled else ""))
            got = conv2d_bwd_fused(g, wt, **kw)
            plan = conv_bwd_bf16_plan(s, n, h, h, c, cout, 3, pooled=pooled)
            if not isinstance(plan, ConvBwdMmaPlan):
                fail(f"conv2d_bwd_fused_bf16 {case}: rule's plan {plan} is "
                     f"not the tensor cores'")
            other = second_bwd_mma_plan(plan)
            _bitwise_repeat("conv2d_bwd_fused_bf16", case, got, (
                (f"again under {plan}", lambda: conv2d_bwd_fused(g, wt, **kw)),
                (f"under {other}",
                 lambda: conv2d_bwd_fused(g, wt, plan=other, **kw))))
            acc = bwd_fused_plain(conv_ref.conv2d_widened, g, wt, **kw)
            ffma = conv_bwd_plan(s, n, h, h, c, cout, 3, pooled=pooled,
                                 esize=2)
            err = bf16_close(conv2d_bwd_fused(g, wt, plan=ffma, **kw), got,
                             acc)
            print(f"  {'conv2d_bwd_fused_bf16':20s} {case:34s} the FFMA "
                  f"route {ffma} within one bf16 step (max|d| {err:.2e})")
            kc.record("conv2d_bwd_fused_bf16", case, method == "saliency",
                      got, conv2d_bwd_fused_plain(g, wt, **kw), False,
                      lambda: conv2d_bwd_fused(g, wt, **kw),
                      lambda: conv2d_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * 9 * cout, rate=BF16_FLOP_PER_S,
                      close=lambda g_, w_, acc=acc: bf16_close(g_, w_, acc),
                      general_fn=lambda: conv2d_bwd_fused(g, wt, plan=ffma,
                                                          **kw),
                      general_what="ffma")

    # B6 bf16 on the tensor cores: FC1 then FC0 (gated) under every
    # method, again and under a second tile plan bitwise
    for method in METHODS:
        for k, n_out, gated in ((10, 128, False), (128, 4096, True)):
            g = rb(s, n, k)
            wt = rb(k, n_out, scale=(2.0 / n_out) ** 0.5)
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
            case = (f"{method} [{s},{n},{k}]@[{k},{n_out}]"
                    + (" gate" if gated else ""))
            got = vmm_bwd_fused(g, wt, **kw)
            plan = vmm_bwd_mma_plan(s, n, k, n_out)
            other = second_vmm_bwd_mma_plan(plan)
            _bitwise_repeat("vmm_bwd_fused_bf16", case, got, (
                (f"again under {plan}", lambda: vmm_bwd_fused(g, wt, **kw)),
                (f"under {other}",
                 lambda: vmm_bwd_fused(g, wt, plan=other, **kw))))
            acc = vbwd_plain(vmm_ref.vmm_widened, g, wt, **kw)
            lib = None if gated else (lambda g=g, wt=wt: torch.matmul(g, wt))
            kc.record("vmm_bwd_fused_bf16", case, method == "saliency", got,
                      vmm_bwd_fused_plain(g, wt, **kw), False,
                      lambda: vmm_bwd_fused(g, wt, **kw),
                      lambda: vmm_bwd_fused_plain(g, wt, **kw),
                      nbytes, 2 * nnz * n_out, lib, rate=BF16_FLOP_PER_S,
                      close=lambda g_, w_, acc=acc: bf16_close(g_, w_, acc))


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


def _grad_close(got, want, what="selective_scan_bwd"):
    """|got - want| <= SCAN_GRAD_TOL * max|want| elementwise, plus one bf16
    step (2^-7 * |want|) for a bf16 gradient; returns the largest
    |got - want|."""
    g, w = got.float(), want.float()
    bound = SCAN_GRAD_TOL * w.abs().max()
    if got.dtype == torch.bfloat16:
        bound = bound + SCAN_BF16_RTOL * w.abs()
    d = (g - w).abs()
    if not bool((d <= bound).all()):
        fail(f"{what}: max|d| {d.max().item():.3e} beyond {SCAN_GRAD_TOL} "
             f"x max|ref| {w.abs().max().item():.3e}")
    return d.max().item()


class _ChunkedGradScan(torch.autograd.Function):
    """B13's forward with the backward it had before its kernel: autograd
    over ``models.mamba.chunked_scan`` on the saved inputs.  Only for
    comparison: phase 2 times it, phase 7 holds the kernel backward's
    scores against it.  The port's main path never runs it."""

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, h0, d_tile, chunk):
        from repro_torch.kernels.ssm_scan import ssm_scan
        ctx.chunk = chunk
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0)
        return ssm_scan.selective_scan(dt, x, bmat, cmat, a, h0,
                                       d_tile=d_tile, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models import mamba
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(w)
                    for t, w in zip(ctx.saved_tensors, need)]
            y, h_last = mamba.chunked_scan(*args, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, h_last), [t for t, w in zip(args, need) if w],
                (gy, gh), allow_unused=True))
        return tuple(next(grads) if w else None for w in need) + (None, None)


def _chunked_grad_scan(dt, x, bmat, cmat, a, h0, *, d_tile=None,
                       chunk=None):
    """``ops.selective_scan``'s signature over :class:`_ChunkedGradScan`."""
    return _ChunkedGradScan.apply(dt, x, bmat, cmat, a, h0,
                                  int(d_tile or 256), int(chunk or 64))


def check_kernels_scan(kc: KernelCheck):
    """B13 at falcon-mamba-7b's explain shape (B = 4 prompts, S = 72, D =
    8192, N = 16; x bf16 on the main path, f32 beside it), a ragged S = 13,
    and two knob pairs that must agree bit for bit; then B13's backward
    kernel on the same inputs: on the main path's gradients (dt, x, B, C;
    h_last unused, so no gh) and, beside it, all six with a gh, against the
    plain reverse recurrence, bitwise under both knob pairs and run to run.
    No PyTorch call computes either: the library column is none.  The
    backward the kernel replaced (autograd over the chunked scan) and
    autograd over the sequential loop are timed beside it."""
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import (selective_scan,
                                                       selective_scan_bwd)

    gen = torch.Generator(device="cuda").manual_seed(1357)
    b, d, n = LM_BATCH, 8192, 16
    tiles = ((d, 128), (256, 64))     # the explain's knobs, the default's
    main_needs = (True, True, True, True, False, False)

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

        # the backward: the main path's gradients, then all six with a gh
        gy = randn(gen, b, s, d).to(dtype)
        gh = randn(gen, b, d, n)
        for needs, g_h in ((main_needs, None), (None, gh)):
            every = needs is None

            def bwd(dtl=d, ck=128, needs=needs, g_h=g_h):
                return selective_scan_bwd(*args, gy, g_h, d_tile=dtl,
                                          chunk=ck, needs=needs)

            def plain(needs=needs, g_h=g_h):
                return scan_ref.selective_scan_bwd(*args, gy, g_h, needs)

            outs = [bwd(dtl, ck) for dtl, ck in tiles] + [bwd()]
            torch.cuda.synchronize()
            for other in outs[1:]:
                if not all(torch.equal(g, g0) for g, g0 in zip(other, outs[0])
                           if g0 is not None):
                    fail(f"selective_scan_bwd {case}: knobs {tiles} or a "
                         f"second run change the bits")
            want = plain()
            pick = [i for i, g in enumerate(outs[0]) if g is not None]
            # the forward's operands, gy in place of y, gh in place of
            # h_last where given, and the gradients asked for
            nb_bwd = (nbytes - (4 * b * d * n if g_h is None else 0)
                      + sum(outs[0][i].numel() * outs[0][i].element_size()
                            for i in pick))
            kc.record("selective_scan_bwd",
                      case + (" all six, gh" if every else ""),
                      main and not every,
                      tuple(outs[0][i] for i in pick),
                      tuple(want[i] for i in pick), False, bwd, plain,
                      nb_bwd, b * s * d * n,
                      rate=kc.mufu_per_s, close=_grad_close)
        if main:
            leaves = [t.detach().requires_grad_() for t in args]
            # the backward B13 had before its kernel (recompute + autograd
            # over the chunked scan), and the JAX package's form
            y, _ = _ChunkedGradScan.apply(*leaves, d, 128)

            def backward():
                torch.autograd.grad(y, leaves, gy, retain_graph=True)

            kc.scan_backward_ms = _span_ms(backward)
            y_loop, _ = scan_ref.selective_scan(*leaves)

            def backward_loop():
                torch.autograd.grad(y_loop, leaves, gy, retain_graph=True)

            kc.scan_backward_loop_ms = _span_ms(backward_loop)
            print(f"  {'(before the kernel)':20s} {case:34s} autograd over "
                  f"the chunked scan (the port's until now): "
                  f"{kc.scan_backward_ms:.4f} ms per layer; over the "
                  f"sequential loop (the JAX package's form): "
                  f"{kc.scan_backward_loop_ms:.4f} ms")
    print(f"  selective_scan and selective_scan_bwd knobs {tiles[0]} and "
          f"{tiles[1]}: bitwise equal (the backward also run to run)")


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
#: path; every other counter must stay at 0 (B3 alone among them: the
#: pooled layers run ReLU and pool as one fused launch)
PER_EXPLAIN = {
    "f32": {"conv2d_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
            "vmm_fwd": 2, "conv2d_bwd_fused": 4, "vmm_bwd_fused": 2},
    # the bf16 instances, under the f32 counters
    "bf16": {"conv2d_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
             "vmm_fwd": 2, "conv2d_bwd_fused": 4, "vmm_bwd_fused": 2},
    "fxp16": {"conv2d_fxp_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
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


def _heatmap_agreement(rel, ref):
    """``fidelity.compare`` (k = 64) of each (seed, example) heatmap of
    ``rel`` against ``ref``'s: the mean and the least of each metric."""
    from repro_torch.core import fidelity
    from repro_torch.engine.methods import heatmap
    hs = heatmap(rel.float().flatten(0, 1))
    hr = heatmap(ref.float().flatten(0, 1))
    rows = [fidelity.compare(a, b, k=64) for a, b in zip(hs, hr)]
    return {m: (statistics.fmean(r[m] for r in rows), min(r[m] for r in rows))
            for m in rows[0]}


def check_engine(params, cfg, x_cpu, precision, to_profile):
    """Phase 3 for one path.  f32 within the stated tolerances, bf16
    within BF16_TOL (relevance also against the CPU's replay of the card's
    stored bits, and its heatmaps ranked against f32's on the same
    seeds); fxp16 is integer arithmetic, so logits, every residual bit,
    the relevance and both cross-replays must equal the CPU twin's bit for
    bit."""
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.kernels import ENTRY_LAUNCHES, LAUNCHES
    from repro_torch.kernels._build import ROUTE_LAUNCHES
    from repro_torch.models import cnn

    exact = precision == "fxp16"
    tol, rtol = ((BF16_TOL, BF16_TOL) if precision == "bf16"
                 else (DOT_TOL, REPLAY_TOL))
    x = x_cpu.cuda()
    results = {}
    for method in METHODS:
        spec = dict(method=method, precision=precision, targets=TopK(SEEDS))
        eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"), **spec))
        twin = build(EngineSpec(CNNModel(params, cfg, device="cpu"), **spec))
        before, before_e = dict(LAUNCHES), dict(ENTRY_LAUNCHES)
        before_r = dict(ROUTE_LAUNCHES)
        logits, rel, res = eng.predict_then_explain(x)
        torch.cuda.synchronize()
        rose = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        want = {k: 0 for k in LAUNCHES}
        want.update(PER_EXPLAIN[precision])
        if method == "deconvnet":
            # Table II: no mask stored; the pooled layers still run the
            # fused pass (without the mask), the others torch.clamp_min
            want["relu_fwd"] = 0
        if rose != want:
            fail(f"{precision} {method}: launches per explain {rose}, "
                 f"want {want}")
        if precision == "bf16":
            # every launch through a bf16 entry point, and bf16 out
            rose_e = {k: ENTRY_LAUNCHES[k] - before_e[k]
                      for k in ENTRY_LAUNCHES}
            want_e = bf16_entries(want, ENTRY_LAUNCHES)
            if rose_e != want_e:
                fail(f"bf16 {method}: launches per entry point "
                     f"{ {k: v for k, v in rose_e.items() if v} }, want "
                     f"{ {k: v for k, v in want_e.items() if v} }")
            check_bf16_routes(f"bf16 {method}", {
                k: ROUTE_LAUNCHES[k] - before_r[k] for k in ROUTE_LAUNCHES},
                rose)
            if not logits.dtype == rel.dtype == torch.bfloat16:
                fail(f"bf16 {method}: logits {logits.dtype}, relevance "
                     f"{rel.dtype}, want torch.bfloat16")
        if tuple(rel.shape) != (SEEDS, BATCH, 32, 32, 3) or not bool(
                torch.isfinite(rel).all()):
            fail(f"{method}: relevance {tuple(rel.shape)} not finite/shaped")

        logits_c, rel_c, res_c = twin.predict_then_explain(x_cpu)
        err = (logits.cpu().float() - logits_c.float()).abs().max().item()
        ref = logits_c.float().abs().max().item()
        if not err <= (0.0 if exact else tol * ref):
            fail(f"{precision} {method}: logits card vs CPU {err:.3e}")
        flips, bits = _residual_bit_flips(res, res_c)
        if flips > (0 if exact else (1 - MIN_BIT_AGREEMENT) * bits):
            fail(f"{precision} {method}: {flips} of {bits} residual bits "
                 f"differ")
        seeds_c, _ = twin._seeds(logits_c, None, SEEDS)
        rel_x = eng.replay(cnn.residuals_to(res_c, "cuda"), seeds_c.cuda())
        rerr = (rel_x.cpu().float() - rel_c.float()).abs().max().item()
        rref = rel_c.float().abs().max().item()
        if not rerr <= (0.0 if exact else rtol * rref):
            fail(f"{precision} {method}: cross-replay {rerr:.3e} "
                 f"(max|rel| {rref:.3e})")
        direct = (rel.cpu().float() - rel_c.float()).abs().max().item()
        if exact:
            back = twin.replay(cnn.residuals_to(res, "cpu"), seeds_c)
            if direct != 0.0 or not torch.equal(back, rel.cpu()):
                fail(f"fxp16 {method}: relevance or the CPU's replay of the "
                     f"card's residuals differs from the card's")
        agreement = None
        if precision == "bf16":
            # every example on the CPU's replay of the card's stored bits
            seeds, _ = eng._seeds(logits, None, SEEDS)
            back = twin.replay(cnn.residuals_to(res, "cpu"), seeds.cpu())
            berr = (rel.cpu().float() - back.float()).abs().max().item()
            if not berr <= BF16_TOL * back.float().abs().max().item():
                fail(f"bf16 {method}: relevance {berr:.3e} off the CPU's "
                     f"replay of the card's residuals")
            # the heatmaps against f32's, same model, same seeds (its
            # launches are a comparison's: not counted on the bf16 path)
            counted, counted_e = dict(LAUNCHES), dict(ENTRY_LAUNCHES)
            f32 = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                   method=method, targets=TopK(SEEDS)))
            _, res32 = f32.forward(x)
            rel32 = f32.replay(res32, seeds.float())
            torch.cuda.synchronize()
            LAUNCHES.update(counted)
            ENTRY_LAUNCHES.update(counted_e)
            agreement = _heatmap_agreement(rel, rel32)
            if agreement["spearman"][0] < 0.9:
                fail(f"bf16 {method}: heatmaps rank unlike f32's "
                     f"{agreement}")
            print(f"  bf16  {method:9s} vs f32 heatmaps (fidelity.compare, "
                  f"k 64, mean / least over {SEEDS}x{BATCH}): "
                  + "; ".join(f"{m} {a:.4f} / {b:.4f}"
                              for m, (a, b) in agreement.items()))

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
                               launches_per_explain=rose,
                               vs_f32_heatmaps=agreement)
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
# phase 9: the paper's accounting (Table II / §V, Table IV)
# ---------------------------------------------------------------------------

#: kernel launches of one saliency explain of the Table-III-literal config
#: in bf16 (no conv ReLU: the pools run alone, the one ReLU is FC0's)
PER_LITERAL_EXPLAIN = {"conv2d_fwd": 4, "maxpool_fwd": 2, "relu_fwd": 1,
                       "vmm_fwd": 2, "conv2d_bwd_fused": 4,
                       "vmm_bwd_fused": 2}
#: The paper's figures (§V, Table IV) printed beside the port's.
PAPER = "3.4 Mb autodiff vs 24.7 Kb packed (137x); FP+BP 50-72 % over FP"
TABLE_IV_BATCHES = (1, BATCH)


def _peak_bytes(fn):
    """Device memory ``fn()`` allocates at its peak beyond what was held
    before it (``max_memory_allocated``), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def check_paper_tables(params, cfg, x_cpu, launches, entry_launches,
                       to_profile):
    """Phase 9.  (a) Table II / §V: each config's Ledger (analytic bits per
    method, fp32 autodiff bits) against the bits of the residual tensors
    ``forward_with_residuals`` returns on the card, per example, for
    ``TABLE_III_LITERAL`` (the paper's 24.7 Kb) and ``FULL``: they must be
    equal.  (b) the bf16 explain of ``TABLE_III_LITERAL`` (counted from 0,
    per counter and per entry point: the pool alone in bf16) against its
    CPU twin, bf16 out.  (c) §V on the card: the
    bytes autograd saves for the backward of ``cnn.apply(method=
    "autodiff")`` (the software baseline, plain ops), and the peak device
    memory of a top-3 explain at batch 32 on the packed residuals against
    a ``backward="vjp"`` explain over that autodiff model.  (d) Table IV:
    FP (``Engine.forward``) against FP+BP (``Engine.explain``, the argmax
    class) device ms at batch 1 and 32 in f32, bf16 and fxp16; the f32
    FP+BP at both batches joins the profiles (its time by kernel)."""
    from repro_torch.configs import paper_cnn
    from repro_torch.core import residuals
    from repro_torch.engine import CNNModel, EngineSpec, FnModel, TopK, build
    from repro_torch.kernels import ENTRY_LAUNCHES, LAUNCHES, reset_launches
    from repro_torch.models import cnn

    x = x_cpu.cuda()
    out = {"paper": PAPER, "ledger": {}}
    # (a) the Ledger against the residual tensors
    for name in ("TABLE_III_LITERAL", "FULL"):
        c = getattr(paper_cnn, name)
        led = residuals.cnn_ledger(c)
        p = cnn.params_to(cnn.init(torch.Generator().manual_seed(0), c),
                          "cuda")
        row = dict(autodiff_bits=led.autodiff_bits(32))
        for method in METHODS:
            _, res = cnn.forward_with_residuals(p, x, c, method)
            got = residuals.residual_bits(res) / BATCH
            want = led.analytic_bits(method)
            if got != want:
                fail(f"{name} {method}: {got} residual bits an example, "
                     f"the Ledger says {want}")
            row[method] = dict(bits=want, reduction=led.reduction(method))
        out["ledger"][name] = row
        print(f"  {name}: autodiff {residuals.mb(row['autodiff_bits']):.3f} "
              f"Mb an example (fp32); packed residual tensors = Ledger: "
              + "; ".join(f"{m} {residuals.kb(row[m]['bits']):.3f} Kb "
                          f"({row[m]['reduction']:.1f}x)" for m in METHODS))
    print(f"  paper: {PAPER}")

    # (b) the literal config in bf16: its pools run alone
    lit = paper_cnn.TABLE_III_LITERAL
    lp = cnn.init(torch.Generator().manual_seed(0), lit)
    spec = dict(method="saliency", precision="bf16", targets=TopK(SEEDS))
    eng = build(EngineSpec(CNNModel(lp, lit, device="cuda"), **spec))
    twin = build(EngineSpec(CNNModel(lp, lit, device="cpu"), **spec))
    reset_launches()
    logits, rel, res = eng.predict_then_explain(x)
    torch.cuda.synchronize()
    launches["bf16_literal"] = dict(LAUNCHES)
    entry_launches["bf16_literal"] = dict(ENTRY_LAUNCHES)
    want = {k: 0 for k in LAUNCHES}
    want.update(PER_LITERAL_EXPLAIN)
    if launches["bf16_literal"] != want:
        fail(f"bf16 literal: launches {launches['bf16_literal']}, want "
             f"{want}")
    if entry_launches["bf16_literal"] != bf16_entries(want, ENTRY_LAUNCHES):
        fail(f"bf16 literal: launches per entry point "
             f"{ {k: v for k, v in ENTRY_LAUNCHES.items() if v} }, not "
             f"all through the bf16 entries")
    if not logits.dtype == rel.dtype == torch.bfloat16:
        fail(f"bf16 literal: logits {logits.dtype}, relevance {rel.dtype}, "
             f"want torch.bfloat16")
    logits_c, _, _ = twin.predict_then_explain(x_cpu)
    err = (logits.cpu().float() - logits_c.float()).abs().max().item()
    if not err <= BF16_TOL * logits_c.float().abs().max().item():
        fail(f"bf16 literal: logits card vs CPU {err:.3e}")
    seeds, _ = eng._seeds(logits, None, SEEDS)
    back = twin.replay(cnn.residuals_to(res, "cpu"), seeds.cpu())
    rerr = (rel.cpu().float() - back.float()).abs().max().item()
    if not rerr <= BF16_TOL * back.float().abs().max().item():
        fail(f"bf16 literal: relevance {rerr:.3e} off the CPU's replay")
    out["bf16_literal"] = dict(logits_err=err, rel_err=rerr)
    print(f"  bf16 TABLE_III_LITERAL saliency explain: logits err "
          f"{err:.2e}, relevance vs the CPU's replay of the card's bits "
          f"{rerr:.2e}")

    # (c) §V on the card: what autograd saves, and the peak memory
    pc = cnn.params_to(params, "cuda")

    def autodiff(method):
        return lambda v: cnn.apply(pc, v, cfg, method="autodiff")

    saved = {}

    def pack(t):
        saved[(t.data_ptr(), t.dtype, tuple(t.shape))] = (
            t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        autodiff("saliency")(x.clone().requires_grad_(True))
    weights = {t.data_ptr() for k in ("conv", "fc") for q in pc[k]
               for t in q.values()}
    saved_bytes = sum(v for (ptr, _, _), v in saved.items()
                      if ptr not in weights)
    _, res = cnn.forward_with_residuals(pc, x, cfg, "saliency")
    packed_bytes = residuals.residual_bits(res) // 8
    packed_eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                  method="saliency", targets=TopK(SEEDS)))
    vjp_eng = build(EngineSpec(FnModel(autodiff, device="cuda"),
                               backward="vjp", targets=TopK(SEEDS)))
    peak_packed = _peak_bytes(lambda: packed_eng.explain(x))
    peak_vjp = _peak_bytes(lambda: vjp_eng.explain(x))
    out["memory"] = dict(autograd_saved_bytes=saved_bytes,
                         packed_residual_bytes=packed_bytes,
                         peak_packed_explain_bytes=peak_packed,
                         peak_vjp_autodiff_explain_bytes=peak_vjp)
    print(f"  batch {BATCH}, FULL: autograd saves {saved_bytes} B of "
          f"activations for the backward (autodiff, plain ops, weights not "
          f"counted; {8 * saved_bytes / BATCH / 1e6:.3f} Mb an example), "
          f"the packed residuals are {packed_bytes} B "
          f"({8 * packed_bytes / BATCH / 1e3:.3f} Kb an example; "
          f"{saved_bytes / packed_bytes:.1f}x); peak device memory of a "
          f"top-{SEEDS} explain: packed {peak_packed} B, vjp over autodiff "
          f"{peak_vjp} B ({peak_vjp / peak_packed:.2f}x)")

    # (d) Table IV: FP against FP+BP
    out["table_iv"] = {}
    for precision in ("f32", "bf16", "fxp16"):
        eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                               method="saliency", precision=precision))
        for b in TABLE_IV_BATCHES:
            xb = x[:b].contiguous()
            fp = device_time_ms(lambda: eng.forward(xb))
            fpbp = device_time_ms(lambda: eng.explain(xb))
            out["table_iv"][f"{precision} b{b}"] = dict(
                fp_ms=fp, fp_bp_ms=fpbp, overhead=fpbp / fp - 1)
            if precision == "f32":
                to_profile.append((f"Table IV f32 FP+BP batch {b}",
                                   lambda eng=eng, xb=xb: eng.explain(xb),
                                   fpbp))
            print(f"  Table IV {precision:5s} batch {b:2d}: FP {fp:.4f} ms, "
                  f"FP+BP {fpbp:.4f} ms device (+{100 * (fpbp / fp - 1):.0f}"
                  f" %)")
    return out


# ---------------------------------------------------------------------------
# phases 5-6: the autograd paths
# ---------------------------------------------------------------------------

#: kernel launches per vjp explain with SEEDS seeds (one forward, then one
#: backward pass per seed), per branch; every other counter stays at 0
PER_EXPLAIN_VJP = {
    # (a) fused blocks: B5/B6 at S = 1 for dx, no weight gradient asked
    # for; ReLU and pool fused at the pooled layers
    "vjp_fused": {"conv2d_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
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
    per_explain = {"selective_scan": cfg.n_layers,
                   "selective_scan_bwd": cfg.n_layers}

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
    _expect(rose, {k: v * LM_NEW for k, v in per_explain.items()},
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
    _expect(rose, {k: 2 * v for k, v in per_explain.items()},
            "lm ixg explains")
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
        (_, cache), rose = _count(lambda: tf.prefill(
            params, cfg, {"tokens": res.tokens[:, :-1]}, cache), {})
    _expect(rose, {}, "lm prefill")
    last = res.tokens[:, -1:]

    def step():
        with torch.no_grad():
            tf.decode_step(params, cfg, last, cache, s_full - 1)

    contrastive = lm.make_token_explain(cfg, mode="contrastive")

    def token_explain():
        return contrastive(params, res.tokens, pos, res.tokens[:, pos + 1],
                           res.runners_up[:, t])

    # the same explain through the backward B13 had before its kernel
    route_err = _rel_err(token_explain(), _through_chunked_grad(
        token_explain))
    if not route_err <= LM_ROUTE_TOL:
        fail(f"lm: per-token scores through the B13 backward kernel vs "
             f"autograd over the chunked scan: {route_err:.3e} of max, "
             f"beyond {LM_ROUTE_TOL}")

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
          f"5 engine explains, {cfg.n_layers} B13 and {cfg.n_layers} B13 "
          f"bwd launches each and none in prefill or decode; causal zeros "
          f"exact; contrastive vs ixg difference "
          f"{lin_err:.2e}; scores through the B13 backward kernel vs "
          f"autograd over the chunked scan {route_err:.2e} of max; B13 vs "
          f"the chunked scan in each layer's "
          f"forward: max|dy| {max(layer_errs):.2e}; B13 vs chunked logits "
          f"{logit_err:.2e} of max (chunked vs f32 weights {chunk_err:.2e}; "
          f"argmax agrees on {same_argmax:.2f})")
    print(f"phase 7b (lm serve): an LMAdapter server on the same model, "
          f"max_batch {LM_BATCH}")
    serve = check_serve_lm(params, cfg, prompts)
    return dict(init_s=init_s, n_params=n_params, linearity_err=lin_err,
                route_err=route_err, serve=serve,
                layer_errs=layer_errs, logits_vs_chunked=logit_err,
                chunked_vs_f32=chunk_err, argmax_agree=same_argmax,
                times=times, engine=results,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _through_chunked_grad(fn):
    """``fn()`` with the scan's backward swapped for autograd over the
    chunked scan (:class:`_ChunkedGradScan`), for comparison only."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    real = scan_ops.selective_scan
    scan_ops.selective_scan = _chunked_grad_scan
    try:
        return fn()
    finally:
        scan_ops.selective_scan = real


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
    per_explain = {"selective_scan": cfg.n_layers,
                   "selective_scan_bwd": cfg.n_layers}
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
        _expect(rose, per_explain, what)
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
            _expect(rose, per_explain, f"{what} exact")
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
# phases 7b and 10: the explanation server (repro_torch.serve)
# ---------------------------------------------------------------------------

#: Phase 10: the server's batch, the example pool, the composites' fan-out
#: and the timed replay's trace length.
SERVE_BATCH, SERVE_POOL = 32, 160
SERVE_IG_STEPS, SERVE_SG_N, SERVE_REPLAY_N = 16, 8, 2000
#: kernel launches per predict batch, per hit batch (the BP phase over the
#: stored bits alone) and per cold BP batch (both), f32 Table III
PER_PREDICT_BATCH = {"conv2d_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
                     "vmm_fwd": 2}
PER_HIT_BATCH = {"conv2d_bwd_fused": 4, "vmm_bwd_fused": 2}
PER_COLD_BATCH = dict(PER_PREDICT_BATCH, **PER_HIT_BATCH)
#: the forward's counters: a hit batch must launch none of them
FORWARD_KERNELS = ("conv2d_fwd", "relu_fwd", "relu_pool_fwd", "vmm_fwd",
                   "maxpool_fwd", "conv2d_fxp_fwd", "vmm_fxp_fwd")
#: phase 7b: falcon-mamba-7b served in batches of LM_BATCH prompts
LM_SERVE_MODES = (("token_ixg", "ixg"), ("token_contrastive", "contrastive"))


def _burst(srv, reqs):
    """Submit every request, then drain: one padded batch per bucket (at
    most SERVE_BATCH rows), every dispatch ending in a synchronise."""
    for r in reqs:
        srv.submit(r)
    out = srv.drain()
    bad = [(r.uid, r.error_type, r.error) for r in out if not r.ok]
    if bad:
        fail(f"serve: error responses {bad[:3]}")
    return out


def _counted_burst(srv, reqs, want, batches, what):
    """:func:`_burst` with the counters set to 0: ``want`` launches a batch
    times the ``batches`` it must make, every other counter 0."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    before = srv.stats.batches
    out = _burst(srv, reqs)
    torch.cuda.synchronize()
    rose = dict(LAUNCHES)
    made = srv.stats.batches - before
    if made != batches:
        fail(f"serve {what}: {made} batches, want {batches}")
    _expect(rose, {k: v * batches for k, v in want.items()},
            f"serve {what}")
    return out, rose


def _twin_close(card, twin, resp, tresp, method):
    """A pure-BP response on the card against the CPU twin's: logits
    within DOT_TOL, relevance within REPLAY_TOL of max, or, where the two
    devices stored different bits for the example, against the CPU's
    replay of the card's bits.  Returns True when the bits differed."""
    from repro_torch.models import cnn
    if resp.targets != tresp.targets:
        fail(f"serve {resp.uid}: targets {resp.targets} on the card, "
             f"{tresp.targets} on the CPU")
    err = _rel_err(resp.logits.cpu(), tresp.logits)
    if not err <= DOT_TOL:
        fail(f"serve {resp.uid}: logits card vs CPU {err:.3e} of max")
    ce, te = card.cache.peek(resp.uid), twin.cache.peek(tresp.uid)
    pairs = [t for pair in zip(ce.residuals["conv"], te.residuals["conv"])
             for t in zip(*pair)] + list(zip(ce.residuals["fc"],
                                             te.residuals["fc"]))
    flipped = any(a is not None and not torch.equal(a.cpu(), b)
                  for a, b in pairs)
    want = tresp.relevance
    if flipped:
        seeds = F.one_hot(torch.tensor(resp.targets), 10).float()[:, None]
        want = twin.adapter.engine_for(method).replay(
            cnn.residuals_to(ce.residuals, "cpu"), seeds)[:, 0]
        want = want if resp.relevance.dim() == 4 else want[0]
    rerr = _rel_err(resp.relevance.cpu(), want)
    if not rerr <= REPLAY_TOL:
        fail(f"serve {resp.uid} {method}: relevance card vs CPU "
             f"{rerr:.3e} of max (bits differ: {flipped})")
    return flipped


def check_serve_cnn(params, cfg, launches, smi):
    """Phase 10: ``ExplanationServer(CNNAdapter.from_engine(eng),
    max_batch=32)`` on the card, f32, full Table III width, a CPU twin
    server on the same parameters and requests."""
    from repro_torch.core.residuals import cnn_ledger
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.serve import (AdmissionConfig, CNNAdapter,
                                   DegradePolicy, ExplanationServer,
                                   Request)
    from repro_torch.serve.adapters import concat_examples, slice_example
    from repro_torch.serve.batcher import pad_size, stack_padded
    from repro_torch.serve.replay import (TimedAdapter, VirtualClock,
                                          replay, synthesize)
    from repro_torch.serve.residual_cache import owned_bytes

    pool = torch.randn((SERVE_POOL, 32, 32, 3),
                       generator=torch.Generator().manual_seed(2)).numpy()
    opts = {"integrated_gradients": {"steps": SERVE_IG_STEPS},
            "smoothgrad": {"n": SERVE_SG_N}}

    def make(device, **kw):
        eng = build(EngineSpec(CNNModel(params, cfg, device=device)))
        return ExplanationServer(CNNAdapter.from_engine(eng),
                                 max_batch=SERVE_BATCH, max_delay_s=60.0,
                                 cache_capacity=1024, method_opts=opts,
                                 **kw)

    card, twin = make("cuda"), make("cpu")
    totals = launches.setdefault("serve_cnn", {})

    def both(reqs_fn, want, batches, what):
        out, rose = _counted_burst(card, reqs_fn(), want, batches, what)
        for k, v in rose.items():
            totals[k] = totals.get(k, 0) + v
        return out, _burst(twin, reqs_fn())

    def reqs(uids, ix, **kw):
        return lambda: [Request(uid=u, x=pool[i], **kw)
                        for u, i in zip(uids, ix)]

    # 64 predicts: two batches of 32
    pu = [f"p{i}" for i in range(64)]
    both(reqs(pu, range(64), kind="predict"), PER_PREDICT_BATCH, 2,
         "predict")
    # explains of the same uids: every one a hit, one batch a group
    groups = [("saliency", range(0, 16), {}), ("guided", range(16, 32), {}),
              ("deconvnet", range(32, 40), {}),
              ("saliency", range(40, 56), {"topk": SEEDS}),
              ("guided", range(56, 64), {"target": True})]
    # then 32 cold explains of new uids (one cold BP batch), and their
    # follow-ups (hits, top-3 panels)
    cu = [f"c{i}" for i in range(32)]
    n_hit = n_cold = flips = 0
    checked = []
    for method, ix, kw in groups + [("saliency", None, {}),
                                    ("guided", None, {"topk": SEEDS})]:
        cold = ix is None and method == "saliency"
        uids = cu if ix is None else [pu[i] for i in ix]
        xi = range(64, 96) if ix is None else ix
        tgt = [i % 10 for i in xi] if kw.get("target") else None

        def fn(uids=uids, xi=xi, tgt=tgt, method=method, kw=kw):
            return [Request(uid=u, kind="explain", x=pool[i], method=method,
                            topk=kw.get("topk"),
                            target=None if tgt is None else tgt[j])
                    for j, (u, i) in enumerate(zip(uids, xi))]
        out, tout = both(fn, PER_COLD_BATCH if cold else PER_HIT_BATCH, 1,
                         f"{'cold' if cold else 'hit'} {method} {kw}")
        if any(r.cache_hit == cold for r in out):
            fail(f"serve {method} {kw}: cache hits {[r.cache_hit for r in out]}")
        n_cold += cold
        n_hit += not cold
        # every response bitwise the engine's explain of the same padded
        # batch (a hit skipped the forward and changed no bit)
        n = len(out)
        xb = stack_padded([pool[i] for i in xi], pad_size(n, SERVE_BATCH))
        t = None if tgt is None else torch.tensor(tgt + [0] * (len(xb) - n))
        _, rel = card.adapter.engine_for(method).explain(
            xb, target=t, topk=kw.get("topk"))
        for i, (r, tr) in enumerate(zip(out, tout)):
            ref = rel[:, i] if kw.get("topk") else rel[i]
            if not torch.equal(r.relevance, ref):
                fail(f"serve {r.uid} {method}: response differs from the "
                     f"engine's explain of the same padded batch")
            flips += _twin_close(card, twin, r, tr, method)
        checked += out

    # 8 integrated gradients and 8 smoothgrad (per-request seeds)
    gu = [f"g{i}" for i in range(8)]
    ig = _burst(card, reqs(gu, range(96, 104), kind="explain",
                           method="integrated_gradients")())
    eng = card.adapter.engine_for("saliency")
    _, ig_ref = eng.ig(stack_padded([pool[i] for i in range(96, 104)], 8),
                       steps=SERVE_IG_STEPS)
    for i, r in enumerate(ig):
        _finite(r.relevance, "serve ig", (32, 32, 3))
        if r.cache_hit or not torch.equal(r.relevance, ig_ref[i]):
            fail(f"serve {r.uid}: IG differs from the engine's on the "
                 f"same batch")
    su = [f"s{i}" for i in range(8)]

    def sg(uids):
        return [Request(uid=u, kind="explain", x=pool[104 + int(u[1:])],
                        method="smoothgrad", key=1000 + int(u[1:]))
                for u in uids]
    cobatched = _burst(card, sg(su))
    if {r.batch_size for r in cobatched} != {8}:
        fail("serve smoothgrad: not co-batched")
    for r in cobatched:
        (single,) = _burst(card, sg([r.uid]))
        if single.batch_size != 1 or not torch.equal(single.relevance,
                                                     r.relevance):
            fail(f"serve {r.uid}: co-batched smoothgrad differs from the "
                 f"singleton request")
        _finite(r.relevance, "serve smoothgrad", (32, 32, 3))

    # the cache: entries x the Ledger's bits an example, owned bytes
    per_ex = cnn_ledger(cfg).analytic_bits("saliency")
    bits = card.cache.stats.bits_stored
    if not bits == len(card.cache) * per_ex == 8 * owned_bytes(card.cache):
        fail(f"serve cache: {bits} bits stored, {len(card.cache)} entries x "
             f"{per_ex}, {8 * owned_bytes(card.cache)} bits owned")
    n_entries = len(card.cache)
    print(f"  cnn: 64 predicts, {len(checked)} pure-BP explains in "
          f"{n_hit} hit batches ({PER_HIT_BATCH} a batch, no forward "
          f"kernel) and {n_cold} cold BP batch(es) ({PER_COLD_BATCH}); "
          f"every response bitwise the engine's explain of its padded "
          f"batch; vs the CPU twin within {DOT_TOL:g} / {REPLAY_TOL:g} of "
          f"max ({flips} examples replayed on the card's bits); 8 IG "
          f"(steps {SERVE_IG_STEPS}) bitwise Engine.ig, 8 smoothgrad (n "
          f"{SERVE_SG_N}) co-batched == singleton bitwise; cache "
          f"{len(card.cache)} entries x {per_ex} bits = {bits} bits = the "
          f"bytes its tensors own")

    # fxp16: a server under pressure reroutes to the int16 sibling
    adm = AdmissionConfig(capacity=16, degrade=DegradePolicy(
        pressure_threshold=0.5, reroute_precision="fxp16"))
    dcard, dtwin = make("cuda", admission=adm), make("cpu", admission=adm)
    du, dix = [f"d{i}" for i in range(16)], range(112, 128)
    dreq = reqs(du, dix, kind="explain", method="saliency")
    out, tout = _burst(dcard, dreq()), _burst(dtwin, dreq())
    rerouted = [r for r in out if r.meta.get("degraded")]
    if [r.uid for r in rerouted] != du[8:] or any(
            r.meta["degraded"] != "reroute_precision" for r in rerouted):
        fail(f"serve fxp16: rerouted {[r.uid for r in rerouted]}")
    fxp = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                           precision="fxp16"))
    logits, rel = fxp.explain(stack_padded([pool[i] for i in dix[8:]], 8))
    trer = {r.uid: r for r in tout}
    for i, r in enumerate(rerouted):
        tr = trer[r.uid]
        if not (torch.equal(r.relevance, rel[i])
                and torch.equal(r.logits, logits[i])
                and torch.equal(r.relevance.cpu(), tr.relevance)
                and torch.equal(r.logits.cpu(), tr.logits)):
            fail(f"serve {r.uid}: the fxp16 reroute differs from the fxp16 "
                 f"engine or the CPU twin")
        if dcard.cache.peek(r.uid) is not None:
            fail(f"serve {r.uid}: a rerouted request warmed the cache")
    print(f"  cnn fxp16 reroute: {len(rerouted)} of 16 explains rerouted "
          f"under pressure (meta degraded), bitwise the card's fxp16 engine "
          f"and the CPU twin")

    # host against device: the server's own time per 32-row batch
    eng_c = card.adapter
    xb = torch.from_numpy(pool[:SERVE_BATCH]).cuda()
    entries = [card.cache.peek(f"p{i}") for i in range(SERVE_BATCH)]
    res32 = concat_examples([e.residuals for e in entries])
    seeds = F.one_hot(torch.tensor([int(e.host_logits.argmax())
                                    for e in entries]), 10).float()[None]
    seeds = seeds.cuda()
    seq = iter(range(10 ** 6))

    def fresh(kind, method=None):
        k = next(seq)
        return [Request(uid=f"t{k}_{j}", kind=kind, x=pool[j],
                        method=method or "saliency")
                for j in range(SERVE_BATCH)]

    rows = {
        "predict batch": (lambda: _burst(card, fresh("predict")),
                          lambda: eng_c.predict(xb)),
        "hit batch": (lambda: _burst(card, [
            Request(uid=f"p{j}", kind="explain", x=pool[j],
                    method="saliency") for j in range(SERVE_BATCH)]),
                      lambda: eng_c.explain_cached("saliency", res32,
                                                   seeds)),
        "cold BP batch": (lambda: _burst(card, fresh("explain")),
                          lambda: eng_c.explain_cached(
                              "saliency", eng_c.predict(xb)[1], seeds)),
    }
    times = {}
    for what, (served, device_fn) in rows.items():
        host = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served()
            host.append(1e3 * (time.perf_counter() - t0))
        dev = device_time_ms(device_fn, reps=10)
        h = statistics.median(host[2:])
        times[what] = dict(host_ms=h, device_ms=dev)
        print(f"  cnn {what} (32 rows): {h:.3f} ms host through the server "
              f"(submit to responses), {dev:.4f} ms device for its kernels "
              f"({smi})")
    _, res = eng_c.predict(xb)
    fill = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [slice_example(res, i) for i in range(SERVE_BATCH)]
        torch.cuda.synchronize()
        fill.append(1e3 * (time.perf_counter() - t0))
    times["cache fill"] = dict(host_ms=statistics.median(fill[2:]))
    print(f"  cnn: filling the cache from a 32-row predict batch (a copy "
          f"per tensor per example) {times['cache fill']['host_ms']:.3f} ms "
          f"host")

    # timed replays (TimedAdapter: the clock advances by service time)
    reports = {}
    for name, admission in (
            ("no admission", None),
            ("admission", AdmissionConfig(
                capacity=256, default_deadline_s=0.05,
                degrade=DegradePolicy(reroute_precision="fxp16")))):
        clock = VirtualClock()
        eng = build(EngineSpec(CNNModel(params, cfg, device="cuda")))
        srv = ExplanationServer(TimedAdapter(CNNAdapter.from_engine(eng),
                                             clock),
                                clock=clock, max_batch=SERVE_BATCH,
                                max_delay_s=0.002, admission=admission)
        t0 = time.perf_counter()
        rep = replay(srv, synthesize(SERVE_REPLAY_N, seed=0),
                     example_shape=(32, 32, 3))
        wall = time.perf_counter() - t0
        snap = rep.snapshot()
        if rep.errors:
            fail(f"serve replay ({name}): {rep.errors} error responses")
        if rep.completed + rep.shed_total != rep.offered:
            fail(f"serve replay ({name}): responses do not add up {snap}")
        reports[name] = dict(snap, wall_s=wall)
        print(f"  cnn timed replay ({name}): {SERVE_REPLAY_N} requests, "
              f"poisson 2000/s, DEFAULT_MIX; p50/p99 us predict "
              f"{snap.get('predict_p50_us')}/{snap.get('predict_p99_us')}, "
              f"explain {snap.get('explain_p50_us')}/"
              f"{snap.get('explain_p99_us')}; sheds {snap['sheds_by_reason']}"
              f", degrades {snap['degrades']}, hit rate "
              f"{snap['cache_hit_rate']:.4f}, occupancy "
              f"{snap['mean_occupancy']:.4f}, makespan {snap['makespan_s']:.4f}"
              f" s virtual, {wall:.2f} s wall")
    check_path_launches("serve_cnn", totals)
    return dict(times=times, replays=reports, twin_flips=flips,
                hit_batches=n_hit, cold_batches=n_cold,
                cache_bits=bits, cache_entries=n_entries,
                launches_per_batch=dict(predict=PER_PREDICT_BATCH,
                                        hit=PER_HIT_BATCH,
                                        cold=PER_COLD_BATCH),
                launches=totals)


def check_serve_lm(params, cfg, prompts):
    """Phase 7b: an ``LMAdapter`` server (``max_batch`` = LM_BATCH) on
    phase 7's falcon-mamba-7b: predicts bitwise the last-position logits
    of ``forward``, ``token_ixg`` and ``token_contrastive`` responses
    bitwise ``Engine.explain_tokens`` on the same padded batch, 64 B13 and
    64 B13 bwd launches an explain batch and none in predict."""
    from repro_torch import lm
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ExplanationServer, Request
    from repro_torch.serve.batcher import stack_padded

    eng = build(EngineSpec(LMModel(params, cfg)))
    srv = ExplanationServer(lm.LMAdapter.from_engine(eng),
                            max_batch=LM_BATCH, max_delay_s=60.0)
    toks = prompts.cpu().numpy()
    per_batch = {"selective_scan": cfg.n_layers,
                 "selective_scan_bwd": cfg.n_layers}
    out, _ = _counted_burst(srv, [Request(uid=f"l{i}", kind="predict",
                                          x=toks[i])
                                  for i in range(LM_BATCH)], {}, 1,
                            "lm predict")
    with torch.no_grad():
        want = tf.forward(params, cfg, {"tokens": prompts})[0][:, -1]
    if not all(torch.equal(r.logits, want[i]) for i, r in enumerate(out)):
        fail("serve lm: predict differs from forward's last-position logits")
    xb = stack_padded(list(toks), LM_BATCH)
    results = {}
    for method, mode in LM_SERVE_MODES:
        def reqs(method=method):
            return [Request(uid=f"l{i}", kind="explain", x=toks[i],
                            method=method) for i in range(LM_BATCH)]
        out, rose = _counted_burst(srv, reqs(), per_batch, 1,
                                   f"lm {method}")
        lg, sc = eng.explain_tokens({"tokens": xb}, mode=mode)
        for i, r in enumerate(out):
            if not (torch.equal(r.relevance, sc[i])
                    and torch.equal(r.logits, lg[i])):
                fail(f"serve lm {r.uid} {method}: differs from "
                     f"explain_tokens on the same batch")
            _finite(r.relevance, f"serve lm {method}", (LM_PROMPT,))
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _burst(srv, reqs())
            host.append(1e3 * (time.perf_counter() - t0))
        dev = _span_ms(lambda mode=mode: eng.explain_tokens(
            {"tokens": xb}, mode=mode), reps=3)
        rose = {k: v for k, v in rose.items() if v}
        results[method] = dict(host_ms=statistics.median(host),
                               device_ms=dev, launches=rose)
        print(f"  lm served {method}: {LM_BATCH} x {LM_PROMPT} tokens a "
              f"batch, bitwise explain_tokens, {rose}; "
              f"{statistics.median(host):.2f} ms host through the server, "
              f"{dev:.2f} ms device span")
    return results


# ---------------------------------------------------------------------------


#: The counters each path must launch; the others must stay at 0 there.
PATH_KERNELS = {"f32": tuple(PER_EXPLAIN["f32"]),
                "bf16": tuple(PER_EXPLAIN["bf16"]),
                "bf16_literal": tuple(PER_LITERAL_EXPLAIN),
                "fxp16": tuple(PER_EXPLAIN["fxp16"]),
                "vjp_fused": tuple(PER_EXPLAIN_VJP["vjp_fused"]),
                "vjp_unfused": tuple(PER_EXPLAIN_VJP["vjp_unfused"]),
                "train": tuple(PER_TRAIN_STEP),
                "lm": ("selective_scan", "selective_scan_bwd"),
                "lm_twin": ("selective_scan", "selective_scan_bwd"),
                "serve_cnn": tuple(PER_COLD_BATCH)}
#: The path whose launches the kernel JSON reports for each kernel: the
#: first that runs it (the bf16 paths report the bf16 instances).
KERNEL_PATH = {k: next(p for p in PATH_KERNELS if k in PATH_KERNELS[p]
                       and not p.startswith("bf16"))
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
                    help="after phase 1, time the launch choices of B1, B4, "
                         "B1/B4/B5/B6 bf16, B5/B8, B7, B9 and B6/B10 (K "
                         "splits, clusters, grids of tile plans) and stop; "
                         "--out gets kernel_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import (ENTRY_LAUNCHES, LAUNCHES, _build,
                                     reset_launches)
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
        found = kernel_resources(text, REDESIGNED)
        print("  redesigned B1/B2/B3/B4/B5/B6/B7/B8/B9/B10/B13 kernels, "
              "B1/B4/B5/B6 bf16 on the tensor cores (ptxas): "
              + "; ".join(f"{name} {regs} registers, spill stores {st} B, "
                          f"loads {ld} B" for name, regs, st, ld in found))

    if args.sweep:
        print(f"sweep: B4 K splits and B1 tile plans (ms = median of {REPS} "
              f"back-to-back runs)")
        rows = sweep_launch_choices(torch.Generator(device="cuda")
                                    .manual_seed(0))
        print(f"sweep: fused conv backward tile plans (ms = median of "
              f"{SWEEP_BWD_REPS} back-to-back runs)")
        rows["bwd"] = sweep_bwd_plans(torch.Generator(device="cuda")
                                      .manual_seed(0))
        print(f"sweep: B1 and B4 in bf16, tensor-core tiles and clusters "
              f"beside F.conv2d / torch.addmm bf16 and the FFMA route (ms = "
              f"median of {REPS} back-to-back runs)")
        rows.update(sweep_bf16_choices(torch.Generator(device="cuda")
                                       .manual_seed(0)))
        print(f"sweep: B5 and B6 in bf16, tensor-core tiles beside the FFMA "
              f"route (ms = median of {SWEEP_BWD_REPS} back-to-back runs)")
        rows.update(sweep_bf16_bwd_choices(torch.Generator(device="cuda")
                                           .manual_seed(0)))
        print(f"sweep: B7 tile plans and B9 K splits, int16 (ms = median "
              f"of {REPS} back-to-back runs)")
        rows.update(sweep_fxp_choices(torch.Generator(device="cuda")
                                      .manual_seed(0)))
        print(f"sweep: fused FC backward tile plans, f32 and int16 (ms = "
              f"median of {SWEEP_BWD_REPS} back-to-back runs)")
        rows["vmm_bwd"] = sweep_vmm_bwd_plans(torch.Generator(device="cuda")
                                              .manual_seed(0))
        print(f"sweep: ReLU / pool template block sizes, f32 and int16 (ms "
              f"a launch: median of {REPS} between events, {REPS} back to "
              f"back, CUPTI)")
        rows["relu_pool"] = sweep_relu_pool(torch.Generator(device="cuda")
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
    check_kernels_bf16(kc)
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
    entry_launches, route_launches = {}, {}
    for precision in ("f32", "bf16", "fxp16"):
        reset_launches()
        print(f"phase 3 ({precision}): engine end to end, full Table III "
              f"width")
        engine_results[precision] = check_engine(params, cfg, x_cpu,
                                                 precision, to_profile)
        print(f"phase 4 ({precision}): requests")
        n_req[precision] = serve_requests(params, cfg, x_cpu, precision)
        torch.cuda.synchronize()
        launches[precision] = dict(LAUNCHES)
        entry_launches[precision] = dict(ENTRY_LAUNCHES)
        route_launches[precision] = dict(_build.ROUTE_LAUNCHES)
        check_path_launches(precision, launches[precision])
        if precision == "bf16" and entry_launches["bf16"] != bf16_entries(
                launches["bf16"], ENTRY_LAUNCHES):
            fail(f"bf16: launches per entry point "
                 f"{ {k: v for k, v in ENTRY_LAUNCHES.items() if v} }, not "
                 f"all through the bf16 entries")
        if precision == "bf16":
            # layers 1-3 on the tensor cores, layer 0 on FFMA, in every
            # conv forward of the path; every backward on the tensor cores
            check_bf16_routes("bf16 path", route_launches["bf16"],
                              launches["bf16"])
            print(f"  bf16 launches by kernel: {route_launches['bf16']}")

    # the paper's accounting (Table II / §V, Table IV), and the bf16
    # explain of the Table-III-literal config (the pool alone in bf16),
    # counted from 0
    print("phase 9 (paper tables): residual bits and the Ledger, peak "
          "memory packed vs autodiff, FP vs FP+BP (Table IV)")
    tables = check_paper_tables(params, cfg, x_cpu, launches, entry_launches,
                                to_profile)
    check_path_launches("bf16_literal", launches["bf16_literal"])

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
    torch.cuda.empty_cache()
    print(f"phase 10 (serve): ExplanationServer on the card, full Table III "
          f"width, f32, max_batch {SERVE_BATCH}, against a CPU twin server; "
          f"fxp16 reroute; timed replays")
    serve_results = check_serve_cnn(params, cfg, launches, smi)

    # last, as a profiler session slows what runs after it: phase 2's
    # profiler column (the process's first session), then where each
    # path's time goes
    print(f"profiler column of phase 2: each row's kernel (and general "
          f"route) {REPS} times under one torch.profiler session, CUPTI ms "
          f"a call")
    kc.profile()
    kc.summary()
    print("profiles: one saliency explain per CNN path, Table IV's f32 "
          "FP+BP at batch 1 and 32, one training step, one LM decode step "
          "and one per-token LM explain under torch.profiler")
    profiles = {what: profile_breakdown(fn, what, wall)
                for what, fn, wall in to_profile}
    bf16_explain = "bf16 saliency explain"
    check_bf16_kernel_names(profiles[bf16_explain], lambda: next(
        profile_breakdown(fn, what, wall) for what, fn, wall in to_profile
        if what == bf16_explain))

    kernels = []
    rows = [(name, launches[KERNEL_PATH[name]][name], source, replaces)
            for name, (source, replaces) in KERNELS.items()]
    rows += [(name, route_launches["bf16"][BF16_ROUTES[name]]
              if name in BF16_ROUTES else entry_launches[
                  "bf16_literal" if counter == "maxpool_fwd" else "bf16"][
                  entry])
             + (BF16_SOURCES.get(name, KERNELS[counter][0]),
                KERNELS[counter][1])
             for name, (counter, entry) in BF16_INSTANCES.items()]
    for name, n_launched, source, replaces in rows:
        s = kc.sums[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=n_launched,
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
            paper_tables=tables,
            vjp=vjp_results, train=train_results, lm=lm_results,
            lm_twin=twin_results, serve=serve_results,
            scan_backward_ms=kc.scan_backward_ms,
            mma_accumulation=kc.accumulation,
            scan_backward_loop_ms=kc.scan_backward_loop_ms,
            profiles=profiles,
            launches=launches, entry_launches=entry_launches,
            route_launches=route_launches,
            kernels=kernels), indent=1))
    print(smi)
    print(json.dumps({"serve": {
        "cnn": dict(launches=serve_results["launches"],
                    per_batch=serve_results["launches_per_batch"],
                    hit_batches=serve_results["hit_batches"],
                    cold_batches=serve_results["cold_batches"]),
        "lm": {m: r["launches"] for m, r in lm_results["serve"].items()}}}))
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
