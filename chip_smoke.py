#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
card: build every kernel, hold each against its plain PyTorch version at
the shapes its path gives it, then explain full-width batches of the Table
III CNN through the engine, in f32, in bf16 and in the paper's true-int16
fixed point (fxp16), state the paper's own accounting (Table II / §V,
Table IV), then explain through autograd (the vjp backend), train a few
steps, explain each generated token of falcon-mamba-7b at full width
and depth and serve it, serve the CNN through the explanation server
(``repro_torch.serve``), explain it by perturbation (occlusion, LIME,
RISE: ``Engine.perturb``'s fold of N x 32 rows, and one of 67,200 rows),
plan its kernels with the tile planner's ``h100`` profile (analytic and
autotuned), and check them against the CPU.

    python3 chip_smoke.py                  # one card; exits 0 when all pass
    python3 chip_smoke.py --out DIR        # also writes DIR/chip_smoke.json
    python3 chip_smoke.py --sweep [--out DIR]
    python3 chip_smoke.py --multi-device [--out DIR]

``--sweep`` runs phase 1, then times the launch choices of B4 (every K
split) and B1 (the tile plans of ``conv_candidates``, all bitwise equal;
B5 / B8: ``conv_bwd_candidates``; the autotuner measures from the same
enumerators) beside the library
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
   bf16; B5 bf16 and B6 bf16 also at the vjp path's S = 1, seed 0 alone:
   within that bound of the plain version, bitwise again and under a
   second tile, and compared with seed 0 of the S = 3 launch, bitwise
   where each output sums in one order whatever S is, else held within
   one bf16 step and the launch named), then the fxp16
   kernels B7-B10 and
   the int16 instances of B2/B3 and of their fused pass, all bitwise (B7, B8 and B10 also launched
   again, under a second plan and on their general kernels, timed beside
   them; B9 again and under a second K split), plus accumulators that wrap
   at ±32767 operands (B9's under several splits, B10's under three
   plans); then the gate (B11, three methods, f32 and bf16) and unpool
   (B12, f32, bf16 and int16) kernels of the autograd paths, bitwise (bf16
   compared as its 16 bits, -0.0 gradients included); then the selective
   scan (B13) at falcon-mamba-7b's explain shape (B = 4, S = 72, D = 8192, N = 16; x bf16 and f32) and a ragged
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
   on every example; the launches of each branch per explain; then both
   branches in bf16 (``precision="bf16"``): bf16 logits and f32
   relevance, within BF16_TOL * max of the bf16 seed-batched card engine
   (the fused branch bitwise or not, printed), of the CPU twin on the
   agreeing examples and of the CPU's replay of the card's bits, every
   launch through a bf16 entry point, by kernel as the routes say; host
   and device ms per explain;
6. train: three AdamW steps of ``cnn.apply(p, x, cfg, use_pallas=True)``
   (autodiff, cross-entropy, batch 32), each step's parameter gradients
   within 1e-4 * max|g| of a CPU twin's on the same parameters (over the
   examples whose ReLU signs and pool argmax the two devices agree on),
   then one step through ``cnn.apply(..., precision="bf16")`` (the bf16
   entries; f32 gradients) within BF16_TOL * max|g| of its CPU twin's;
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
   autodiff model against the packed residuals; what it saves for a bf16
   saliency vjp explain on the fused blocks (the bf16 weights and exactly
   the packed mask and crumb bytes, no other tensor); the peak device memory
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

11. perturb (after phase 10): ``Engine.perturb`` at full Table III width,
   batch 32, per-example seeds: occlusion (window 4, stride 2: N = 225),
   LIME and RISE (N = 256), each in f32, bf16 and fxp16; a batched
   explain launches exactly 8 conv, 4 mask-free fused ReLU + pool and 4 FC
   kernels (the base forward and the fold of N x 32 rows; no ReLU mask, no
   backward kernel); the fold against the sequential path (one 32-row
   forward a mask: fxp16 bitwise; f32 logits and heat within DOT_TOL
   (LIME REPLAY_TOL), bf16 BF16_TOL, of max|logits|, as the FC forward
   sums in another order at N x 32 rows); a CPU twin on 2 rows with the card's masks (logits and per-mask
   scores: fxp16 bitwise, f32 DOT_TOL, bf16 BF16_TOL; the heatmap against
   the CPU's aggregation of the card's fold outputs); host and device ms
   of the batched and the sequential explain, peak device memory; one RISE
   fold of 2,100 x 32 = 67,200 rows (more images than ``gridDim.z``
   holds), finite, its logits within DOT_TOL of the same rows run in
   65,535-row slices; 24 served perturbation requests in batches of 8,
   never a cache hit (nor a counted miss), no backward kernel, each
   bitwise ``Engine.perturb`` of its batch; then ``obs.profile``'s
   KernelProfiler over one f32 top-3 explain and one f32 RISE explain, its
   fenced ms per family printed at the end beside CUPTI's kernel ms of the
   same calls.

12. plan (after phase 11): the tile planner (``repro_torch.plan``) with
   the card's ``h100`` profile (SM count and shared memory read from the
   card, rates from its data sheet; ``detected`` resolves to it), at full
   Table III width, batch 32, top-3, in f32, bf16 and fxp16: the analytic
   ``plan_cnn`` equal to the kernels' launch rules entry for entry; an
   ``EngineSpec(device="h100")`` engine's explain bitwise the unplanned
   one's, launching the same kernels; an ``autotune=True`` build on a fresh
   tuning cache under ``--out`` (the rule's plan and the three
   best-ranked other candidates of each launch timed by CUDA events), each
   entry's rule and chosen microseconds and the build's seconds printed,
   its explain held to the unplanned one (fxp16 bitwise, f32 within
   DOT_TOL / REPLAY_TOL, bf16 BF16_TOL of max) with the same launches
   (counted as path ``plan_<precision>``); a warm build a 100 % cache hit
   with no measurement, and ``python -m repro_torch.plan --device h100
   --autotune`` then ``--expect-full-hit`` exiting 0; device ms of the
   unplanned, analytic and autotuned explain (interleaved, beside a second
   unplanned engine on its own copy of the weights) and host ms; ``plan_lm`` on
   phase 7's falcon-mamba-7b FULL (autotuned over the scan's ScanTiles, one
   per launch they make) and per-token explains under the analytic, the
   autotuned and four more ScanTiles against the unplanned one (within
   LM_ROUTE_TOL of max, bitwise reported; the analytic plan bitwise), 64
   B13 and 64 B13 bwd launches each; ``device="edge-tiny"``: a half-width
   CNN's RISE fold of 256 x 32 rows raises ``InfeasiblePlanError`` before
   any launch, and the Table III widths raise at build; the served CNN's
   ``--profile-kernels`` drift table (every row measured on the card: est,
   measured, drift), read back by ``python -m repro_torch.obs drift``.

13. lm zoo (after phase 12): the other nine configs of the zoo at their
   published widths in bf16, random weights from
   ``torch.Generator(device="cuda").manual_seed(0)``, full depth but for
   internlm2-20b (16 of 48 layers), moonshot-v1-16b-a3b (12 of 48: the
   dense layer and 11 MoE) and llama4-scout-17b-a16e (2 of 48), each cut
   printed (``ZOO_DEPTH``: weights at most 16 GB); per config 4 prompts x
   64 tokens (llava: the 576 patch embeddings on the engine explain;
   seamless: 64 frame embeddings on every explain): greedy ``decode`` of
   8 tokens twice, equal; contrastive ``explain_generated`` (scores after
   each seed exactly 0, all finite), contrastive = ixg(a) - ixg(b) within
   REPLAY_TOL on the same weights in f32 (the bf16 figure printed: in bf16
   it measures rounding, ``_zoo_f32_checks``), an engine explain; host
   and device-span ms of a decode step, a per-token explain and the
   engine explain.  hymba-1.5b,
   the slice's main path (counted as path ``lm_zoo``): 32 B13 and 32 B13
   bwd launches an explain and none in prefill or decode, each layer's
   B13 against the chunked scan and, in a per-token explain, each
   layer's bf16 B13 backward against the plain reverse recurrence on its
   own operands (phase 2's SCAN_GRAD_TOL), the explain's logits within
   LM_LOGITS_FACTOR times the chunked route's bf16 error, a per-token
   explain through the B13 backward within REPLAY_TOL of autograd over
   the chunked scan in f32 (bf16 printed), an analytic ``h100``
   ``plan_lm`` explain bitwise the
   unplanned one, and phase 7b's LMAdapter server on it; five f32 twins
   (qwen2, moonshot, hymba, seamless with frames, llava with patches) at
   depth 2 on 2 x 32 tokens against the CPU: logits within DOT_TOL, ixg
   scores within REPLAY_TOL of max, the MoE's routing equal; the same
   five in bf16 on the CPU's top two targets (logits, and the embedding
   gradients of a contrastive and an ixg seed, no farther from the f32
   evaluation of the same weights than LM_LOGITS_FACTOR times the CPU
   bf16 twin; their scores within ZOO_BF16_SCORES_TOL of max sum_d
   |rel*e| of the CPU twin's; each device's bf16 linearity printed);
   moonshot's MoE at full width bitwise on two calls, forward and
   backward.

14. train (after phase 13, the earlier phases' memory freed): (a)
   llama3.2-1b FULL (16 layers, d_model 2048, vocab 128256; bf16 compute,
   f32 master, random weights from seed 0 on the card) trained 6 steps by
   ``launch.train.train_loop`` on ``TokenStream(128256, 64, 8)``, every
   loss finite and the first within 1.0 of ln 128256; host ms a step
   (train_loop's last 4), CUDA-event device ms (4 more steps), tokens/s,
   peak memory, clip + AdamW alone; (d) on its model the prefill step then
   7 decode steps, greedy, 4 prompts x 64 tokens, bitwise
   ``lm.decode``'s tokens; (b) cut to 2 of 16 layers at full width: 4
   straight steps bitwise equal to 2 steps, a checkpoint and 2 resumed
   (params, mu, nu, step); the checkpoint's bytes, ``save_async``'s
   blocking ms, ``save_blocking``'s s and restore s of those runs (in a
   temporary directory, removed); (c) the same cut in f32, 2 x 16 tokens,
   2 steps on the card against the CPU from the same state: loss / ce /
   gnorm within DOT_TOL relative, mu and nu within REPLAY_TOL of each
   leaf's max; (e) the paper's Fig. 3 pipeline (tests/test_system.py's):
   the Table III CNN trained 60 AdamW steps of 64 ``CifarLikeImages``
   (lr 3e-3, no weight decay) through the fused blocks under the
   saliency rules (B1, B2, B2+B3, B4, B5 and B6 at S = 1, B11, B12:
   ``PER_TRAIN_CNN_STEP`` a step), accuracy above 0.5 on
   ``batch_at(999, 128)``, the saliency heatmap's in-blob mass median
   above 3x the blob's area share, and the first step's conv weight
   gradients within DOT_TOL of max of float64 with cuDNN's flags at
   PyTorch's default (ROADMAP C1: the port pins IEEE f32 itself).  Paths
   ``train_lm`` (no kernel of ours: the LM train step reaches none, as in
   ``repro``) and ``train_cnn``.
15. multi-device (after phase 14): (a) a NCCL process group of 1 rank
   (``file://`` store in a temporary directory); (b) ``mesh:h100:1`` and
   ``mesh:h100:4`` engines (the latter capped at the world's 1 rank: data
   parallel over ``make_serving_mesh``, every collective run through
   NCCL) against the single-device ``h100`` engine at full Table III
   width, batch 32, top-3, in f32, bf16 and fxp16 and every method:
   explain, forward, replay and every residual byte bitwise, each run
   counted (paths ``dp_f32``, ``dp_bf16``, ``dp_fxp16``: B1-B10); the
   sharded explain timed against the unsharded one, host and CUDA-event
   ms, medians of 24; (c) data-parallel llama3.2-1b FULL train steps on
   ``make_host_mesh(1, 1)`` from phase 14's state on 2 batches, each
   bitwise the plain step from the same state and batch, timed; (d)
   ``compressed_all_reduce``
   of the tied embedding's gradient [128256, 2048] (caught at (c)'s first
   clip) over NCCL, bitwise ``decompress(compress(x + err))`` with the
   residue as the new error, twice, timed, and its wire bytes against
   f32's; (e) last of all (after the profiles, card 0's memory freed),
   with 2 or more cards, ``min(4, count)`` NCCL ranks, one card each, run
   (b) (fxp16 bitwise; f32 within DOT_TOL and bf16 within
   BF16_TOL of max, residual bits within MIN_BIT_AGREEMENT) and (c) (the
   data-parallel gradient within DOT_TOL of each leaf's max of the
   row-weighted f32 sum of the plain step's gradients of each rank's
   slice, loss and CE likewise: each rank rounds the bf16 gradient of its
   rows before the sum, so against the whole batch's plain step bf16
   would set the bound); else one line says the machine has one card.  ``--multi-device`` runs phase 1, then
   phase 15 alone (on a llama3.2-1b state from seed 0), and stops.

Last, the profiler column of phase 2: every row's kernel (and general
route) 50 times under one profiler session, its CUPTI time per call;
then one saliency explain of each CNN path, Table IV's f32 FP+BP at
batch 1 and 32, one training step, one LM decode step and one per-token
LM explain (falcon-mamba-7b, and hymba-1.5b's), and phase 14's
llama3.2-1b train step and its clip + AdamW alone under ``torch.profiler``:
kernel time by kernel and by family against the device time measured
before (the device's idle share); the
bf16 explain's kernels by name must show the forwards and backwards on
the tensor cores, each FC layer one CUDA kernel (``BF16_MMA_KERNELS``).  This
comes after every timing, since a profiler session slows what runs after
it.

Phases 3-4 run once per path, f32, bf16, then fxp16; phase 9's literal
bf16 explain and phases 5 (per branch and precision: ``vjp_fused``,
``vjp_unfused``, ``vjp_fused_bf16``, ``vjp_unfused_bf16``), 6 (``train``,
``train_bf16``), 7 and 8 are paths of their own (phases 7b and 10 are the
server's, reported on their own line; phase 11's perturbation explains
count per precision, as paths ``perturb_f32``, ``perturb_bf16`` and
``perturb_fxp16``, and phase 12's autotuned explains as ``plan_f32``,
``plan_bf16`` and ``plan_fxp16``); the kernels line reports B11 bf16 and
B12 bf16 with their entries' launches on ``vjp_unfused_bf16``.  Launch
counters are set to 0 just before
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
import tempfile
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
    "vmm_bwd_fused_bf16": ("vmm_bwd_fused", "repro_vmm_bwd_fused_bf16"),
    "relu_bwd_bf16": ("relu_bwd", "repro_relu_bwd_bf16"),
    "unpool_bwd_bf16": ("unpool_bwd", "repro_unpool_bwd_bf16")}
#: The path whose launches per entry point the kernels line reports for a
#: bf16 instance the bf16 seed-batched path does not run: B3 bf16 alone
#: (the Table-III-literal explain) and the gate and unpool of the bf16
#: standalone-ops vjp explain (phase 5, summed over its three methods).
BF16_INSTANCE_PATHS = {"maxpool_fwd_bf16": "bf16_literal",
                       "relu_bwd_bf16": "vjp_unfused_bf16",
                       "unpool_bwd_bf16": "vjp_unfused_bf16"}


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
#: backward, and B12's 2-byte unpool), whose registers and spills phase 1
#: reports.
REDESIGNED = ("conv_igemm_kernel", "conv_mma_kernel",
              "relu_pool_fwd_kernel", "vmm_splitk_kernel", "vmm_mma_kernel",
              "vmm_splitk_sum_kernel", "conv_bwd_igemm_kernel",
              "conv_bwd_mma_kernel", "vmm_fxp_splitk_kernel",
              "vmm_fxp_splitk_sum_kernel", "vmm_bwd_tiled_kernel",
              "vmm_bwd_mma_kernel", "selective_scan_kernel",
              "selective_scan_bwd_kernel", "unpool_bwd16_vec_kernel")
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


def f32_conv(*args, **kw):
    """``F.conv2d`` in IEEE f32: the library call f32 kernels are timed
    beside, which computes their function only without TF32 (cuDNN's f32
    default), pinned as the port pins its own cuDNN calls."""
    from repro_torch.kernels.conv2d import ref as conv_ref
    with conv_ref.ieee_f32():
        return F.conv2d(*args, **kw)


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
                            "unpool_bwd", "vmm_kernel",
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
        self.one_seed = []        # B5 / B6 bf16 at S = 1 vs the S = 3 launch
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
                  nbytes, flops, lambda: f32_conv(xn, wn, b, padding=1))

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
              lambda: f32_conv(gn, wn, padding=1))

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


def sweep_bwd_plans(gen):
    """``--sweep``, fused conv backward: time a grid of tile plans at each
    launch of :data:`SWEEP_BWD` beside the general kernel, every plan held
    bitwise to ``conv_bwd_plan``'s (and that one to the plain version:
    within DOT_TOL in f32, bitwise in int16); say where the rule lands."""
    from repro_torch.core import fixedpoint, masks
    from repro_torch.kernels.conv2d.conv2d import (CONV_BWD_GENERAL,
                                                   conv2d_bwd_fused,
                                                   conv2d_bwd_fused_plain,
                                                   conv_bwd_candidates,
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
            for p in set(conv_bwd_candidates(
                    s, h, c, cout, 3, pooled=pooled,
                    esize=g.element_size())) | {chosen}:
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
    from repro_torch.kernels.conv2d.conv2d import (conv2d_planned,
                                                   conv_candidates, conv_plan)
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
            lib = device_time_ms(lambda: f32_conv(xn, wn, b, padding=1))
            chosen = conv_plan(BATCH, h, h, cin, cout, 3)
            first = conv2d_planned(x, w, b, plan=chosen)
            case = f"conv {kind} [{BATCH},{h},{h},{cin}->{cout}]"
            close(first, conv_ref.conv2d(x, w) + b, case)
            found = []
            for p in set(conv_candidates(h, cin, cout, 3)) | {chosen}:
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
    from repro_torch.kernels.conv2d.conv2d import (CONV_GENERAL,
                                                   conv_candidates, conv_plan)
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
        for p in set(conv_candidates(h, cin, cout, 3,
                                     esize=x.element_size())) \
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
                  f32_reference_fn=lambda: f32_conv(xn, wn, bf, padding=1),
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
                                                   conv_bwd_mma_candidates,
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
                                             vmm_bwd_mma_candidates,
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
            check_bwd_bf16_one_seed(
                kc, "conv2d_bwd_fused_bf16", case, got, g,
                lambda g1, wt=wt, kw=kw, **k: conv2d_bwd_fused(g1, wt, **kw,
                                                               **k),
                lambda g1, wt=wt, kw=kw: conv2d_bwd_fused_plain(g1, wt, **kw),
                lambda g1, wt=wt, kw=kw: bwd_fused_plain(
                    conv_ref.conv2d_widened, g1, wt, **kw),
                _other_plan(conv_bwd_bf16_plan(1, n, h, h, c, cout, 3,
                                               pooled=pooled),
                            conv_bwd_mma_candidates(1, h, h, c, cout, 3,
                                                    pooled=pooled)), nbytes,
                torch.count_nonzero(gate_gradient(gg[0], bits,
                                                  method)).item(), 9 * cout)

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
            check_bwd_bf16_one_seed(
                kc, "vmm_bwd_fused_bf16", case, got, g,
                lambda g1, wt=wt, kw=kw, **k: vmm_bwd_fused(g1, wt, **kw, **k),
                lambda g1, wt=wt, kw=kw: vmm_bwd_fused_plain(g1, wt, **kw),
                lambda g1, wt=wt, kw=kw: vbwd_plain(vmm_ref.vmm_widened, g1,
                                                    wt, **kw),
                _other_plan(vmm_bwd_mma_plan(1, n, k, n_out),
                            vmm_bwd_mma_candidates(1, n, k, n_out)),
                nbytes, torch.count_nonzero(gg[0]).item(), n_out)


def _other_plan(rule, candidates):
    """The first of a launch's candidate tile plans that is not its rule's
    (a second tile of the same route, for a bitwise check)."""
    return next(p for p in candidates if p != rule)


def check_bwd_bf16_one_seed(kc, row, case, got_s, g, launch, plain, widened,
                            other, nbytes_s, nnz1, per_nnz):
    """The vjp path's launch of a bf16 fused backward: seed 0 of ``g``
    alone (S = 1, g [N, ...]), as autograd gives it to a block.  Within
    one bf16 step of its plain version, bitwise again and under ``other``
    (a second tile plan), and compared with seed 0 of the seed-batched
    launch ``got_s``: bitwise where each output sums in the same order
    whatever S is; otherwise held within one bf16 step of it and the
    launch named.  Timed as a row apart from the seed-batched path's
    (``main`` off); bytes and operations are seed 0's share of the S = 3
    launch's, the weights read whole; ``nnz1`` is seed 0's gated
    gradients, each ``per_nnz`` multiply-adds."""
    g1 = g[0].contiguous()
    got = launch(g1)
    acc = widened(g1)
    case1 = case.replace(f"[{SEEDS},", "[1,") + " S=1"
    _bitwise_repeat(row, case1, got, (
        ("again", lambda: launch(g1)),
        (f"under {other}", lambda: launch(g1, plan=other))))
    same = _same_bits(got, got_s[0])
    if not same:
        err = bf16_close(got, got_s[0], acc)
        print(f"  {row:20s} {case1:34s} NOT bitwise seed 0 of the S = "
              f"{SEEDS} launch: within one bf16 step of it (max|d| "
              f"{err:.2e})")
    kc.one_seed.append(dict(kernel=row, case=case1, bitwise_seed_batched=same))
    seed_share = g1.numel() * 2 * (SEEDS - 1)
    kc.record(row, case1, False, got, plain(g1), False, lambda: launch(g1),
              lambda: plain(g1),
              nbytes_s - seed_share - (got_s.numel() - got.numel()) * 2,
              2 * nnz1 * per_nnz, rate=BF16_FLOP_PER_S,
              close=lambda g_, w_, acc=acc: bf16_close(g_, w_, acc))


def check_kernels_autograd(kc: KernelCheck):
    """B11 (three methods; f32 and bf16) and B12 (f32, bf16 and int16) at
    the shapes of the unfused backward, bitwise (bf16 compared as its 16
    bits, so a signed zero counts): they select and route, so any
    difference is a fault.  No PyTorch call computes either;
    ``F.max_unpool2d`` on the same routing (NCHW, int64 flat indices) is
    timed as a reference point."""
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

    # B11 bf16: the same five of the bf16 unfused backward, -0.0 gradients
    # gated to +0.0 by g > 0 and kept where the mask alone passes them
    for method in METHODS:
        for r, c in ((n * 32 * 32, 32), (n * 32 * 32, 32), (n * 16 * 16, 64),
                     (n * 16 * 16, 64), (n, 128)):
            _, m = relu_fwd(randn(gen, r, c).to(torch.bfloat16))
            m = None if method == "deconvnet" else m
            g = randn(gen, r, c, scale=1e-2).to(torch.bfloat16)
            g[0] = 0.0
            g[1] = -0.0
            nbytes = 2 * 2 * r * c + (0 if m is None else r * mask_bytes(c))
            kc.record("relu_bwd_bf16", f"{method} [{r},{c}]",
                      method == "saliency",
                      relu_bwd(m, g, method).view(torch.int16),
                      relu_ref.relu_bwd(m, g, method).view(torch.int16),
                      True, lambda: relu_bwd(m, g, method),
                      lambda: relu_ref.relu_bwd(m, g, method), nbytes, r * c)

    # B12: the two pools' unpool, on post-ReLU maps (tied zero windows)
    for h, c in ((32, 32), (16, 64)):
        hp = h // 2
        _, idx = maxpool_fwd(torch.clamp_min(randn(gen, n, h, h, c) - 0.5, 0))
        k = masks.unpack_crumbs(idx, c).permute(0, 3, 1, 2).to(torch.int64)
        ii = torch.arange(hp, device="cuda")
        flat = (2 * ii[:, None] + k // 2) * h + 2 * ii[None, :] + k % 2
        for dtype in (torch.float32, torch.bfloat16, torch.int16):
            g = randn(gen, n, hp, hp, c, scale=1e-2)
            name, fn, size = "unpool_bwd", unpool_bwd, 4
            lib = None
            if dtype == torch.int16:
                g = fixedpoint.to_fixed(g * 100)
                name, fn, size = "unpool_bwd_i16", unpool_bwd_fxp, 2
            else:
                if dtype == torch.bfloat16:
                    g = g.to(torch.bfloat16)
                    g[:, 0, 0] = -0.0     # the argmax keeps its sign
                    name, size = "unpool_bwd_bf16", 2
                gn = g.permute(0, 3, 1, 2).contiguous()
                out = F.max_unpool2d(gn, flat, 2, output_size=(h, h))
                if not torch.equal(out.permute(0, 2, 3, 1),
                                   pool_ref.unpool_bwd(idx, g)):
                    fail("F.max_unpool2d on the crumbs' routing differs from "
                         "the plain unpool")

                def lib(gn=gn):
                    return F.max_unpool2d(gn, flat, 2, output_size=(h, h))
            # bf16 as its 16 bits: a signed zero must survive the route
            bits = ((lambda t: t.view(torch.int16)) if dtype == torch.bfloat16
                    else (lambda t: t))
            nbytes = size * 5 * g.numel() + idx.numel()
            kc.record(name, f"[{n},{hp},{hp},{c}]->[{n},{h},{h},{c}]"
                      + {torch.int16: " int16", torch.bfloat16: " bf16"}.get(
                          dtype, ""), True,
                      bits(fn(idx, g)), bits(pool_ref.unpool_bwd(idx, g)),
                      True, lambda: fn(idx, g),
                      lambda: pool_ref.unpool_bwd(idx, g),
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


def _scan_row(kc: KernelCheck, gen, s, dtype, d, every=True):
    """One B13 case of phase 2 (phase 16 (a): a model rank's channels):
    the forward under two knob pairs, bitwise; the backward on the main
    path's gradients (and, with ``every``, all six with a gh), bitwise
    under both pairs and run to run, against the plain versions."""
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan.ssm_scan import (selective_scan,
                                                       selective_scan_bwd)
    b, n = LM_BATCH, 16
    main_needs = (True, True, True, True, False, False)

    def inputs(s, dtype, d):
        dt = F.softplus(randn(gen, b, s, d) - 4.6)      # as dt_bias sets
        x = randn(gen, b, s, d).to(dtype)
        return (dt, x, randn(gen, b, s, n), randn(gen, b, s, n),
                -torch.exp(randn(gen, d, n) * 0.3), randn(gen, b, d, n))

    # the explain's knobs, the default's (a d_tile that divides D)
    tiles = ((d, 128), (256 if d % 256 == 0 else 32, 64))
    args = inputs(s, dtype, d)
    xs = args[1].element_size()
    nbytes = (4 * b * s * d + 2 * xs * b * s * d + 2 * 4 * b * d * n
              + 4 * d * n + 2 * 4 * b * s * n)
    main = (s == LM_PROMPT + LM_NEW and dtype == torch.bfloat16
            and d == 8192)
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
    for needs, g_h in ((main_needs, None), (None, gh))[:2 if every else 1]:
        every_six = needs is None

        def bwd(dtl=d, ck=128, needs=needs, g_h=g_h, args=args, gy=gy):
            return selective_scan_bwd(*args, gy, g_h, d_tile=dtl,
                                      chunk=ck, needs=needs)

        def plain(needs=needs, g_h=g_h, args=args, gy=gy):
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
                  case + (" all six, gh" if every_six else ""),
                  main and not every_six,
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


def check_kernels_scan(kc: KernelCheck):
    """B13 at falcon-mamba-7b's explain shape (B = 4 prompts, S = 72, D =
    8192, N = 16; x bf16 on the main path, f32 beside it), a ragged S = 13,
    hymba-1.5b's explain shape (D = 3200, the lm_zoo path's), and D = 3232
    (off the backward's 128-channel partial group), each under two knob
    pairs that must agree bit for bit; then B13's backward kernel on the
    same inputs: on the main path's gradients (dt, x, B, C; h_last unused,
    so no gh) and, beside it, all six with a gh, against the plain reverse
    recurrence, bitwise under both knob pairs and run to run.  No PyTorch
    call computes either: the library column is none.  The backward the
    kernel replaced (autograd over the chunked scan) and autograd over the
    sequential loop are timed beside it."""
    gen = torch.Generator(device="cuda").manual_seed(1357)
    for s, dtype, d in ((LM_PROMPT + LM_NEW, torch.bfloat16, 8192),
                        (LM_PROMPT + LM_NEW, torch.float32, 8192),
                        (13, torch.bfloat16, 8192),
                        (LM_PROMPT + LM_NEW, torch.bfloat16, 3200),
                        (13, torch.bfloat16, 3232)):
        _scan_row(kc, gen, s, dtype, d)
    print("  selective_scan and selective_scan_bwd under the explain's "
          "knobs (D, 128) and the default's (256 or 32, 64): bitwise equal "
          "(the backward also run to run)")


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
    "autodiff")`` (the software baseline, plain ops), what it saves for a
    bf16 saliency vjp explain on the fused blocks (the bf16 weights and
    exactly the packed residual bytes, nothing else), and the peak device
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
    # the bf16 vjp explain on the fused blocks: autograd's graph holds the
    # bf16 weights and the packed bytes, no activation (the casts save
    # nothing)
    bf16_vjp = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                method="saliency", precision="bf16",
                                backward="vjp", targets=TopK(SEEDS)))
    saved_bf16 = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved_bf16.append(t) or t, lambda t: t):
        bf16_vjp.explain(x)
    floats = [t for t in saved_bf16 if t.is_floating_point()]
    state = [t for t in saved_bf16 if not t.is_floating_point()]
    weight_shapes = sorted(tuple(q["w"].shape) for k in ("conv", "fc")
                           for q in params[k])
    if (sorted(tuple(t.shape) for t in floats) != weight_shapes
            or any(t.dtype != torch.bfloat16 for t in floats)):
        fail(f"bf16 vjp explain: autograd saved float tensors "
             f"{[(tuple(t.shape), t.dtype) for t in floats]}, want the "
             f"bf16 weights alone")
    _, res16 = cnn.forward_with_residuals(pc, x, cfg, "saliency", "bf16")
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    packed16 = residuals.residual_bits(res16) // 8
    if any(t.dtype != torch.uint8 for t in state) or state_bytes != packed16:
        fail(f"bf16 vjp explain: autograd saved {state_bytes} B of state, "
             f"the packed residuals are {packed16} B")
    weight_bytes = sum(t.numel() * t.element_size() for t in floats)
    out["memory"] = dict(autograd_saved_bytes=saved_bytes,
                         packed_residual_bytes=packed_bytes,
                         peak_packed_explain_bytes=peak_packed,
                         peak_vjp_autodiff_explain_bytes=peak_vjp,
                         bf16_vjp_saved_state_bytes=state_bytes,
                         bf16_vjp_saved_weight_bytes=weight_bytes)
    print(f"  bf16 vjp saliency explain (fused blocks): autograd saves the "
          f"bf16 weights ({weight_bytes} B) and {state_bytes} B of packed "
          f"masks and crumbs (= the bf16 residuals' {packed16} B), no "
          f"activation")
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
#: backward pass per seed), per branch; every other counter stays at 0.
#: The bf16 branches make the same launches through the bf16 entries.
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
PER_EXPLAIN_VJP.update({f"{b}_bf16": v for b, v in
                        list(PER_EXPLAIN_VJP.items())})
#: the bf16 standalone-ops explain by kernel: the forward's conv layers
#: 1-3 on the tensor cores and layer 0 on FFMA, then every dx conv (the
#: flipped weight's Cin is 32 or 64) on the tensor cores
VJP_UNFUSED_BF16_ROUTES = {"conv2d_fwd_bf16_mma": 3 + 4 * SEEDS,
                           "conv2d_fwd_bf16_ffma": 1,
                           "conv2d_bwd_fused_bf16_mma": 0,
                           "conv2d_bwd_fused_bf16_ffma": 0,
                           "vmm_bwd_fused_bf16_mma": 0}
#: kernel launches per training step (autodiff: the ReLU is torch.maximum,
#: no mask; dx of conv layers 1-3 and both FC layers on B1/B4); the bf16
#: step the same through the bf16 entries
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


def _flipped_examples(res_a, res_b, n=BATCH):
    """Indices of the ``n`` examples whose stored residual bits differ."""
    tensors = [t for pair in zip(res_a["conv"], res_b["conv"])
               for t in zip(*pair)] + list(zip(res_a["fc"], res_b["fc"]))
    bad = torch.zeros(n, dtype=torch.bool)
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


def _entries_and_routes(what, rose, bf16, routes_want=None):
    """The launches of the call just counted, per C entry point and per
    bf16 kernel (``_build``'s tables, reset by :func:`_count`): under bf16
    every launch through a bf16 entry (:func:`bf16_entries`) and by kernel
    as ``routes_want`` (the seed-batched split when None); under f32
    through the f32 entries.  Returns the entry launches."""
    from repro_torch.kernels import ENTRY_LAUNCHES, _build
    entries = dict(ENTRY_LAUNCHES)
    if not bf16:
        if any(v and k.endswith("_bf16") for k, v in entries.items()):
            fail(f"{what}: a bf16 entry launched on the f32 path")
        return entries
    if entries != bf16_entries(rose, entries):
        fail(f"{what}: launches per entry point "
             f"{ {k: v for k, v in entries.items() if v} }, not all through "
             f"the bf16 entries")
    routes = dict(_build.ROUTE_LAUNCHES)
    if routes_want is None:
        check_bf16_routes(what, routes, rose)
    elif routes != routes_want:
        fail(f"{what}: bf16 launches by kernel {routes}, want {routes_want}")
    return entries


def check_vjp(params, cfg, x_cpu, launches, entry_launches, to_profile):
    """Phase 5: the vjp backend on both kernel branches, per method, in f32
    and in bf16.  bf16: the logits bf16 and the relevance f32 (the bf16
    cotangent widened through the input's cast), against the bf16
    seed-batched card engine (the fused branch runs the same kernels at S
    = 1: bitwise expected, else within BF16_TOL and the launch named by
    phase 2; the standalone ops sum dx on B1/B4 bf16, another order:
    BF16_TOL) and a CPU twin within BF16_TOL * max."""
    from repro_torch.engine import CNNModel, EngineSpec, FnModel, TopK, build
    from repro_torch.models import cnn

    def unfused(p, precision):
        return lambda m: (lambda v: cnn.apply(p, v, cfg, method=m,
                                              use_pallas=True, fused=False,
                                              precision=precision))

    x = x_cpu.cuda()
    results = {}
    for precision in ("f32", "bf16"):
        bf16 = precision == "bf16"
        logit_tol, rel_tol = (BF16_TOL, BF16_TOL) if bf16 else (DOT_TOL,
                                                                 REPLAY_TOL)
        sfx = "_bf16" if bf16 else ""
        p_card = cnn.params_to(params, "cuda")
        for method in METHODS:
            spec = dict(method=method, precision=precision,
                        targets=TopK(SEEDS))
            pair = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                    **spec))
            logits_sb, rel_sb, res = pair.predict_then_explain(x)
            twin = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                                    **spec))
            _, _, res_c = twin.predict_then_explain(x_cpu)
            # the CPU's backward on the card's stored bits, every example
            rel_x = twin.replay(cnn.residuals_to(res, "cpu"),
                                pair._seeds(logits_sb, None, SEEDS)[0].cpu())
            bad = _flipped_examples(res, res_c)
            keep = ~bad
            spec["backward"] = "vjp"
            for branch, card, cpu in (
                    ("vjp_fused" + sfx, CNNModel(params, cfg, device="cuda"),
                     CNNModel(params, cfg, device="cpu")),
                    ("vjp_unfused" + sfx,
                     FnModel(unfused(p_card, precision), device="cuda"),
                     FnModel(unfused(params, precision), device="cpu"))):
                eng = build(EngineSpec(card, **spec))
                (logits, rel), rose = _count(lambda: eng.explain(x),
                                             launches.setdefault(branch, {}))
                want = dict(PER_EXPLAIN_VJP[branch])
                if branch.startswith("vjp_fused") and method == "deconvnet":
                    want["relu_fwd"] = 0          # Table II: no mask stored
                _expect(rose, want, f"{branch} {method} explain")
                entries = _entries_and_routes(
                    f"{branch} {method} explain", rose, bf16,
                    VJP_UNFUSED_BF16_ROUTES if branch == "vjp_unfused_bf16"
                    else None)
                totals = entry_launches.setdefault(branch, {})
                for k, v in entries.items():
                    totals[k] = totals.get(k, 0) + v
                if tuple(rel.shape) != (SEEDS, BATCH, 32, 32, 3) or not bool(
                        torch.isfinite(rel).all()):
                    fail(f"{branch} {method}: relevance {tuple(rel.shape)} "
                         f"not finite/shaped")
                if bf16 and not (logits.dtype == torch.bfloat16
                                 and rel.dtype == torch.float32):
                    fail(f"{branch} {method}: logits {logits.dtype}, "
                         f"relevance {rel.dtype}; want bf16 and f32")
                lf, rf = logits.float(), rel.float()
                err_sb = (lf - logits_sb.float()).abs().max().item()
                rerr_sb = (rf - rel_sb.float()).abs().max().item()
                bitwise_sb = bool(torch.equal(logits, logits_sb)
                                  and torch.equal(rf, rel_sb.float()))
                if not (err_sb <= logit_tol * logits_sb.float().abs().max()
                        .item() and rerr_sb <= rel_tol
                        * rel_sb.float().abs().max().item()):
                    fail(f"{branch} {method}: vs the seed-batched engine "
                         f"logits {err_sb:.3e}, relevance {rerr_sb:.3e}")
                logits_c, rel_c = build(EngineSpec(cpu, **spec)).explain(
                    x_cpu)
                err = (lf.cpu() - logits_c.float()).abs().max().item()
                if not err <= logit_tol * logits_c.float().abs().max().item():
                    fail(f"{branch} {method}: logits card vs CPU {err:.3e}")
                rref = rel_c.float().abs().max().item()
                rerr = (rf.cpu() - rel_c.float())[:, keep].abs().max().item()
                if not rerr <= rel_tol * rref:
                    fail(f"{branch} {method}: relevance card vs CPU "
                         f"{rerr:.3e} (max|rel| {rref:.3e})")
                rerr_all = (rf.cpu() - rel_c.float()).abs().max().item()
                xerr = (rf.cpu() - rel_x.float()).abs().max().item()
                if not xerr <= rel_tol * rel_x.float().abs().max().item():
                    fail(f"{branch} {method}: relevance vs the CPU replay of "
                         f"the card's residuals {xerr:.3e}")
                ms, dev_ms = _host_device_ms(lambda: eng.explain(x))
                if method == "saliency":
                    to_profile.append((f"{branch} {method} explain",
                                       lambda eng=eng: eng.explain(x),
                                       dev_ms))
                results[f"{branch} {method}"] = dict(
                    logits_err=err, rel_err=rerr, rel_err_all=rerr_all,
                    rel_err_cpu_replay=xerr, rel_max=rref,
                    flipped_examples=int(bad.sum()),
                    vs_seed_batched=(err_sb, rerr_sb),
                    bitwise_seed_batched=bitwise_sb, explain_ms_host=ms,
                    explain_ms_device=dev_ms, launches_per_explain=rose)
                print(f"  {branch:16s} {method:9s} logits err {err:.2e}  rel "
                      f"err {rerr:.2e} on {int(keep.sum())} examples "
                      f"({rerr_all:.2e} on all {BATCH}; max|rel| "
                      f"{rref:.2e}), {xerr:.2e} vs the CPU replay of the "
                      f"card's bits  vs seed-batched {err_sb:.2e}/"
                      f"{rerr_sb:.2e}"
                      + (" (bitwise)" if bitwise_sb else "")
                      + f"  explain {ms:.3f} ms host, {dev_ms:.3f} ms device")
    return results


def check_train(params, cfg, x_cpu, launches, entry_launches, to_profile):
    """Phase 6: AdamW steps of the autodiff loss on the kernel path, in f32
    (TRAIN_STEPS) and then one in bf16 (``precision="bf16"``: the loss on
    the bf16 logits widened, the parameter gradients f32 holding bf16
    values), each step's gradients against a CPU twin's on the examples
    whose residual bits the two devices agree on."""
    from repro_torch import optim
    from repro_torch.models import cnn

    y_cpu = torch.randint(0, cfg.num_classes, (BATCH,),
                          generator=torch.Generator().manual_seed(2))

    def loss_and_grads(p, x, y, precision="f32"):
        p = {k: [{n: t.detach().requires_grad_() for n, t in q.items()}
                 for q in v] for k, v in p.items()}
        leaves = [q[n] for k in ("conv", "fc") for q in p[k]
                  for n in ("w", "b")]
        loss = F.cross_entropy(cnn.apply(p, x, cfg, use_pallas=True,
                                         precision=precision).float(), y)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def tree(flat):
        it = iter(flat)
        return {k: [{n: next(it) for n in ("w", "b")} for _ in params[k]]
                for k in ("conv", "fc")}

    p = cnn.params_to(params, "cuda")
    state = optim.adamw_init(p)
    x, y = x_cpu.cuda(), y_cpu.cuda()
    losses, errs = [], []
    for step, precision in enumerate(["f32"] * TRAIN_STEPS + ["bf16"]):
        bf16 = precision == "bf16"
        path, tol = ("train_bf16", BF16_TOL) if bf16 else ("train",
                                                           REPLAY_TOL)
        what = f"train step {step} ({precision})"
        (loss, grads), rose = _count(
            lambda: loss_and_grads(p, x, y, precision),
            launches.setdefault(path, {}))
        _expect(rose, PER_TRAIN_STEP, what)
        entries = _entries_and_routes(what, rose, bf16, {
            "conv2d_fwd_bf16_mma": 3 + 3, "conv2d_fwd_bf16_ffma": 1,
            "conv2d_bwd_fused_bf16_mma": 0, "conv2d_bwd_fused_bf16_ffma": 0,
            "vmm_bwd_fused_bf16_mma": 0})
        if bf16:
            entry_launches[path] = entries
        p_cpu = cnn.params_to(p, "cpu")
        _, res = cnn.forward_with_residuals(p, x, cfg, "saliency", precision)
        _, res_c = cnn.forward_with_residuals(p_cpu, x_cpu, cfg, "saliency",
                                              precision)
        keep = ~_flipped_examples(res, res_c)
        g_card = grads
        g_cpu = loss_and_grads(p_cpu, x_cpu, y_cpu, precision)[1]
        if not bool(keep.all()):      # compare on the agreeing examples
            g_card = loss_and_grads(p, x[keep.cuda()], y[keep.cuda()],
                                    precision)[1]
            g_cpu = loss_and_grads(p_cpu, x_cpu[keep], y_cpu[keep],
                                   precision)[1]
        worst = 0.0
        for i, (g, g_c) in enumerate(zip(g_card, g_cpu)):
            if not bool(torch.isfinite(g).all()) or g.dtype != torch.float32:
                fail(f"{what}: gradient {i} not finite, or {g.dtype}")
            e = (g.cpu() - g_c).abs().max().item()
            ref = g_c.abs().max().item()
            if not e <= tol * ref:
                fail(f"{what}: gradient {i} card vs CPU {e:.3e} (max|g| "
                     f"{ref:.3e})")
            worst = max(worst, e / ref)
        losses.append(loss.item())
        errs.append(worst)
        print(f"  {what}: loss {loss.item():.6f}  grads card vs CPU max rel "
              f"err {worst:.2e} on {int(keep.sum())} of {BATCH} examples")
        p, state = optim.adamw_update(tree(grads), state, p, lr=TRAIN_LR)

    times = {}
    for precision in ("f32", "bf16"):
        def step_fn(precision=precision):
            optim.adamw_update(tree(loss_and_grads(p, x, y, precision)[1]),
                               state, p, lr=TRAIN_LR)

        ms, dev_ms = _host_device_ms(step_fn)
        times[precision] = (ms, dev_ms)
        print(f"  train step {precision}: {ms:.3f} ms host, {dev_ms:.3f} ms "
              f"device (batch {BATCH}, forward + backward + AdamW)")
        to_profile.append(("train step" + (" bf16" if precision == "bf16"
                                           else ""), step_fn, dev_ms))
    return dict(losses=losses, grad_rel_err=errs,
                step_ms_host=times["f32"][0], step_ms_device=times["f32"][1],
                bf16_step_ms_host=times["bf16"][0],
                bf16_step_ms_device=times["bf16"][1])


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
    d_inner 8192, N 16, vocab 65024, bf16), random weights.  Returns
    ``((params, cfg, decode result), results)``: the model stays on the
    card for phase 12."""
    from repro_torch.tree import leaves
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
    n_params = sum(t.numel() for t in leaves(params))
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
    return (params, cfg, res), dict(
        init_s=init_s, n_params=n_params, linearity_err=lin_err,
        route_err=route_err, serve=serve, layer_errs=layer_errs,
        logits_vs_chunked=logit_err, chunked_vs_f32=chunk_err,
        argmax_agree=same_argmax, times=times, engine=results,
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


def _b13_bwd_layer_errs(explain, n_layers):
    """``explain()`` once, each layer's B13 backward held against the plain
    reverse recurrence (``ref.selective_scan_bwd``) on the same operands,
    cotangents and ``needs``, at phase 2's tolerance (:func:`_grad_close`).
    Returns the largest |d| of each layer's gradients.  As in
    :func:`_b13_layer_errs`, the wrapper is swapped for this one explain and
    its launches are comparisons, not counted."""
    from repro_torch.kernels.ssm_scan import ref as scan_ref
    from repro_torch.kernels.ssm_scan import ssm_scan
    real, errs = ssm_scan.selective_scan_bwd, []

    def held(dt, x, bmat, cmat, a, h0, gy, gh, *, d_tile, chunk,
             needs=None):
        got = real(dt, x, bmat, cmat, a, h0, gy, gh, d_tile=d_tile,
                   chunk=chunk, needs=needs)
        want = scan_ref.selective_scan_bwd(dt, x, bmat, cmat, a, h0, gy, gh,
                                           needs)
        what = f"lm layer {len(errs)}: B13 bwd vs the plain recurrence"
        errs.append(max(_grad_close(g, w, what) for g, w in zip(got, want)
                        if g is not None))
        return got

    ssm_scan.selective_scan_bwd = held
    try:
        explain()
    finally:
        ssm_scan.selective_scan_bwd = real
    if len(errs) != n_layers:
        fail(f"lm: {len(errs)} scan backwards held, want {n_layers}")
    return errs


def _f32_last_logits(params, cfg, tokens):
    """Last-position logits of the same weights evaluated in f32, layer by
    layer (each layer's weights widened as it runs; chunked scan; each
    segment's attention window)."""
    from repro_torch.tree import tree_map
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    c32 = cfg.with_(dtype="float32")

    def up(tree):
        return tree_map(lambda t: t.to(torch.float32), tree)

    x = tf.embed_inputs(params, cfg, {"tokens": tokens}).to(torch.float32)
    rope_cs = tf._rope(c32, x.shape[1], x.device)
    for si, (kind, count, window) in enumerate(cfg.layer_plan()):
        for lp in tf._unstack(params["segments"][si], count):
            x, _, _ = tf._block(up(lp), x, c32, kind, rope_cs=rope_cs,
                                window=window, method="autodiff")
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return layers.lm_head(up(params["embed"]), x, c32)[:, -1]


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
# phase 11: the perturbation explainers, and the kernel profiler
# ---------------------------------------------------------------------------

PERTURB_METHODS = ("occlusion", "lime", "rise")
#: masks a method folds at its defaults on 32 x 32 (occlusion: window 4,
#: stride 2, 15 x 15 positions; LIME and RISE: 256 samples)
PERTURB_N = {"occlusion": 225, "lime": 256, "rise": 256}
#: kernel launches of one batched perturbation explain: the base forward
#: and the fold, each 4 conv, 2 mask-free fused ReLU + pool and 2 FC
#: launches (no ReLU mask, no backward kernel)
PER_PERTURB = {
    "f32": {"conv2d_fwd": 8, "relu_pool_fwd": 4, "vmm_fwd": 4},
    "bf16": {"conv2d_fwd": 8, "relu_pool_fwd": 4, "vmm_fwd": 4},
    "fxp16": {"conv2d_fxp_fwd": 8, "relu_pool_fwd": 4, "vmm_fxp_fwd": 4},
}
#: RISE samples of the large fold: 2,100 x 32 = 67,200 rows, more images
#: than gridDim.z holds (the conv entries launch them in chunks)
PERTURB_BIG_SAMPLES, PERTURB_SLICE = 2100, 65_535
PERTURB_TWIN_ROWS, PERTURB_SERVE_N, PERTURB_SERVE_BATCH = 2, 24, 8
PROFILE_FAMILIES = ("conv2d_fwd", "conv2d_bwd", "vmm_fwd", "vmm_bwd", "pool",
                    "other")


def _family(kernel_name: str) -> str:
    """The profiler family (``obs/profile.py``) of a CUDA kernel, by
    name; B2 and PyTorch's own kernels are "other"."""
    n = kernel_name
    if "conv_bwd" in n:
        return "conv2d_bwd"
    if "vmm_bwd" in n:
        return "vmm_bwd"
    if any(k in n for k in ("conv_igemm_kernel", "conv_mma_kernel",
                            "conv_kernel", "conv_fxp_kernel")):
        return "conv2d_fwd"
    if any(k in n for k in ("vmm_splitk", "vmm_fxp_splitk", "vmm_mma_kernel",
                            "vmm_kernel", "vmm_fxp_kernel")):
        return "vmm_fwd"
    pooled = re.search(r"relu_pool_fwd_kernel<[^,]+, *(true|false)", n)
    if (pooled and pooled.group(1) == "true") or "maxpool_fwd_kernel" in n:
        return "pool"
    return "other"


def cupti_by_family(fns, reps: int = 5):
    """CUPTI kernel time a call of each ``fn``, by profiler family: the
    calls under one ``torch.profiler`` session, split by sleep kernels as
    :func:`cupti_per_call` splits them.  None where the split fails."""
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
        if "spin_kernel" in e.name:
            if cur is not None:
                groups.append({k: v / reps for k, v in cur.items()})
            cur = {}
        elif cur is not None:
            fam = _family(e.name)
            cur[fam] = cur.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    groups = groups[len(groups) - len(fns):]
    if len(groups) != len(fns) or not all(groups):
        print(f"  cupti_by_family: {len(groups)} groups for {len(fns)} "
              f"calls; not measured")
        return None
    return groups


def _profiled_ms(fn):
    """``obs.profile.KernelProfiler`` over one call of ``fn`` (after a
    warm-up): fenced wall ms a call by family, and the calls."""
    from repro_torch.obs import profile as obs_profile
    fn()
    torch.cuda.synchronize()
    with obs_profile.profiled() as prof:
        fn()
    by_family, calls = {}, {}
    for (family, _, _), a in prof.aggregates().items():
        by_family[family] = (by_family.get(family, 0.0)
                             + a["count"] * a["mean_us"] / 1e3)
        calls[family] = calls.get(family, 0) + a["count"]
    return by_family, calls


def _perturb_masks(method, seeds, n, hw, device):
    from repro_torch import perturb
    if method == "occlusion":
        return perturb.occlusion_masks(hw, window=4, stride=2, device=device)
    fn = getattr(perturb, f"{method}_masks")
    return fn(perturb.generators(seeds, device), n, hw)


def _masks_to(ms, device):
    import dataclasses
    return dataclasses.replace(
        ms, packed=ms.packed.to(device),
        shifts=None if ms.shifts is None else ms.shifts.to(device))


def check_perturb_twin(eng, twin, x, x_cpu, method, precision, seeds):
    """The CPU twin on PERTURB_TWIN_ROWS rows with the card's masks: (a)
    the fold's logits and per-mask target logits on the card against the
    CPU's (fxp16 bitwise, f32 DOT_TOL, bf16 BF16_TOL, times max|logits|);
    (b) the heatmap against the CPU's aggregation of the card's fold
    outputs (the masks applied, scores gathered and aggregated on the
    CPU), within DOT_TOL * max (LIME: REPLAY_TOL, a ridge solve by
    another library)."""
    from repro_torch import perturb
    rows = PERTURB_TWIN_ROWS
    ms = _perturb_masks(method, seeds[:rows], PERTURB_N[method], (32, 32),
                        "cuda")
    dense = ms.dense()
    card_fold = eng._fold_forward()
    lc, tc, sc = perturb.perturb_scores(card_fold, x[:rows], dense)
    lt, tt, st = perturb.perturb_scores(twin._fold_forward(), x_cpu[:rows],
                                        dense.cpu())
    if precision == "fxp16":
        if not (torch.equal(lc.cpu(), lt) and torch.equal(sc.cpu(), st)):
            fail(f"perturb {precision} {method}: CPU twin's logits or "
                 f"scores differ")
    else:
        tol = DOT_TOL if precision == "f32" else BF16_TOL
        scale = lt.float().abs().max().item()
        for what, a, b in (("logits", lc, lt), ("scores", sc, st)):
            err = (a.float().cpu() - b.float()).abs().max().item()
            if err > tol * scale:
                fail(f"perturb {precision} {method}: twin {what} off by "
                     f"{err:.3g} (max {scale:.3g})")

    def card_on_cpu(xb):
        return card_fold(xb.cuda()).cpu()

    args = () if method == "occlusion" else (None,)
    masks = dense if method == "rise" else ms
    cpu_masks = dense.cpu() if method == "rise" else _masks_to(ms, "cpu")
    _, heat = getattr(perturb, method)(card_fold, x[:rows], *args,
                                       masks=masks)
    _, heat_t = getattr(perturb, method)(card_on_cpu, x_cpu[:rows], *args,
                                         masks=cpu_masks)
    tol = REPLAY_TOL if method == "lime" else DOT_TOL
    err = _rel_err(heat.cpu(), heat_t)
    if err > tol:
        fail(f"perturb {precision} {method}: heat off the CPU's aggregation "
             f"of the card's outputs by {err:.3g} of max")
    return err


def check_perturb(params, cfg, x_cpu, launches):
    """Phase 11: ``Engine.perturb`` at full Table III width, batch 32,
    occlusion (N = 225), LIME and RISE (N = 256) in f32, bf16 and fxp16,
    per-example seeds; a RISE fold of 67,200 rows; 24 served requests;
    the kernel profiler beside CUPTI (read at the end)."""
    from repro_torch import perturb
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.perturb.scores import _masked_fold
    from repro_torch.serve import CNNAdapter, ExplanationServer, Request
    x = x_cpu.cuda()
    seeds = list(range(100, 100 + BATCH))
    results = {}
    for precision in ("f32", "bf16", "fxp16"):
        eng = build(EngineSpec(CNNModel(params, cfg), method="occlusion",
                               precision=precision))
        twin = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                                method="occlusion", precision=precision))
        path = f"perturb_{precision}"
        totals = launches.setdefault(path, {})
        for method in PERTURB_METHODS:
            key = None if method == "occlusion" else seeds

            def run(batched=True, method=method, key=key):
                return eng.perturb(x, key, method=method, batched=batched)

            run()
            (logits, heat), rose = _count(run, totals)
            what = f"perturb {precision} {method}"
            _expect(rose, PER_PERTURB[precision], what)
            _finite(heat, what, (BATCH, 32, 32))
            _finite(logits, what, (BATCH, 10))
            logits_s, heat_s = run(batched=False)
            if precision == "fxp16":
                if not (torch.equal(heat, heat_s)
                        and torch.equal(logits, logits_s)):
                    fail(f"{what}: fold differs from the sequential path")
                fold_err = 0.0
            else:
                # The FC forward sums K in another order at N x 32 rows
                # than at 32 (vmm_splits; bf16: vmm_mma_plan's cluster),
                # so the fold's scores sit within the dot tolerance of the
                # logits' scale; occlusion's and RISE's heat averages
                # score differences and moves no further, LIME's ridge
                # solve may amplify them (REPLAY_TOL).
                tol = ((REPLAY_TOL if method == "lime" else DOT_TOL)
                       if precision == "f32" else BF16_TOL)
                scale = logits_s.float().abs().max().item()
                fold_err = max(
                    (heat - heat_s).abs().max().item(),
                    (logits.float() - logits_s.float()).abs().max().item()
                ) / scale
                if fold_err > tol:
                    fail(f"{what}: fold off the sequential path by "
                         f"{fold_err:.3g} of max|logits|")
            twin_err = check_perturb_twin(eng, twin, x, x_cpu, method,
                                          precision, seeds)
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
            seq_host = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(batched=False)
                torch.cuda.synchronize()
                seq_host.append(1e3 * (time.perf_counter() - t0))
            r = dict(n=PERTURB_N[method], fold_rows=PERTURB_N[method] * BATCH,
                     host_ms=statistics.median(host),
                     device_ms=_span_ms(run, reps=5),
                     seq_host_ms=statistics.median(seq_host),
                     seq_device_ms=_span_ms(lambda: run(batched=False),
                                            reps=2),
                     peak_bytes=_peak_bytes(run), fold_err=fold_err,
                     twin_heat_err=twin_err,
                     launches={k: v for k, v in rose.items() if v})
            results[f"{precision}/{method}"] = r
            print(f"  {what}: N {r['n']} ({r['fold_rows']} rows), "
                  f"{r['launches']}; batched {r['host_ms']:.3f} ms host / "
                  f"{r['device_ms']:.3f} ms device, sequential "
                  f"{r['seq_host_ms']:.1f} / {r['seq_device_ms']:.1f}; peak "
                  f"{r['peak_bytes'] / 2**20:.1f} MiB; fold vs sequential "
                  f"{fold_err:.3g} of max|logits|, heat vs the CPU's "
                  f"aggregation "
                  f"{twin_err:.3g} of max")
        check_path_launches(path, totals)

    # past gridDim.z: 67,200 rows in one fold, f32
    eng = build(EngineSpec(CNNModel(params, cfg), method="rise"))
    big = PERTURB_BIG_SAMPLES * BATCH

    def run_big():
        return eng.perturb(x, seeds, n_samples=PERTURB_BIG_SAMPLES)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (logits, heat), rose = _count(run_big, launches["perturb_f32"])
    peak = torch.cuda.max_memory_allocated() - base
    _expect(rose, PER_PERTURB["f32"], f"perturb f32 rise {big} rows")
    _finite(heat, f"perturb {big} rows", (BATCH, 32, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_big()
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0)
    ms = _perturb_masks("rise", seeds, PERTURB_BIG_SAMPLES, (32, 32), "cuda")
    masked = _masked_fold(x, ms.dense(), None).reshape(big, 32, 32, 3)
    fold = eng._fold_forward()
    whole = fold(masked)
    parts = torch.cat([fold(masked[:PERTURB_SLICE]),
                       fold(masked[PERTURB_SLICE:])])
    big_err = _rel_err(whole, parts)
    _finite(whole, f"fold of {big} rows", (big, 10))
    if big_err > DOT_TOL:
        fail(f"fold of {big} rows: logits off {PERTURB_SLICE}-row slices by "
             f"{big_err:.3g} of max")
    del masked, whole, parts
    torch.cuda.empty_cache()
    results["f32/rise_67200"] = dict(rows=big, host_ms=big_ms,
                                     peak_bytes=peak, slices_err=big_err)
    print(f"  perturb f32 rise, {PERTURB_BIG_SAMPLES} samples x {BATCH}: a "
          f"fold of {big} rows, {({k: v for k, v in rose.items() if v})}, "
          f"{big_ms:.1f} ms host, peak {peak / 2**30:.2f} GiB; logits vs "
          f"{PERTURB_SLICE}-row slices {big_err:.3g} of max")

    # served: never a cache hit, no backward kernel
    from repro_torch.serve.batcher import pad_size
    srv_eng = build(EngineSpec(CNNModel(params, cfg)))
    srv = ExplanationServer(CNNAdapter.from_engine(srv_eng),
                            max_batch=PERTURB_SERVE_BATCH, max_delay_s=0.0)
    pool = torch.randn((PERTURB_SERVE_N, 32, 32, 3),
                       generator=torch.Generator().manual_seed(3)).numpy()
    for i in range(PERTURB_SERVE_N):
        srv.submit(Request(uid=f"p{i}", kind="predict", x=pool[i]))
    srv.drain()
    per = PERTURB_SERVE_N // len(PERTURB_METHODS)
    reqs = [Request(uid=f"p{i}", kind="explain", x=pool[i],
                    method=PERTURB_METHODS[i // per],
                    key=None if i < per else 500 + i)
            for i in range(PERTURB_SERVE_N)]

    def serve():
        for r in reqs:
            srv.submit(r)
        return srv.drain()

    out, rose = _count(serve, {})
    want = {k: len(PERTURB_METHODS) * v
            for k, v in PER_PERTURB["f32"].items()}
    _expect(rose, want, "perturb served")
    if len(out) != PERTURB_SERVE_N or any(
            not r.ok or r.cache_hit for r in out):
        fail("perturb served: an error or a cache hit")
    if srv.cache.stats.hits or srv.cache.stats.misses:
        fail(f"perturb served: the cache was consulted "
             f"{srv.cache.stats.snapshot()}")
    by_uid = {r.uid: r for r in out}
    for m, method in enumerate(PERTURB_METHODS):
        ids = range(m * per, (m + 1) * per)
        if pad_size(per, PERTURB_SERVE_BATCH) != per:
            fail("perturb served: a padded batch")
        key = None if method == "occlusion" else [500 + i for i in ids]
        _, heat = srv_eng.perturb(pool[list(ids)], key, method=method)
        for j, i in enumerate(ids):
            rel = by_uid[f"p{i}"].relevance
            _finite(rel, f"perturb served {method}", (32, 32))
            if not torch.equal(rel, heat[j]):
                fail(f"perturb served {method} p{i}: differs from "
                     f"Engine.perturb of its batch")
    results["served"] = dict(n=PERTURB_SERVE_N, launches={
        k: v for k, v in rose.items() if v})
    print(f"  perturb served: {PERTURB_SERVE_N} explains in batches of "
          f"{PERTURB_SERVE_BATCH} ({per} a method), no cache hit or miss "
          f"counted, each bitwise Engine.perturb of its batch, "
          f"{results['served']['launches']}")

    # the kernel profiler: one f32 explain and one f32 RISE explain
    calls = {"f32 top-3 explain": lambda: srv_eng.explain(x, topk=SEEDS),
             "f32 rise explain": lambda: eng.perturb(x, seeds)}
    results["profiler"] = {}
    for what, fn in calls.items():
        by_family, n_calls = _profiled_ms(fn)
        results["profiler"][what] = dict(ms=by_family, calls=n_calls)
    return results, calls


# ---------------------------------------------------------------------------
# phase 12: the tile planner on the card
# ---------------------------------------------------------------------------

#: Phase 12's CNN for the edge-tiny fold audit: half the Table III widths,
#: whose plan fits edge-tiny's 1 MB at the spec's batch while a RISE fold
#: of 256 x 32 rows does not (the full widths do not fit it even at one
#: image: that build is checked too).
PLAN_TINY_CNN = dict(channels=(16, 16, 32, 32), fc=(64,))
#: ScanTiles phase 12 holds bitwise to the unplanned scan: 8, 16 and 32
#: channels a forward block, chunks of 4 to 128 steps (windows of 8 to 128
#: in the backward).
PLAN_SCAN_TILES = ((8, 4), (16, 8), (32, 64), (512, 128))
#: Rounds of phase 12's interleaved explain timings (the four engines in
#: a rotated order each round, 20 explains between events apiece).
PLAN_ROUNDS = 6


def _rule_entries(cfg, precision, batch, seeds):
    """Each launch's plan by today's launch rule (the kernels' own)."""
    from repro_torch.kernels.conv2d import conv2d as cv
    from repro_torch.kernels.vmm import vmm as vm
    from repro_torch.plan import cnn_kernel_shapes
    esize, bf16 = (4 if precision == "f32" else 2), precision == "bf16"
    out = {}
    for key, family, kw in cnn_kernel_shapes(cfg, batch, seeds):
        if family == "conv2d_fwd":
            a = (kw["n"], kw["h"], kw["w"], kw["cin"], kw["cout"], kw["k"])
            out[key] = (cv.conv_bf16_plan(*a) if bf16
                        else cv.conv_plan(*a, esize=esize))
        elif family == "conv2d_bwd":
            h, w = ((2 * kw["hg"], 2 * kw["wg"]) if kw["pooled"]
                    else (kw["hg"], kw["wg"]))
            a = (kw["s"], kw["n"], h, w, kw["c"], kw["cout"], kw["k"])
            out[key] = (cv.conv_bwd_bf16_plan(*a, pooled=kw["pooled"]) if bf16
                        else cv.conv_bwd_plan(*a, pooled=kw["pooled"],
                                              esize=esize))
        elif family == "vmm_fwd":
            out[key] = (vm.vmm_mma_plan if bf16 else vm.vmm_splits)(
                kw["m"], kw["k"], kw["n"])
        elif family == "vmm_bwd":
            out[key] = (vm.vmm_bwd_mma_plan if bf16 else vm.vmm_bwd_plan)(
                kw["s"], kw["m"], kw["k"], kw["n"])
    return out


def _held(what, got, want, precision):
    """An autotuned engine's output against the unplanned one: fxp16
    bitwise; f32 within DOT_TOL (logits) / REPLAY_TOL (relevance) of max;
    bf16 within BF16_TOL of max.  Returns the error relative to max."""
    if precision == "fxp16":
        if not torch.equal(got, want):
            fail(f"phase 12: {what} not bitwise the unplanned engine's")
        return 0.0
    err = _rel_err(got, want)
    tol = (BF16_TOL if precision == "bf16"
           else DOT_TOL if "logits" in what else REPLAY_TOL)
    if not err <= tol:
        fail(f"phase 12: {what} {err:.3e} of max from the unplanned "
             f"engine's, beyond {tol}")
    return err


def _counted(fn, launches=None):
    """``fn()`` with the launch counters set to 0 just before and read
    just after (into ``launches`` when given)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    if launches is not None:
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return out, got


def check_plan(params, cfg, x_cpu, launches, lm_state, work):
    """Phase 12: the tile planner on the card (see the module docstring);
    the tuning cache and the drift table go to the directory ``work``."""
    import os

    from repro_torch import plan as tplan
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import cnn
    from repro_torch.plan import planner as planner_lib

    prof = tplan.get_profile("h100")
    if tplan.get_profile("detected") != prof:
        fail("phase 12: 'detected' does not resolve to the card's profile")
    print(f"  h100 profile: {prof.card}, {prof.sms} SMs, shared memory "
          f"{prof.vmem_bytes} B a block / {prof.smem_per_sm} B an SM, "
          f"{prof.threads_per_sm} threads an SM; cache device "
          f"{prof.cache_device!r}")
    work.mkdir(parents=True, exist_ok=True)
    cache_path = work / "tileplans.json"
    if cache_path.exists():
        cache_path.unlink()
    measured = []
    real_measure = planner_lib.measure_kernel

    def counting_measure(*a):
        us = real_measure(*a)
        measured.append((a[0], us))
        return us

    planner_lib.measure_kernel = counting_measure
    # EngineSpec(autotune=True) reads and writes the default cache
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(cache_path)
    x = x_cpu.cuda()
    model = CNNModel(params, cfg, device="cuda")
    out = {}
    try:
        for precision in ("f32", "bf16", "fxp16"):
            out[precision] = _plan_precision(model, x, precision, launches,
                                             measured, cache_path)
            check_path_launches(f"plan_{precision}",
                                launches[f"plan_{precision}"])
        # the CLI: a batch-1 build, then a warm one that must hit fully
        for args, want in (((), 0), (("--expect-full-hit",), 0)):
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.plan", "--device",
                 "h100", "--autotune", "--cache", str(cache_path), *args],
                capture_output=True, text=True, timeout=600,
                cwd=ROOT, env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")))
            if r.returncode != want:
                fail(f"phase 12: python -m repro_torch.plan {args} exited "
                     f"{r.returncode}: {r.stderr[-2000:]}")
        print(f"  python -m repro_torch.plan --device h100 --autotune: "
              f"exit 0, then with --expect-full-hit exit 0 ("
              f"{r.stdout.strip().splitlines()[-1]})")
        out["lm"] = _plan_lm(lm_state, measured, cache_path)
    finally:
        planner_lib.measure_kernel = real_measure
        del os.environ["REPRO_TORCH_PLAN_CACHE"]

    # an edge profile audits: a fold its plan cannot hold raises before
    # any launch
    edge_cfg = cnn.CNNConfig(**PLAN_TINY_CNN)
    edge_params = cnn.init(torch.Generator().manual_seed(2), edge_cfg)
    eng = build(EngineSpec(CNNModel(edge_params, edge_cfg, device="cuda"),
                           method="rise", device="edge-tiny"))
    if eng.plan is None or eng.plan.device != "edge-tiny":
        fail("phase 12: the edge-tiny engine has no edge-tiny plan")
    _, ok = _counted(lambda: eng.perturb(x[:1], 7, n_samples=4))
    reset_launches()
    try:
        eng.perturb(x, 7)
    except tplan.InfeasiblePlanError as e:
        raised = str(e)
    else:
        fail("phase 12: edge-tiny's RISE fold of 256 x 32 rows ran")
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        fail(f"phase 12: the infeasible fold launched {dict(LAUNCHES)}")
    try:
        build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                         device="edge-tiny"))
    except tplan.InfeasiblePlanError as e:
        full = str(e)
    else:
        fail("phase 12: the Table III CNN's plan fits edge-tiny")
    if any(LAUNCHES.values()):
        fail("phase 12: an infeasible build launched")
    print(f"  edge-tiny ({edge_cfg.channels}, FC {edge_cfg.fc}): a RISE "
          f"explain of 4 x 1 rows runs ({sum(ok.values())} launches); the "
          f"fold of 256 x 32 raises before any launch: {raised[:90]}...; "
          f"the Table III widths raise at build: {full[:70]}...")
    out["edge_tiny"] = dict(fold_error=raised, build_error=full)

    # the drift table, from the served CNN's --profile-kernels
    drift_json = work / "drift.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "cnn", "--requests", "16", "--batch", str(BATCH), "--topk",
         str(SEEDS), "--profile-kernels", "--drift-out", str(drift_json)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if r.returncode != 0 or "cost-model drift (h100" not in r.stdout:
        fail(f"phase 12: --profile-kernels exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    rows = json.loads(drift_json.read_text())["rows"]
    if any(row["measured_us"] is None or row["drift"] is None
           or not row["est_us"] > 0 for row in rows):
        fail(f"phase 12: drift rows without a measurement: {rows}")
    back = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "drift", "--path",
         str(drift_json)], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if back.returncode != 0 or [line.split()[0] for line in
                                back.stdout.splitlines()[2:]] != [
                                    row["key"] for row in rows]:
        fail(f"phase 12: python -m repro_torch.obs drift read "
             f"{back.returncode}: {back.stdout[-1000:]}")
    print("  the served CNN's drift table (--profile-kernels, read back by "
          "python -m repro_torch.obs drift):")
    for line in back.stdout.splitlines():
        print("   ", line)
    out["drift"] = rows
    return out


def _plan_precision(model, x, precision, launches, measured, cache_path):
    """Phase 12 items 1-5 for one precision."""
    import dataclasses

    from repro_torch import plan as tplan
    from repro_torch.engine import (CNNModel, EngineSpec, TopK, build,
                                    clear_cache)
    cfg = model.cfg
    analytic = tplan.plan_cnn(cfg, device="h100", precision=precision,
                              batch=BATCH, seeds=SEEDS)
    rules = _rule_entries(cfg, precision, BATCH, SEEDS)
    if dict(analytic.entries) != rules:
        fail(f"phase 12 ({precision}): the analytic h100 plan is not the "
             f"launch rules: {analytic.entries} vs {rules}")
    spec = EngineSpec(model, method="saliency", precision=precision,
                      targets=TopK(SEEDS), batch=BATCH)
    base = build(spec)
    ana = build(dataclasses.replace(spec, device="h100"))
    (bl, br), base_launches = _counted(lambda: base.explain(x))
    (al, ar), ana_launches = _counted(lambda: ana.explain(x))
    if not (torch.equal(al, bl) and torch.equal(ar, br)):
        fail(f"phase 12 ({precision}): the analytic-plan engine is not "
             f"bitwise the unplanned one")
    if ana_launches != base_launches:
        fail(f"phase 12 ({precision}): launches {ana_launches} vs "
             f"{base_launches}")
    # the autotuned engine, on a fresh cache
    measured.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tuned = build(dataclasses.replace(spec, device="h100", autotune=True))
    build_s = time.perf_counter() - t0
    n_measured = len(measured)
    if not n_measured:
        fail(f"phase 12 ({precision}): the autotuned build measured nothing")
    stored = json.loads(cache_path.read_text())
    dims = {key: [int(v) for v in kw.values()]
            for key, _, kw in tplan.cnn_kernel_shapes(cfg, BATCH, SEEDS)}
    entries = []
    for key, tile in tuned.plan.entries:
        family = next(f for k, f, _ in tplan.cnn_kernel_shapes(
            cfg, BATCH, SEEDS) if k == key)
        ck = tplan.cache_key(family, dims[key],
                             tplan.planner.PLAN_DTYPES[precision], precision,
                             tplan.get_profile("h100").cache_device)
        e = stored[ck]
        moved = tile != rules[key]
        entries.append(dict(key=key, rule=str(rules[key]), chosen=str(tile),
                            rule_us=e["rule_us"], chosen_us=e["measured_us"],
                            moved=moved))
        print(f"  {precision} {key:10s} rule {e['rule_us']:8.2f} us "
              f"{rules[key]}" + (f" -> {e['measured_us']:8.2f} us {tile}"
                                 if moved else " (kept)"))
    path = f"plan_{precision}"
    launches[path] = {}
    (tl, tr), tuned_launches = _counted(lambda: tuned.explain(x),
                                        launches[path])
    if tuned_launches != base_launches:
        fail(f"phase 12 ({precision}): the autotuned engine launched "
             f"{tuned_launches}, the unplanned one {base_launches}")
    logit_err = _held(f"{precision} logits", tl, bl, precision)
    rel_err = _held(f"{precision} relevance", tr, br, precision)
    # the warm build: a 100 % cache hit, no measurement
    clear_cache()
    measured.clear()
    warm_cache = tplan.TuningCache(str(cache_path))
    warm = tplan.plan_cnn(cfg, device="h100", precision=precision,
                          batch=BATCH, seeds=SEEDS, autotune=True,
                          cache=warm_cache)
    again = build(dataclasses.replace(spec, device="h100", autotune=True))
    if (measured or warm_cache.misses or warm_cache.hits != len(warm)
            or warm != tuned.plan or again.plan != tuned.plan):
        fail(f"phase 12 ({precision}): the warm build measured "
             f"{len(measured)} or missed {warm_cache.misses}")
    # device ms, interleaved: PLAN_ROUNDS rounds, the order turned each;
    # a second unplanned engine, on its own copy of the weights, gives the
    # spread between two engines making the same launches
    twin_params = {k: [dict(p) for p in v] for k, v in model.params.items()}
    engines = {"unplanned": base, "unplanned twin": build(
        dataclasses.replace(spec, model=CNNModel(twin_params, cfg,
                                                 device="cuda"))),
        "analytic": ana, "autotuned": tuned}
    times = {name: [] for name in engines}
    names = list(engines)
    for r in range(PLAN_ROUNDS):
        for name in names[r % 4:] + names[:r % 4]:
            eng = engines[name]
            times[name].append(device_time_ms(lambda: eng.explain(x),
                                              reps=20))
    ms = {k: statistics.median(v) for k, v in times.items()}
    host = {}
    for name, eng in engines.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.explain(x)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        host[name] = statistics.median(runs)
    print(f"  {precision}: analytic plan = the rules, its engine bitwise "
          f"the unplanned one; autotuned build {build_s:.2f} s "
          f"({n_measured} measurements), {sum(e['moved'] for e in entries)}"
          f" of {len(entries)} entries off the rule, logits "
          f"{logit_err:.2e} / relevance {rel_err:.2e} of max from the "
          f"unplanned; warm build: {warm_cache.hits} hits, 0 misses, 0 "
          f"measurements; explain device ms (median of {PLAN_ROUNDS}) "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + "; host ms " + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
          + f" ({times})")
    return dict(entries=entries, build_s=build_s, n_measured=n_measured,
                logits_err=logit_err, relevance_err=rel_err,
                device_ms=ms, device_ms_runs=times, host_ms=host,
                launches=tuned_launches)


def _plan_lm(lm_state, measured, cache_path):
    """Phase 12 item 6: plan_lm on falcon-mamba-7b FULL, and per-token
    explains under planned scan knobs against the unplanned one."""
    from repro_torch import lm
    from repro_torch import plan as tplan
    params, cfg, res = lm_state
    s_full = LM_PROMPT + LM_NEW
    measured.clear()
    t0 = time.perf_counter()
    tuned = tplan.plan_lm(cfg, device="h100", precision="bf16",
                          batch=LM_BATCH, seq=s_full, autotune=True,
                          cache=tplan.TuningCache(str(cache_path)))
    build_s = time.perf_counter() - t0
    analytic = tplan.plan_lm(cfg, device="h100", precision="bf16",
                             batch=LM_BATCH, seq=s_full)
    rule = tplan.ScanTile(cfg.d_inner, cfg.ssm_chunk)
    if set(dict(analytic.entries).values()) != {rule}:
        fail(f"phase 12 (lm): the analytic plan is not the unplanned "
             f"launch: {analytic.summary()}")
    t, pos = LM_NEW - 1, LM_PROMPT + LM_NEW - 2
    per_explain = {"selective_scan": cfg.n_layers,
                   "selective_scan_bwd": cfg.n_layers}

    def explain(plan):
        step = lm.make_token_explain(cfg, mode="contrastive", plan=plan)
        return _counted(lambda: step(params, res.tokens, pos,
                                     res.tokens[:, pos + 1],
                                     res.runners_up[:, t]))

    base, base_launches = explain(None)
    if base_launches != per_explain:
        fail(f"phase 12 (lm): unplanned launches {base_launches}")
    rows = []
    knobs = [("analytic", analytic), ("autotuned", tuned)] + [
        (f"ScanTile{dt}", tplan.TilePlan(
            "h100", "bf16", tuple((k, tplan.ScanTile(*dt))
                                  for k in analytic.keys())))
        for dt in PLAN_SCAN_TILES]
    for name, plan in knobs:
        got, n = explain(plan)
        if n != base_launches:
            fail(f"phase 12 (lm): {name} launched {n}, unplanned "
                 f"{base_launches}")
        err = _rel_err(got, base)
        if not err <= LM_ROUTE_TOL:
            fail(f"phase 12 (lm): {name} scores {err:.3e} of max from the "
                 f"unplanned explain, beyond {LM_ROUTE_TOL}")
        rows.append(dict(plan=name, tile=str(plan.get("ssm0.scan")),
                         bitwise=bool(torch.equal(got, base)), err=err))
    if not rows[0]["bitwise"]:
        fail("phase 12 (lm): the analytic plan's explain is not bitwise")
    print(f"  lm: plan_lm({cfg.name} FULL, h100, bf16, B {LM_BATCH}, S "
          f"{s_full}) autotuned in {build_s:.2f} s ({len(measured)} "
          f"measurements): ssm0.scan {tuned.get('ssm0.scan')} (rule "
          f"{rule}); per-token explains, {cfg.n_layers} B13 + "
          f"{cfg.n_layers} B13 bwd launches each, against the unplanned: "
          + "; ".join(f"{r['plan']} {r['tile']} "
                      + ("bitwise" if r["bitwise"] else f"{r['err']:.2e}")
                      for r in rows))
    return dict(build_s=build_s, n_measured=len(measured),
                tuned=str(tuned.get("ssm0.scan")), rows=rows)


def print_profiler_vs_cupti(results, calls):
    """The KernelProfiler's fenced ms per wrapper call, by family, beside
    CUPTI's kernel ms per call of the same calls (read last: a profiler
    session slows what runs after it).  "other" (B2, PyTorch's own
    kernels) has no profiled call site: its CUPTI ms a whole call."""
    cupti = cupti_by_family(list(calls.values()))
    for i, what in enumerate(calls):
        prof = results["profiler"][what]
        cu = None if cupti is None else cupti[i]
        prof["cupti_ms"] = cu
        parts = []
        for fam in PROFILE_FAMILIES:
            n = prof["calls"].get(fam, 0)
            if n == 0 and not (cu and fam in cu):
                continue
            fenced = ("-" if n == 0
                      else f"{prof['ms'][fam] / n:.4f}")
            kernel = ("not measured" if cu is None
                      else f"{cu.get(fam, 0.0) / max(n, 1):.4f}")
            parts.append(f"{fam} x{n} {fenced} / {kernel}")
        print(f"  {what}: family x wrapper calls: KernelProfiler fenced ms "
              f"/ CUPTI kernel ms, a wrapper call: " + "; ".join(parts))


# ---------------------------------------------------------------------------
# phase 13: the rest of the LM zoo (attention, RoPE, FFN, MoE; hymba on B13)
# ---------------------------------------------------------------------------

#: Phase 13's configs in the order they run, the slice's main path
#: (hymba-1.5b, whose 32 hybrid layers scan through B13) first.  Depth is
#: cut only where the bf16 weights would pass 16 GB (scout's 108 B
#: parameters need four cards: ROADMAP A12).
ZOO_ARCHS = ("hymba-1.5b", "llama3.2-1b", "qwen2-1.5b", "phi4-mini-3.8b",
             "internlm2-20b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
             "seamless-m4t-medium", "llava-next-mistral-7b")
ZOO_DEPTH = {"internlm2-20b": 16, "moonshot-v1-16b-a3b": 12,
             "llama4-scout-17b-a16e": 2}
#: seamless's source frames on the explain (llava's 576 patches are its
#: config's ``n_patches``)
ZOO_FRAMES = 64
#: Phase 13's f32 twins, one a family, at depth 2 on batch 2 x 32 tokens
#: against the CPU: logits within DOT_TOL, ixg scores within REPLAY_TOL
#: of max, and on the card contrastive = ixg(a) - ixg(b) within
#: REPLAY_TOL.  ``residual_policy="exact"``: the int8 codes of the smooth
#: gates may land one step apart on the two devices (phase 8), which is
#: not what these twins hold.
ZOO_TWINS = ("qwen2-1.5b", "moonshot-v1-16b-a3b", "hymba-1.5b",
             "seamless-m4t-medium", "llava-next-mistral-7b")
#: The same five twins in bf16 (the dtype the explains above run in, so a
#: fault of a bf16 path on the card shows), on the CPU's top two targets.
#: The last-position logits and the embedding gradients of a contrastive
#: and an ixg seed are compared with the f32 evaluation of the same weights
#: on the CPU: the card's distance from it within LM_LOGITS_FACTOR times
#: the CPU bf16 twin's own (the card rounds no worse than the CPU).  Their
#: scores, sums over d that cancel (one bf16 step apart anywhere in the
#: backward moves them by several % of max |score|, by chance more on one
#: device than the other), within ZOO_BF16_SCORES_TOL of max sum_d |rel*e|
#: of the CPU bf16 twin's: the scale of a bf16 sum's rounding error.
ZOO_BF16_SCORES_TOL = 5e-2


def _zoo_inputs(cfg, batch, seq, gen, device):
    """Tokens, and the vlm's patches or the encoder-decoder's frames."""
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                   device=device)}
    if cfg.frontend == "patches":
        out["patches"] = torch.randn(batch, cfg.n_patches, cfg.d_model,
                                     generator=gen, device=device)
    if cfg.enc_layers:
        out["frames"] = torch.randn(batch, ZOO_FRAMES, cfg.d_model,
                                    generator=gen, device=device)
    return out


def _host_and_span(fn, reps=3):
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(host), _span_ms(fn, reps=reps)


def _zoo_f32_checks(params, cfg, res, frames):
    """The contrastive seed against the ixg difference (and, on hybrid
    stacks, the scores through B13's backward against autograd over the
    chunked scan) on the same weights widened to f32, full depth, within
    REPLAY_TOL of max.

    In bf16 both comparisons measure rounding, not the property: the
    backward through attention (the bf16 ``p`` of ``p @ v`` into the
    softmax's cancelling backward) and through hymba's per-branch norms
    amplifies where two computations round their cotangents.  On the card
    the bf16 contrastive seed sat 0.015 (llama3.2, 16 layers) to 0.22
    (llava, 32) and 0.34 (hymba) of max from the ixg difference, hymba's
    B13 backward 0.18 from autograd over the chunked scan, and the bf16
    twins (:func:`check_zoo_twin_bf16`) print the CPU's bf16 explain as
    far from linear as the card's.  In f32 the same comparisons read
    1e-5.  The bf16 path itself is held by the bf16 twins and, on hymba,
    each layer's B13 backward by :func:`_b13_bwd_layer_errs`."""
    from repro_torch.tree import tree_map
    from repro_torch import lm
    from repro_torch.models import transformer as tf
    t, pos = LM_NEW - 1, LM_PROMPT + LM_NEW - 2
    ta, tb = res.tokens[:, pos + 1], res.runners_up[:, t]
    p32 = tree_map(lambda v: v.float(), params)
    c32 = cfg.with_(dtype="float32")
    con32 = lm.make_token_explain(c32, mode="contrastive")
    ixg32 = lm.make_token_explain(c32, mode="ixg")

    def explain32():
        return con32(p32, res.tokens, pos, ta, tb, frames)

    base = explain32()
    out = dict(linearity_err_f32=_rel_err(
        base, ixg32(p32, res.tokens, pos, ta, None, frames)
        - ixg32(p32, res.tokens, pos, tb, None, frames)))
    if cfg.family == "hybrid":
        out["route_err_f32"] = _rel_err(base, _through_chunked_grad(
            explain32))
    del p32, base
    torch.cuda.empty_cache()
    bad = {k: v for k, v in out.items() if not v <= REPLAY_TOL}
    if bad:
        fail(f"lm zoo {cfg.name} f32: {bad} of max, beyond {REPLAY_TOL}")
    return out


def check_zoo_arch(arch, launches, to_profile):
    """One config of phase 13 at full width in bf16: greedy decode twice,
    contrastive ``explain_generated``, contrastive vs the ixg difference,
    an engine explain with the modality inputs, times; hymba also B13's
    launches, its route against the chunked scan, a planned explain and
    an LMAdapter server.  Returns the config's results."""
    from repro_torch.tree import leaves
    from repro_torch import configs, lm
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.models import transformer as tf

    full = configs.get(arch)
    cfg = full.with_(n_layers=ZOO_DEPTH.get(arch, full.n_layers))
    hybrid = cfg.family == "hybrid"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tf.init(cfg, generator=torch.Generator(device="cuda")
                     .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = _zoo_inputs(cfg, LM_BATCH, LM_PROMPT, gen, "cuda")
    prompts = inputs["tokens"]
    frames = inputs.get("frames")
    cut = ("" if cfg.n_layers == full.n_layers else
           f", depth cut to {cfg.n_layers} of {full.n_layers}")
    print(f"  {arch}{cut}: {n_params / 1e9:.3f} B parameters "
          f"({cfg.param_count() / 1e9:.3f} B analytic), "
          f"{n_params * 2 / 1e9:.2f} GB bf16, drawn in {init_s:.1f} s")
    totals = launches.setdefault("lm_zoo", {})
    per_explain = ({"selective_scan": cfg.n_layers,
                    "selective_scan_bwd": cfg.n_layers} if hybrid else {})
    what = f"lm zoo {arch}"

    res, rose = _count(lambda: lm.decode(params, cfg, prompts,
                                         max_new=LM_NEW), totals)
    _expect(rose, {}, f"{what} decode")
    again = lm.decode(params, cfg, prompts, max_new=LM_NEW)
    if not torch.equal(again.tokens, res.tokens):
        fail(f"{what}: a second greedy decode gave other tokens")
    s_full = LM_PROMPT + LM_NEW
    if tuple(res.tokens.shape) != (LM_BATCH, s_full) or bool(
            (res.generated == res.runners_up).any()):
        fail(f"{what}: decode result malformed")

    scores, rose = _count(lambda: lm.explain_generated(
        params, cfg, res, frames=frames), totals)
    _expect(rose, {k: v * LM_NEW for k, v in per_explain.items()},
            f"{what} explain_generated")
    _finite(scores, f"{what} per-token scores", (LM_BATCH, LM_NEW, s_full))
    for t in range(LM_NEW):
        if not bool((scores[:, t, LM_PROMPT + t:] == 0).all()):
            fail(f"{what}: scores after the seed of token {t} are not 0")
        if not bool((scores[:, t, :LM_PROMPT + t] != 0).any()):
            fail(f"{what}: token {t} has no relevance before its seed")

    t, pos = LM_NEW - 1, LM_PROMPT + LM_NEW - 2
    ixg = lm.make_token_explain(cfg, mode="ixg")
    (sa, sb), rose = _count(lambda: (
        ixg(params, res.tokens, pos, res.tokens[:, pos + 1], None, frames),
        ixg(params, res.tokens, pos, res.runners_up[:, t], None, frames)),
        totals)
    _expect(rose, {k: 2 * v for k, v in per_explain.items()},
            f"{what} ixg explains")
    lin_err = ((scores[:, t] - (sa - sb)).abs().max().item()
               / max(sa.abs().max().item(), sb.abs().max().item()))
    f32 = _zoo_f32_checks(params, cfg, res, frames)

    eng = build(EngineSpec(LMModel(params, cfg)))
    (lg, sc), rose = _count(lambda: eng.explain_tokens(inputs), totals)
    _expect(rose, per_explain, f"{what} engine explain")
    s_in = LM_PROMPT + (cfg.n_patches if cfg.frontend == "patches" else 0)
    _finite(lg, f"{what} engine logits", (LM_BATCH, cfg.vocab))
    _finite(sc, f"{what} engine scores", (LM_BATCH, s_in))

    cache = tf.init_cache(cfg, LM_BATCH, s_full, device="cuda")
    with torch.no_grad():
        (_, cache), rose = _count(lambda: tf.prefill(
            params, cfg, {"tokens": res.tokens[:, :-1]}, cache), {})
    _expect(rose, {}, f"{what} prefill")
    last = res.tokens[:, -1:]

    def step():
        with torch.no_grad():
            tf.decode_step(params, cfg, last, cache, s_full - 1)

    contrastive = lm.make_token_explain(cfg, mode="contrastive")

    def token_explain():
        return contrastive(params, res.tokens, pos, res.tokens[:, pos + 1],
                           res.runners_up[:, t], frames)

    times = {}
    for name, fn in (("decode step", step),
                     (f"per-token explain (S={s_full})", token_explain),
                     (f"engine explain (S={s_in})",
                      lambda: eng.explain_tokens(inputs))):
        host, dev = _host_and_span(fn)
        times[name] = dict(host_ms=host, device_ms=dev)
    print(f"    decode x2 equal; {LM_NEW} per-token explains + 2 ixg + 1 "
          f"engine explain, causal zeros exact; contrastive vs ixg "
          f"difference {lin_err:.2e} in bf16 (not held: see "
          f"_zoo_f32_checks), {f32['linearity_err_f32']:.2e} in f32"
          + (f"; scores through the B13 backward vs autograd over the "
             f"chunked scan {f32['route_err_f32']:.2e} in f32" if hybrid
             else "")
          + "; host / device-span ms: "
          + "; ".join(f"{k} {v['host_ms']:.2f} / {v['device_ms']:.2f}"
                      for k, v in times.items()))
    out = dict(n_layers=cfg.n_layers, full_layers=full.n_layers,
               n_params=n_params, init_s=init_s, linearity_err_bf16=lin_err,
               times=times, **f32, peak_gib=torch.cuda.max_memory_allocated()
               / 2**30)
    print(f"    peak device memory {out['peak_gib']:.1f} GiB (the f32 "
          f"copy included)")
    if hybrid:
        out.update(_check_zoo_hybrid(params, cfg, res, prompts, eng, lg,
                                     token_explain, totals, to_profile,
                                     times))
    return out


def _check_zoo_hybrid(params, cfg, res, prompts, eng, lg, token_explain,
                      totals, to_profile, times):
    """hymba-1.5b: each layer's B13 against the chunked scan and, in one
    per-token explain, each layer's bf16 B13 backward against the plain
    reverse recurrence on its own operands, the explain's
    logits against the chunked route's own bf16 error, one per-token
    explain through the B13 backward against autograd over the chunked
    scan (printed; held in f32 by :func:`_zoo_f32_checks`), an analytic
    ``h100``
    ``plan_lm`` explain bitwise the unplanned one, and an LMAdapter server
    (phase 7b's checks)."""
    from repro_torch import lm
    from repro_torch import plan as tplan
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        ref = tf.forward(params, cfg, {"tokens": prompts})[0][:, -1]
    ref32 = _f32_last_logits(params, cfg, prompts)
    logit_err, chunk_err = _rel_err(lg, ref), _rel_err(ref, ref32)
    if not logit_err <= LM_LOGITS_FACTOR * chunk_err:
        fail(f"hymba: B13-route logits vs the chunked scan's "
             f"{logit_err:.3e} of max|logit|, beyond {LM_LOGITS_FACTOR} x "
             f"the chunked route's bf16 error {chunk_err:.3e}")
    layer_errs = _b13_layer_errs(params, cfg, prompts)
    bwd_errs = _b13_bwd_layer_errs(token_explain, cfg.n_layers)
    route_bf16 = _rel_err(token_explain(), _through_chunked_grad(
        token_explain))
    s_full = LM_PROMPT + LM_NEW
    t, pos = LM_NEW - 1, LM_PROMPT + LM_NEW - 2
    analytic = tplan.plan_lm(cfg, device="h100", precision="bf16",
                             batch=LM_BATCH, seq=s_full)
    rule = tplan.ScanTile(cfg.d_inner, cfg.ssm_chunk)
    if set(dict(analytic.entries).values()) != {rule}:
        fail(f"hymba: the analytic plan is not the unplanned launch: "
             f"{analytic.summary()}")
    planned = lm.make_token_explain(cfg, mode="contrastive", plan=analytic)
    per_explain = {"selective_scan": cfg.n_layers,
                   "selective_scan_bwd": cfg.n_layers}
    got, rose = _count(lambda: planned(params, res.tokens, pos,
                                       res.tokens[:, pos + 1],
                                       res.runners_up[:, t]), totals)
    _expect(rose, per_explain, "hymba planned explain")
    if not torch.equal(got, token_explain()):
        fail("hymba: the analytic h100 plan's explain is not bitwise the "
             "unplanned one")
    to_profile.append(("hymba per-token explain", token_explain,
                       times[f"per-token explain (S={s_full})"]
                       ["device_ms"]))
    print(f"    hymba: {cfg.n_layers} B13 and {cfg.n_layers} B13 bwd "
          f"launches per explain, none in prefill or decode; B13 vs the "
          f"chunked scan in each layer's forward: max|dy| "
          f"{max(layer_errs):.2e}; each layer's bf16 B13 backward in the "
          f"explain vs the plain recurrence on its operands: max|d| "
          f"{max(bwd_errs):.2e}; B13 vs chunked logits {logit_err:.2e} of "
          f"max (chunked vs f32 weights {chunk_err:.2e}); scores through "
          f"the B13 backward vs autograd over the chunked scan "
          f"{route_bf16:.2e} of max in bf16 (not held: see "
          f"_zoo_f32_checks); plan_lm(h100) {len(analytic.entries)} "
          f"entries = the rule {rule}, its explain bitwise")
    print(f"  phase 13 lm serve: an LMAdapter server on {cfg.name}, "
          f"max_batch {LM_BATCH}")
    serve = check_serve_lm(params, cfg, prompts)
    return dict(logits_vs_chunked=logit_err, chunked_vs_f32=chunk_err,
                layer_errs=layer_errs, bwd_layer_errs=bwd_errs,
                route_err_bf16=route_bf16,
                serve=serve)


def check_zoo_twin(arch):
    """One f32 twin: ``FULL.with_(n_layers=2, dtype="float32",
    residual_policy="exact")`` explained on the card and on the CPU with
    the same parameters; the MoE's routing (expert ids, each slot's token)
    recorded on both devices and equal."""
    from repro_torch import configs
    from repro_torch.engine import EngineSpec, LMModel, build
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = configs.get(arch).with_(n_layers=2, dtype="float32",
                                  residual_policy="exact")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    card = tf.params_to(params, "cuda")
    inputs = _zoo_inputs(cfg, LM_TWIN_BATCH, LM_TWIN_SEQ,
                         torch.Generator().manual_seed(2), "cpu")
    routes = {"cuda": [], "cpu": []}
    real = moe.dispatch

    def spy(ids, c_, c):
        out = real(ids, c_, c)
        routes[ids.device.type].append((ids.cpu(), out[0].cpu()))
        return out

    moe.dispatch = spy
    try:
        lg, sc = build(EngineSpec(LMModel(card, cfg))).explain_tokens(
            {k: v.cuda() for k, v in inputs.items()})
        lg_c, sc_c = build(EngineSpec(LMModel(params, cfg, device="cpu"))
                           ).explain_tokens(inputs)
    finally:
        moe.dispatch = real
    lerr, serr = _rel_err(lg.cpu(), lg_c), _rel_err(sc.cpu(), sc_c)
    if not (lerr <= DOT_TOL and serr <= REPLAY_TOL):
        fail(f"lm zoo twin {arch}: logits {lerr:.3e}, ixg scores {serr:.3e} "
             f"of max")
    from repro_torch import lm
    toks = inputs["tokens"].cuda()
    frames = inputs["frames"].cuda() if "frames" in inputs else None
    top = lg.float().argsort(dim=-1, descending=True)
    args = (card, toks, LM_TWIN_SEQ - 1)
    con = lm.make_token_explain(cfg, mode="contrastive")(
        *args, top[:, 0], top[:, 1], frames)
    ixg = lm.make_token_explain(cfg, mode="ixg")
    lin = _rel_err(con, ixg(*args, top[:, 0], None, frames)
                   - ixg(*args, top[:, 1], None, frames))
    if not lin <= REPLAY_TOL:
        fail(f"lm zoo twin {arch}: contrastive vs ixg(a) - ixg(b) "
             f"{lin:.3e} of max")
    same = len(routes["cuda"]) == len(routes["cpu"]) and all(
        torch.equal(a, b) for (ia, ta), (ib, tb) in zip(routes["cuda"],
                                                        routes["cpu"])
        for a, b in ((ia, ib), (ta, tb)))
    if not same:
        fail(f"lm zoo twin {arch}: the MoE routing differs card vs CPU")
    moe_note = (f"; routing of {len(routes['cpu'])} MoE layer(s) equal"
                if routes["cpu"] else "")
    print(f"  twin {arch} (depth 2, f32, {LM_TWIN_BATCH} x {LM_TWIN_SEQ}"
          + (f" + {cfg.n_patches} patches" if cfg.frontend == "patches"
             else "")
          + (f" + {ZOO_FRAMES} frames" if cfg.enc_layers else "")
          + f"): logits {lerr:.2e}, ixg scores {serr:.2e} of max, "
          f"contrastive vs ixg difference {lin:.2e}{moe_note}")
    return dict(logits_err=lerr, scores_err=serr, linearity_err=lin,
                moe_layers=len(routes["cpu"]))


def _token_relevance(params, cfg, batch, ta, tb):
    """Last-position logits; the embedding gradient and scores of a
    contrastive (``ta`` vs ``tb``) and an ixg (``ta``) seed there; and the
    contrastive scores' distance from ixg(a) - ixg(b) of max; and the
    embeddings; through the explain's own route (B13's knobs on hybrid
    stacks)."""
    from repro_torch.engine import methods as engine_methods
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    h = tf.embed_inputs(params, cfg, batch)
    tiles = steps.ssm_scan_tiles(cfg)

    def f(e):
        return tf.forward_from_embeddings(params, cfg, e,
                                          enc_frames=batch.get("frames"),
                                          scan_tiles=tiles)[0]

    lg, rel_c, sc_c = engine_methods.attribute_tokens_contrastive(
        f, h, target_a=ta, target_b=tb)
    _, rel_a, sc_a = engine_methods.attribute_tokens(f, h, target=ta)
    sc_b = engine_methods.attribute_tokens(f, h, target=tb)[2]
    return ({"logits": lg[:, -1], "contrastive gradient": rel_c,
             "contrastive scores": sc_c, "ixg gradient": rel_a,
             "ixg scores": sc_a}, _rel_err(sc_c, sc_a - sc_b), h)


def check_zoo_twin_bf16(arch):
    """One bf16 twin: ``FULL.with_(n_layers=2, dtype="bfloat16",
    residual_policy="exact")`` on the card and on the CPU with the same
    parameters, seeded on the CPU's top two logits (a near tie cannot
    pick other targets on the card), and the same weights widened to f32
    on the CPU: logits and
    gradients on the card within LM_LOGITS_FACTOR times the CPU bf16
    twin's distance from the f32 ones, scores within ZOO_BF16_SCORES_TOL
    of max sum_d |rel*e| of the CPU bf16 twin's.  Each device's bf16
    linearity printed."""
    from repro_torch.tree import tree_map
    from repro_torch import configs
    from repro_torch.engine import methods as engine_methods
    from repro_torch.models import transformer as tf

    cfg = configs.get(arch).with_(n_layers=2, dtype="bfloat16",
                                  residual_policy="exact")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    batch = _zoo_inputs(cfg, LM_TWIN_BATCH, LM_TWIN_SEQ,
                        torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        at = tf.forward(params, cfg, batch)[0][:, -1]
    top = engine_methods.top_k(at.float(), 2)
    ta, tb = top[:, 0], top[:, 1]
    exact, _, _ = _token_relevance(tree_map(lambda v: v.float(),
                                                params),
                                   cfg.with_(dtype="float32"), batch, ta, tb)
    cpu, lin_cpu, e_cpu = _token_relevance(params, cfg, batch, ta, tb)
    dev, lin_dev, _ = _token_relevance(
        tf.params_to(params, "cuda"), cfg,
        {k: v.cuda() for k, v in batch.items()}, ta.cuda(), tb.cuda())
    out = {k: dict(card=_rel_err(dev[k].cpu(), v),
                   cpu=_rel_err(cpu[k], v)) for k, v in exact.items()}
    bad = [k for k, v in out.items() if "scores" not in k
           and not v["card"] <= LM_LOGITS_FACTOR * v["cpu"]]
    for mode in ("contrastive", "ixg"):
        terms = (cpu[f"{mode} gradient"].float() * e_cpu.float()).abs().sum(
            -1).max().item()
        sc = out[f"{mode} scores"]
        sc["card_vs_cpu_of_terms"] = (dev[f"{mode} scores"].cpu().float()
                                      - cpu[f"{mode} scores"].float()).abs(
                                      ).max().item() / terms
        if not sc["card_vs_cpu_of_terms"] <= ZOO_BF16_SCORES_TOL:
            bad.append(f"{mode} scores")
    out.update(linearity_card=lin_dev, linearity_cpu=lin_cpu)
    print(f"  twin {arch} (depth 2, bf16, {LM_TWIN_BATCH} x {LM_TWIN_SEQ}"
          + (f" + {cfg.n_patches} patches" if cfg.frontend == "patches"
             else "")
          + (f" + {ZOO_FRAMES} frames" if cfg.enc_layers else "")
          + "), card / CPU bf16 distance from f32 of max: "
          + "; ".join(f"{k} {v['card']:.2e} / {v['cpu']:.2e}"
                      for k, v in out.items() if k in exact)
          + "; scores card vs CPU of max sum|rel*e|: " + ", ".join(
              f"{m} {out[m + ' scores']['card_vs_cpu_of_terms']:.2e}"
              for m in ("contrastive", "ixg"))
          + f"; contrastive vs ixg(a) - ixg(b): card {lin_dev:.2e}, CPU "
          f"{lin_cpu:.2e} of max")
    if bad:
        fail(f"lm zoo bf16 twin {arch}: {bad} beyond {LM_LOGITS_FACTOR} x "
             f"the CPU's bf16 distance from f32 (scores: "
             f"{ZOO_BF16_SCORES_TOL} of max sum|rel*e|): {out}")
    return out


def check_moe_determinism():
    """moonshot-v1-16b-a3b's MoE at full width (64 experts, top 6, a
    shared pair, bf16): forward and backward (input, router and expert
    gradients) on 4 x 72 tokens twice, the same bits."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get("moonshot-v1-16b-a3b")
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(LM_BATCH, LM_PROMPT + LM_NEW, cfg.d_model, generator=gen,
                    device="cuda").to(cfg.torch_dtype)
    seed = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)

    def run():
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()
                  if k != "shared"}
        xx = x.detach().requires_grad_()
        y, aux = moe.moe_ffn(dict(p, **leaves), xx, cfg, method="saliency")
        grads = torch.autograd.grad((y.float() * seed.float()).sum() + aux,
                                    [xx] + list(leaves.values()))
        return [y, aux] + list(grads)

    first, second = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("moe: the forward or backward differs between two calls")
    print(f"  moe determinism: moonshot's MoE at full width, {LM_BATCH} x "
          f"{LM_PROMPT + LM_NEW} tokens, forward and backward (x, router, "
          f"w1, w2, w3) bitwise on two calls")


def check_lm_zoo(launches, to_profile):
    """Phase 13: every config of the zoo but falcon-mamba at full width in
    bf16 (``ZOO_DEPTH``'s cuts), hymba-1.5b's B13 path, the five twins in
    f32 and in bf16, the MoE's determinism."""
    results, failed = {"archs": {}, "twins": {}, "twins_bf16": {}}, []

    def each(group, arch, fn):
        # a config that fails is reported, and the others still run; the
        # engines built on a config's weights (the build cache keeps
        # them) go before the next config is drawn
        from repro_torch.engine import clear_cache
        try:
            results[group][arch] = fn(arch)
        except AssertionError as e:
            failed.append(str(e))
            print(f"  {arch}: FAILED: {e}")
        clear_cache()
        torch.cuda.empty_cache()

    for arch in ZOO_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        each("archs", arch, lambda a: check_zoo_arch(a, launches,
                                                     to_profile))
    for arch in ZOO_TWINS:
        each("twins", arch, check_zoo_twin)
    for arch in ZOO_TWINS:
        each("twins_bf16", arch, check_zoo_twin_bf16)
    check_moe_determinism()
    torch.cuda.empty_cache()
    if failed:
        fail(f"phase 13: {len(failed)} config(s) failed: " + " | ".join(
            failed))
    return results


# ---------------------------------------------------------------------------
# phase 14: training on the card (launch/train, launch/steps, checkpoint)
# ---------------------------------------------------------------------------


#: (a) llama3.2-1b FULL, as ``repro.launch.train``'s defaults feed it:
#: 8 x 64 tokens a step; (b) and (c) cut to RESUME_LAYERS of its 16 layers
#: (a checkpoint of the full depth would be ~14.8 GB of npz)
TRAIN_LM_ARCH = "llama3.2-1b"
TRAIN_LM_STEPS, TRAIN_LM_SEQ, TRAIN_LM_BATCH = 6, 64, 8
TRAIN_LM_TIMED = 4
RESUME_LAYERS = 2
TWIN_TRAIN_BATCH, TWIN_TRAIN_SEQ = 2, 16
#: (d) the prefill step then decode steps, greedy, on (a)'s model
STEP_PROMPTS, STEP_PROMPT_LEN, STEP_NEW = 4, 64, 8
#: (e) the paper's Fig. 3 pipeline, as tests/test_system.py trains it
CNN_TRAIN_STEPS, CNN_TRAIN_BATCH, CNN_TRAIN_LR = 60, 64, 3e-3
#: the steps whose gradients are held against the CPU twin's: the first
#: two (by step 10 the loss is ~1e-5, where the softmax's 1 - p cancels)
CNN_TWIN_STEPS = (0, 1)
#: kernel launches per CNN training step on the fused blocks under the
#: saliency rules (the true gradient): the forward's four convs, the
#: ReLU mask at conv 0, conv 2 and FC0, the fused ReLU + pool at conv 1
#: and conv 3, both FC layers; dx of conv 1-3 and of both FC layers
#: through the fused backwards at S = 1; for the weight gradients the
#: gate at the five rectifiers and the unpool at the two pools
PER_TRAIN_CNN_STEP = {"conv2d_fwd": 4, "relu_fwd": 3, "relu_pool_fwd": 2,
                      "vmm_fwd": 2, "conv2d_bwd_fused": 3,
                      "vmm_bwd_fused": 2, "relu_bwd": 5, "unpool_bwd": 2}


def _state_to(state, device):
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    opt = state.opt
    return steps.TrainState(tf.params_to(state.params, device),
                            type(opt)(opt.step.to(device),
                                      tf.params_to(opt.mu, device),
                                      tf.params_to(opt.nu, device)))


def _state_leaves(state):
    from repro_torch.tree import leaves
    from repro_torch.launch import steps
    return (leaves(state.params) + leaves(state.opt.mu)
            + leaves(state.opt.nu) + [state.opt.step])


def _bitwise_states(a, b, what):
    la, lb = _state_leaves(a), _state_leaves(b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        fail(f"{what}: the states are not bitwise equal")


def _batch_on(data, step, device="cuda"):
    return {k: torch.as_tensor(v).to(device)
            for k, v in data.batch_at(step).items()}


def check_train_lm(launches, to_profile):
    """Phase 14 (a)-(d): llama3.2-1b trained at full width and depth, the
    crash-resume at 2 layers bitwise, a 2-layer f32 card-vs-CPU twin, and
    the prefill / decode steps against ``lm.decode``."""
    from repro_torch.tree import leaves, tree_map
    import math
    import os
    import shutil

    from repro_torch import configs, lm
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf
    from repro_torch.optim import clip_by_global_norm, adamw_update
    from repro_torch.runtime import HealthMonitor

    full = configs.get(TRAIN_LM_ARCH)
    data = TokenStream(vocab=full.vocab, seq_len=TRAIN_LM_SEQ,
                       global_batch=TRAIN_LM_BATCH)
    tokens = TRAIN_LM_BATCH * TRAIN_LM_SEQ
    res = {}
    totals = launches.setdefault("train_lm", {})

    # (a) full width and depth: train_loop's 6 steps, each step_fn call
    # between two CUDA events; the last TRAIN_LM_TIMED steps are timed
    t_a = time.perf_counter()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    mon, events, real_build = HealthMonitor(), [], train.build

    def timed_build(*args, **kwargs):
        init_fn, step_fn = real_build(*args, **kwargs)

        def timed_step(state, batch):
            a, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            out = step_fn(state, batch)
            e.record()
            events.append((a, e))
            return out
        return init_fn, timed_step

    train.build = timed_build
    try:
        (state, losses), _ = _count(lambda: train.train_loop(
            full, data, steps=TRAIN_LM_STEPS, ckpt_dir=None, monitor=mon,
            log_every=1), totals)
    finally:
        train.build = real_build
    n_params = sum(t.numel() for t in leaves(state.params))
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 14 (a): losses not finite: {losses}")
    if abs(losses[0] - math.log(full.vocab)) > 1.0:
        fail(f"phase 14 (a): first loss {losses[0]:.4f} not within 1.0 of "
             f"ln {full.vocab} = {math.log(full.vocab):.4f}")
    # host: train_loop's wall time of each step (the step and the sync of
    # its loss); device: each step's span between its events; the window:
    # from the first timed step's start to the last one's end, the gaps
    # between steps included
    timed = events[-TRAIN_LM_TIMED:]
    host_ms = 1e3 * statistics.median(list(mon._times[0])[-TRAIN_LM_TIMED:])
    dev_ms = statistics.median([a.elapsed_time(e) for a, e in timed])
    window_ms = timed[0][0].elapsed_time(timed[-1][1])
    tokens_per_s = TRAIN_LM_TIMED * tokens / window_ms * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  (a) {TRAIN_LM_ARCH} FULL ({full.n_layers} layers, d_model "
          f"{full.d_model}, vocab {full.vocab}, {n_params / 1e9:.3f} G f32 "
          f"params, bf16 compute), {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens: "
          f"losses {[round(v, 4) for v in losses]} (ln V "
          f"{math.log(full.vocab):.4f}); of train_loop's last "
          f"{TRAIN_LM_TIMED} steps, a step {host_ms:.2f} ms host and "
          f"{dev_ms:.2f} ms device (medians; CUDA events around each "
          f"step), the {TRAIN_LM_TIMED} in a window of {window_ms:.2f} ms "
          f"({window_ms / TRAIN_LM_TIMED:.2f} a step), {tokens_per_s:.0f} "
          f"tokens/s over it; peak {peak:.2f} GiB, "
          f"{held:.2f} of it held before phase 14 (kept for the profiles "
          f"at the end)")
    res["a"] = dict(losses=losses, host_ms=host_ms, device_ms=dev_ms,
                    window_ms=window_ms, tokens_per_s=tokens_per_s,
                    peak_gib=peak, held_gib=held, n_params=n_params)
    _, step_fn = train.build(full, total_steps=TRAIN_LM_STEPS)
    b = _batch_on(data, 0)
    to_profile.append((f"lm train step ({TRAIN_LM_ARCH} FULL)",
                       lambda: step_fn(state, b), dev_ms))
    grads = tree_map(torch.zeros_like, state.params)
    lr = torch.tensor(1e-3, device="cuda")

    def adamw_pass():
        adamw_update(clip_by_global_norm(grads, 1.0)[0], state.opt,
                     state.params, lr=lr)

    _, adamw_ms = _host_device_ms(adamw_pass)
    print(f"  (a) clip + AdamW alone over the f32 state: {adamw_ms:.2f} ms "
          f"device ({100 * adamw_ms / dev_ms:.1f} % of a step); "
          f"{time.perf_counter() - t_a:.1f} s")
    res["a"]["adamw_ms"] = adamw_ms
    to_profile.append((f"lm train clip + AdamW ({TRAIN_LM_ARCH} FULL)",
                       adamw_pass, adamw_ms))

    # (d) the prefill and decode steps on (a)'s model, against lm.decode
    params_c = steps.cast_for_compute(state.params, full)
    prompts = torch.randint(0, full.vocab, (STEP_PROMPTS, STEP_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(3))
    want = lm.decode(params_c, full, prompts, max_new=STEP_NEW).generated
    cache = tf.init_cache(full, STEP_PROMPTS,
                          STEP_PROMPT_LEN + STEP_NEW + 8, device="cuda")
    prefill, decode = steps.make_prefill_step(full), \
        steps.make_decode_step(full)

    def run_steps(cache):
        nxt, cache = prefill(params_c, {"tokens": prompts.cuda()}, cache)
        got = [nxt]
        for i in range(STEP_NEW - 1):
            nxt, cache = decode(params_c, cache, nxt, STEP_PROMPT_LEN + i)
            got.append(nxt)
        return torch.cat(got, dim=1)

    got, _ = _count(lambda: run_steps(cache), totals)
    if got.dtype != torch.int32 or not torch.equal(got.long().cpu(),
                                                   want.cpu()):
        fail(f"phase 14 (d): prefill + decode steps {got.tolist()} != "
             f"lm.decode's {want.tolist()}")
    print(f"  (d) prefill step + {STEP_NEW - 1} decode steps, greedy, "
          f"{STEP_PROMPTS} x {STEP_PROMPT_LEN} prompts: the {STEP_NEW} "
          f"tokens equal lm.decode's bitwise")
    del params_c, cache

    # (b) crash-resume at 2 of 16 layers, bitwise; the resumed run's
    # checkpoint manager timed
    t_b = time.perf_counter()
    cut = full.with_(n_layers=RESUME_LAYERS)
    (straight, _), _ = _count(lambda: train.train_loop(
        cut, data, steps=4, ckpt_dir=None, verbose=False), totals)
    timed = {}

    class TimedManager(CheckpointManager):
        def save_async(self, step, tree):
            self.wait()
            t0 = time.perf_counter()
            super().save_async(step, tree)
            timed.setdefault("save_async_block_ms", []).append(
                1e3 * (time.perf_counter() - t0))

        def save_blocking(self, step, tree):
            t0 = time.perf_counter()
            super().save_blocking(step, tree)
            timed.setdefault("save_blocking_s", []).append(
                time.perf_counter() - t0)

        def restore_latest(self, like):
            t0 = time.perf_counter()
            out = super().restore_latest(like)
            torch.cuda.synchronize()
            timed.setdefault("restore_s", []).append(
                time.perf_counter() - t0)
            return out

    real_manager = train.CheckpointManager
    train.CheckpointManager = TimedManager
    try:
        with tempfile.TemporaryDirectory(prefix="ckpt_") as d:
            free = shutil.disk_usage(d).free / 1e9
            _count(lambda: train.train_loop(cut, data, steps=2, ckpt_dir=d,
                                            ckpt_every=2, verbose=False),
                   totals)
            nbytes = os.path.getsize(os.path.join(d, "step_00000002",
                                                  "shard_0.npz"))
            (resumed, _), _ = _count(lambda: train.train_loop(
                cut, data, steps=4, ckpt_dir=d, verbose=False), totals)
            if real_manager(d).latest_step() != 4:
                fail("phase 14 (b): no checkpoint of step 4")
    finally:
        train.CheckpointManager = real_manager
    _bitwise_states(straight, resumed,
                    "phase 14 (b): 4 straight vs 2 + 2 resumed")
    block_ms = statistics.median(timed["save_async_block_ms"])
    save_s = statistics.median(timed["save_blocking_s"])
    restore_s = timed["restore_s"][0]
    print(f"  (b) {RESUME_LAYERS} of {full.n_layers} layers at full width: 4 "
          f"straight steps == 2 + a checkpoint + 2 resumed, bitwise (params, "
          f"mu, nu, step); a checkpoint {nbytes / 1e9:.3f} GB, save_async "
          f"blocks {block_ms:.1f} ms, save_blocking {save_s:.2f} s (after "
          f"the async save's wait), restore {restore_s:.2f} s ({free:.1f} GB "
          f"free in the temporary directory; removed); "
          f"{time.perf_counter() - t_b:.1f} s")
    res["b"] = dict(ckpt_bytes=nbytes, save_async_block_ms=block_ms,
                    save_blocking_s=save_s, restore_s=restore_s)
    del straight, resumed

    # (c) card vs CPU twin, f32, 2 layers, batch 2 x 16
    t_c = time.perf_counter()
    twin = full.with_(n_layers=RESUME_LAYERS, dtype="float32")
    init_fn, twin_step = train.build(twin, total_steps=TRAIN_LM_STEPS)
    cpu = init_fn(torch.Generator().manual_seed(0), "cpu")
    card = _state_to(cpu, "cuda")
    tdata = TokenStream(vocab=full.vocab, seq_len=TWIN_TRAIN_SEQ,
                        global_batch=TWIN_TRAIN_BATCH)
    errs = {}
    for s in range(2):
        bc = _batch_on(tdata, s, "cpu")
        cpu, mc = twin_step(cpu, bc)
        (card, m), _ = _count(lambda: twin_step(
            card, {k: v.cuda() for k, v in bc.items()}), totals)
        for k in ("loss", "ce", "gnorm"):
            e = abs(float(m[k]) - float(mc[k])) / abs(float(mc[k]))
            errs[k] = max(errs.get(k, 0.0), e)
            if not e <= DOT_TOL:
                fail(f"phase 14 (c): step {s} {k} card {float(m[k])} vs "
                     f"CPU {float(mc[k])}")
    for name in ("mu", "nu"):
        worst = 0.0
        for x, y in zip(leaves(getattr(card.opt, name)),
                        leaves(getattr(cpu.opt, name))):
            e = (x.cpu() - y).abs().max().item() / max(
                y.abs().max().item(), 1e-30)
            worst = max(worst, e)
        errs[name] = worst
        if not worst <= REPLAY_TOL:
            fail(f"phase 14 (c): {name} card vs CPU {worst:.3e} of max")
    print(f"  (c) {RESUME_LAYERS} layers f32, {TWIN_TRAIN_BATCH} x "
          f"{TWIN_TRAIN_SEQ} tokens, 2 steps card vs CPU: loss / ce / gnorm "
          f"within {max(errs['loss'], errs['ce'], errs['gnorm']):.2e} "
          f"relative, mu {errs['mu']:.2e}, nu {errs['nu']:.2e} of max; "
          f"{time.perf_counter() - t_c:.1f} s")
    res["c"] = errs
    del cpu, card
    return res, (state, full)


def check_train_cnn(launches):
    """Phase 14 (e): the paper's Fig. 3 pipeline on the card: the Table
    III CNN trained with AdamW on the kernel path (fused blocks, saliency
    rules: the true gradient), then explained; the first step's conv
    weight gradients against float64 under cuDNN's default flags (C1)."""
    import numpy as np

    from repro_torch import optim
    from repro_torch.core import attribution
    from repro_torch.data import CifarLikeImages
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.kernels.conv2d import ref as conv_ref
    from repro_torch.models import cnn

    cfg, ds = cnn.CNNConfig(), CifarLikeImages()
    p = cnn.params_to(cnn.init(torch.Generator().manual_seed(0), cfg),
                      "cuda")
    state = optim.adamw_init(p)
    setting = torch.backends.cudnn.conv.fp32_precision
    totals = launches.setdefault("train_cnn", {})

    def batch(s, device):
        b = ds.batch_at(s, batch=CNN_TRAIN_BATCH)
        return (torch.from_numpy(b["image"]).to(device),
                torch.from_numpy(b["label"]).long().to(device))

    def loss_and_grads(p, img, lab):
        pg = {k: [{n: t.detach().requires_grad_() for n, t in q.items()}
                  for q in v] for k, v in p.items()}
        leaves = [q[n] for k in ("conv", "fc") for q in pg[k]
                  for n in ("w", "b")]
        loss = F.cross_entropy(cnn.apply(pg, img, cfg, method="saliency",
                                         use_pallas=True), lab)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def step(p, state, s):
        loss, flat = loss_and_grads(p, *batch(s, "cuda"))
        it = iter(flat)
        grads = {k: [{n: next(it) for n in ("w", "b")} for _ in p[k]]
                 for k in ("conv", "fc")}
        p, state = optim.adamw_update(grads, state, p, lr=CNN_TRAIN_LR,
                                      weight_decay=0.0)
        return p, state, loss, flat

    def against_twin(p, s, loss, flat):
        """The step's loss and gradients against the port on the CPU (each
        kernel's plain version) from the same params and batch, on the
        examples whose residual bits the two devices agree on."""
        img, lab = batch(s, "cuda")
        img_c, lab_c = batch(s, "cpu")
        p_cpu = cnn.params_to(p, "cpu")
        _, res = cnn.forward_with_residuals(p, img, cfg, "saliency")
        _, res_c = cnn.forward_with_residuals(p_cpu, img_c, cfg, "saliency")
        keep = ~_flipped_examples(res, res_c, CNN_TRAIN_BATCH)
        if not bool(keep.all()):
            loss, flat = loss_and_grads(p, img[keep.cuda()],
                                        lab[keep.cuda()])
        loss_c, flat_c = loss_and_grads(p_cpu, img_c[keep], lab_c[keep])
        what = f"phase 14 (e): step {s} card vs CPU twin"
        e_loss = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
        if not e_loss <= DOT_TOL:
            fail(f"{what}: loss {loss.item()} vs {loss_c.item()}")
        worst = 0.0
        for i, (g, g_c) in enumerate(zip(flat, flat_c)):
            e = (g.cpu() - g_c).abs().max().item()
            ref = g_c.abs().max().item()
            if not (bool(torch.isfinite(g).all()) and e <= REPLAY_TOL * ref):
                fail(f"{what}: gradient {i} off by {e:.3e} (max|g| "
                     f"{ref:.3e})")
            worst = max(worst, e / ref)
        return dict(step=s, kept=int(keep.sum()), loss=loss_c.item(),
                    loss_rel_err=e_loss, grad_rel_err=worst)

    seen, real = [], conv_ref.conv2d_weight_grad

    def spy(x, w, g):
        dw = real(x, w, g)
        seen.append((x, w, g, dw))
        return dw

    losses, twins, wall_s = [], [], 0.0
    for s in range(CNN_TRAIN_STEPS):
        if s == 0:
            conv_ref.conv2d_weight_grad = spy
        t0, before = time.perf_counter(), p
        try:
            (p, state, loss, flat), rose = _count(
                lambda: step(p, state, s), totals)
        finally:
            conv_ref.conv2d_weight_grad = real
        wall_s += time.perf_counter() - t0
        _expect(rose, PER_TRAIN_CNN_STEP, f"phase 14 (e): step {s}")
        losses.append(loss)
        if s in CNN_TWIN_STEPS:
            twins.append(against_twin(before, s, loss, flat))
        del flat
    losses = [v.item() for v in losses]
    worst = 0.0
    for x, w, g, dw in seen:
        dw64 = torch.nn.grad.conv2d_weight(
            x.double().permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).shape,
            g.double().permute(0, 3, 1, 2), padding=(w.shape[0] - 1) // 2
        ).permute(2, 3, 1, 0)
        e = (dw.double() - dw64).abs().max().item() / dw64.abs().max().item()
        worst = max(worst, e)
    if len(seen) != len(p["conv"]) or not worst <= DOT_TOL:
        fail(f"phase 14 (e): {len(seen)} conv weight gradients, worst "
             f"{worst:.3e} of max from float64 (cuDNN conv fp32_precision "
             f"{setting!r} outside the port's calls)")
    test = ds.batch_at(999, batch=128)
    with torch.no_grad():
        logits = cnn.apply(p, torch.from_numpy(test["image"]).cuda(), cfg,
                           use_pallas=True)
    acc = (logits.argmax(-1).cpu().numpy() == test["label"]).mean()
    eng = build(EngineSpec(CNNModel(p, cfg, device="cuda"),
                           method="saliency"))
    _, rel = eng.explain(test["image"][:16])
    hm = attribution.heatmap(rel).cpu().numpy()
    cy, cx = ds.blob_center(test["label"][:16])
    yy = np.arange(32)[None, :, None]
    xx = np.arange(32)[None, None, :]
    near = ((yy - cy[:, None, None]) ** 2
            + (xx - cx[:, None, None]) ** 2) < 6.0 ** 2
    in_mass = (hm * near).sum(axis=(1, 2)) / hm.sum(axis=(1, 2))
    share = float(near.mean())
    med = float(np.median(in_mass))
    print(f"  (e) Table III CNN, {CNN_TRAIN_STEPS} AdamW steps of batch "
          f"{CNN_TRAIN_BATCH} (lr {CNN_TRAIN_LR}, fused blocks, saliency "
          f"rules) in {wall_s:.2f} s: loss at steps 0 / 1 / 2 / 10 / "
          f"{CNN_TRAIN_STEPS - 1} "
          + " / ".join(f"{losses[i]:.4g}" for i in (0, 1, 2, 10, -1))
          + f"; accuracy {acc:.3f} on batch_at(999, 128); "
          f"saliency heatmap in-blob mass median {med:.4f} against "
          f"{share:.4f} of the area ({med / share:.2f}x); the first step's "
          f"{len(seen)} conv weight gradients within {worst:.2e} of max "
          f"from float64 (cuDNN conv fp32_precision {setting!r} outside "
          f"the port's calls); launches a step {PER_TRAIN_CNN_STEP}")
    for t in twins:
        print(f"  (e) step {t['step']} against the CPU twin (each kernel's "
              f"plain version, the same params and batch) on {t['kept']} of "
              f"{CNN_TRAIN_BATCH} examples: loss {t['loss']:.4f}, within "
              f"{t['loss_rel_err']:.2e} relative, every gradient within "
              f"{t['grad_rel_err']:.2e} of its max")
    if not acc > 0.5:
        fail(f"phase 14 (e): accuracy {acc:.3f} <= 0.5")
    if not med > 3 * share:
        fail(f"phase 14 (e): in-blob mass median {med:.4f} <= 3 x {share:.4f}")
    return dict(losses=losses, accuracy=float(acc), in_mass_median=med,
                area_share=share, dw_f64_rel_err=worst, wall_s=wall_s,
                twins=twins, cudnn_conv_fp32_precision=setting,
                launches_per_step=PER_TRAIN_CNN_STEP)


# ---------------------------------------------------------------------------
# phase 15: multi-device (torch.distributed: the data-parallel engine and
# train step, the compressed all-reduce)
# ---------------------------------------------------------------------------

#: (b) the serving meshes held against the single-device ``h100`` engine:
#: ``mesh:h100:4`` is capped at the world's ranks
DP_SHARDS = (1, 4)
#: (b) timed rounds of the sharded and unsharded explains (after DP_WARM)
DP_TIMED, DP_WARM = 24, 4
#: (c) data-parallel train steps, each against the plain step
DP_TRAIN_STEPS = 2
#: (d) timed calls of the compressed all-reduce
CAR_REPS = 10
#: (e) multi-card worlds: at most this many ranks, each joined within
DP_MAX_RANKS, DP_RANK_TIMEOUT_S = 4, 600


def _init_world(rank, world, store):
    """A NCCL process group of ``world`` ranks, this one on card
    ``rank``, rendezvousing through a ``file://`` store."""
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _res_tensors(res):
    return ([t for pair in res["conv"] for t in pair if t is not None]
            + [t for t in res["fc"] if t is not None])


def _dp_outputs(eng, x):
    """The sharded path a user runs: explain (top-3), forward, replay of
    its residuals."""
    logits, rel = eng.explain(x)
    f_logits, res = eng.forward(x)
    seeds = eng._seeds(f_logits, None, SEEDS)[0]
    return dict(logits=logits, rel=rel, forward=f_logits,
                replay=eng.replay(res, seeds), res=res)


def _dp_held(what, got, want, precision, exact):
    """``got`` against ``want`` (the single-device engine's): bit for bit
    where ``exact``; else fxp16 bitwise, f32 within DOT_TOL and bf16
    within BF16_TOL of max|ref| (FC0's K split follows the rows a rank
    holds), residual bits within MIN_BIT_AGREEMENT.  Returns the worst
    error."""
    worst = 0.0
    bitwise = exact or precision == "fxp16"
    for k in ("logits", "rel", "forward", "replay"):
        a, b = got[k], want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what} {k}: {tuple(a.shape)} {a.dtype} vs "
                 f"{tuple(b.shape)} {b.dtype}")
        if bitwise:
            if not torch.equal(a, b):
                fail(f"{what} {k}: not bitwise the single-device engine's")
            continue
        err = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        tol = BF16_TOL if precision == "bf16" else DOT_TOL
        worst = max(worst, err / max(ref, 1e-30))
        if not err <= tol * ref:
            fail(f"{what} {k}: {err:.3e} off (max|ref| {ref:.3e})")
    ra, rb = _res_tensors(got["res"]), _res_tensors(want["res"])
    if len(ra) != len(rb):
        fail(f"{what}: residual structure differs")
    if bitwise:
        if not all(torch.equal(a, b) for a, b in zip(ra, rb)):
            fail(f"{what}: residual bytes differ")
    else:
        flips, bits = _residual_bit_flips(got["res"], want["res"])
        if flips > (1 - MIN_BIT_AGREEMENT) * bits:
            fail(f"{what}: {flips} of {bits} residual bits differ")
    return worst


def _dp_engines(params, cfg, x, launches, exact, what):
    """(b) on every rank of the current world: ``mesh:h100:<n>`` engines
    for n in DP_SHARDS against the single-device ``h100`` engine, every
    method and precision; each sharded run counted (path ``dp_<p>``).
    Returns the worst relative error per precision."""
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    worst = {}
    for precision in ("f32", "bf16", "fxp16"):
        totals = launches.setdefault(f"dp_{precision}", {})
        for method in METHODS:
            spec = dict(method=method, precision=precision,
                        targets=TopK(SEEDS), batch=BATCH)
            base = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                    device="h100", **spec))
            want = _dp_outputs(base, x)
            for n in DP_SHARDS:
                eng = build(EngineSpec(CNNModel(params, cfg, device="cuda"),
                                       device=f"mesh:h100:{n}", **spec))
                if eng.n_shards != n or eng.mesh is None \
                        or not eng.mesh.has_group:
                    fail(f"{what}: mesh:h100:{n} engine has n_shards "
                         f"{eng.n_shards}, mesh {eng.mesh!r}")
                got, rose = _count(lambda: _dp_outputs(eng, x), totals)
                wants = {k: 2 * v for k, v in PER_EXPLAIN[precision].items()}
                if method == "deconvnet":
                    wants["relu_fwd"] = 0
                _expect(rose, wants, f"{what} {precision} {method} "
                                     f"mesh:h100:{n}")
                worst[precision] = max(worst.get(precision, 0.0), _dp_held(
                    f"{what} {precision} {method} mesh:h100:{n}", got, want,
                    precision, exact))
    return worst


def _dp_train(state, full, batches, mesh, what, timed):
    """(c): a data-parallel step over ``mesh`` (one rank) from ``state``
    on each of DP_TRAIN_STEPS batches, each bitwise the plain step from
    the same state and batch (its result held on the host, so that one
    new state at most is on the card besides ``state``); both timed into
    ``timed``.  Returns the embedding gradient of the first data-parallel
    step, caught at the clip."""
    from repro_torch.launch import steps, train
    _, plain = train.build(full, total_steps=TRAIN_LM_STEPS)
    _, dp = train.build(full, total_steps=TRAIN_LM_STEPS, mesh=mesh)
    caught, real_clip = [], steps.clip_by_global_norm

    def catch(grads, clip, **kw):
        if not caught:
            caught.append(grads["embed"]["table"].clone())
        return real_clip(grads, clip, **kw)

    def run(step_fn, b, key):
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        a.record()
        out = step_fn(state, b)
        e.record()
        torch.cuda.synchronize()
        timed.setdefault(key, []).append(
            (1e3 * (time.perf_counter() - t0), a.elapsed_time(e)))
        return out

    for i, b in enumerate(batches[:DP_TRAIN_STEPS]):
        p_state, p_m = run(plain, b, "plain")
        p_host = [t.cpu() for t in _state_leaves(p_state)]
        del p_state
        steps.clip_by_global_norm = catch
        try:
            d_state, d_m = run(dp, b, "dp")
        finally:
            steps.clip_by_global_norm = real_clip
        for k in ("loss", "ce", "gnorm", "lr"):
            if float(d_m[k]) != float(p_m[k]):
                fail(f"{what}: step {i} {k} {float(d_m[k])} vs the plain "
                     f"step's {float(p_m[k])}")
        d_leaves = _state_leaves(d_state)
        if len(d_leaves) != len(p_host) or not all(
                a.dtype == c.dtype and torch.equal(a.cpu(), c)
                for a, c in zip(d_leaves, p_host)):
            fail(f"{what}: step {i}: the state is not bitwise the plain "
                 f"step's")
        del p_host, d_leaves, d_state
    return caught[0]


def _dp_train_slices(state, full, batches, mesh, what):
    """(e)'s (c): a data-parallel step over ``mesh`` from ``state`` on
    each batch, its gradient (caught at the clip, after the all-reduce)
    against the row-weighted f32 sum, in rank order, of the plain step's
    gradient of each rank's slice, within DOT_TOL of each leaf's max, and
    its loss and CE against the same sums within DOT_TOL.  (Against the
    plain step of the whole batch the bf16 compute would set the bound:
    each rank's gradient of its rows is rounded to bf16 before the sum.)
    Returns the worst errors and the data-parallel steps' host / device
    ms."""
    from repro_torch import tree as trees
    from repro_torch.data import host_shard_bounds
    from repro_torch.dist.sharding import batch_group
    from repro_torch.launch import steps, train
    _, plain = train.build(full, total_steps=TRAIN_LM_STEPS)
    _, dp = train.build(full, total_steps=TRAIN_LM_STEPS, mesh=mesh)
    _, _, ways = batch_group(mesh)
    real_clip = steps.clip_by_global_norm

    def caught(step_fn, b):
        got = []

        def catch(grads, clip, **kw):
            got.append([t.clone() for t in trees.leaves(grads)])
            return real_clip(grads, clip, **kw)

        steps.clip_by_global_norm = catch
        try:
            new, m = step_fn(state, b)
        finally:
            steps.clip_by_global_norm = real_clip
        del new
        return got[0], m

    errs, timed = {"grads": 0.0, "metrics": 0.0}, []
    for i, b in enumerate(batches[:DP_TRAIN_STEPS]):
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        a.record()
        d_grads, d_m = caught(dp, b)
        e.record()
        torch.cuda.synchronize()
        timed.append((1e3 * (time.perf_counter() - t0), a.elapsed_time(e)))
        n = next(iter(b.values())).shape[0]
        ref, ref_m = None, {"loss": 0.0, "ce": 0.0}
        for r in range(ways):
            lo, hi = host_shard_bounds(n, r, ways)
            g, m = caught(plain, {k: v[lo:hi] for k, v in b.items()})
            share = (hi - lo) / n
            g = [t.mul_(share) for t in g]
            ref = g if ref is None else [x.add_(y) for x, y in zip(ref, g)]
            for k in ref_m:
                ref_m[k] += share * float(m[k])
            del g
        for j, (x, y) in enumerate(zip(d_grads, ref)):
            err = (x - y).abs().max().item() / max(y.abs().max().item(),
                                                   1e-30)
            errs["grads"] = max(errs["grads"], err)
            if not err <= DOT_TOL:
                fail(f"{what}: step {i}: gradient leaf {j} {err:.3e} of max "
                     f"from the slices' weighted sum")
        for k in ref_m:
            err = abs(float(d_m[k]) - ref_m[k]) / abs(ref_m[k])
            errs["metrics"] = max(errs["metrics"], err)
            if not err <= DOT_TOL:
                fail(f"{what}: step {i}: {k} {float(d_m[k])} vs the slices' "
                     f"weighted sum {ref_m[k]}")
        del d_grads, ref
    return errs, timed


def _dp_rank(rank, world, store, x_cpu, out_dir):
    """(e) one rank of a multi-card world: (b) and (c) on its card, the
    results in ``out_dir/rank<r>.json``, a failure's traceback in
    ``rank<r>.err``."""
    import traceback

    import torch.distributed as dist
    try:
        _init_world(rank, world, store)
        from repro_torch import configs
        from repro_torch.data import TokenStream
        from repro_torch.kernels import _build
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import cnn
        _build.library()
        cfg = cnn.CNNConfig()
        params = cnn.init(torch.Generator().manual_seed(0), cfg)
        launches = {}
        worst = _dp_engines(params, cfg, x_cpu.cuda(), launches,
                            exact=False, what=f"phase 15 (e) rank {rank}")
        full = configs.get(TRAIN_LM_ARCH)
        data = TokenStream(vocab=full.vocab, seq_len=TRAIN_LM_SEQ,
                           global_batch=TRAIN_LM_BATCH)
        state = steps.make_train_state_init(full)(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        errs, timed = _dp_train_slices(
            state, full, [_batch_on(data, s) for s in range(DP_TRAIN_STEPS)],
            make_host_mesh(world, 1), f"phase 15 (e) rank {rank}")
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            engine_worst=worst, train=errs, launches=launches,
            train_ms=timed)))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def _dp_multi_card(x_cpu):
    """(e): ``min(DP_MAX_RANKS, count)`` NCCL ranks, one card each."""
    import multiprocessing as mp
    world = min(DP_MAX_RANKS, torch.cuda.device_count())
    with tempfile.TemporaryDirectory(prefix="dp_") as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_dp_rank, args=(
            r, world, str(Path(d, "store")), x_cpu, d)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = [Path(d, f"rank{r}.err") for r in range(world)]
        bad = [e.read_text() for e in errs if e.exists()]
        if bad or any(p.exitcode != 0 for p in procs):
            fail(f"phase 15 (e): ranks failed (exit codes "
                 f"{[p.exitcode for p in procs]}):\n" + "\n".join(bad))
        return world, [json.loads(Path(d, f"rank{r}.json").read_text())
                       for r in range(world)]


def check_multi_device(params, cfg, x_cpu, launches, lm_state):
    """Phase 15 (a)-(d): (a) a world-1 NCCL process group; (b) the
    data-parallel CNN engine bitwise the single-device one, timed; (c) the
    data-parallel train step bitwise the plain one; (d) the int8
    compressed all-reduce over NCCL.  (e) is :func:`check_multi_card`."""
    import torch.distributed as dist

    from repro_torch.data import TokenStream
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import (compress_int8, compressed_all_reduce,
                                     decompress_int8)
    res = {}
    x = x_cpu.cuda()
    with tempfile.TemporaryDirectory(prefix="nccl_") as d:
        # (a)
        t_a = time.perf_counter()
        _init_world(0, 1, str(Path(d, "store")))
        print(f"  (a) NCCL process group of 1 rank (file:// store) in "
              f"{time.perf_counter() - t_a:.2f} s; backend "
              f"{dist.get_backend()}")
        try:
            # (b) bitwise, counted
            t_b = time.perf_counter()
            _dp_engines(params, cfg, x, launches, exact=True,
                        what="phase 15 (b)")
            # the world-1 collectives' cost: sharded vs unsharded explain
            timing = {}
            for precision in ("f32", "bf16", "fxp16"):
                spec = dict(precision=precision, targets=TopK(SEEDS),
                            batch=BATCH)
                engs = {k: build(EngineSpec(
                    CNNModel(params, cfg, device="cuda"), device=dev,
                    **spec)) for k, dev in (("single", "h100"),
                                            ("mesh", "mesh:h100:1"))}
                host = {k: [] for k in engs}
                for i in range(DP_WARM + DP_TIMED):
                    for k, eng in engs.items():
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        eng.explain(x)
                        torch.cuda.synchronize()
                        if i >= DP_WARM:
                            host[k].append(1e3 * (time.perf_counter() - t0))
                row = {}
                for k, eng in engs.items():
                    h = statistics.median(host[k])
                    row[k] = dict(host_ms=h, device_ms=device_time_ms(
                        lambda eng=eng: eng.explain(x), reps=DP_TIMED,
                        cover_ms=max(50.0, 30 * h)))
                timing[precision] = row
                print(f"  (b) {precision:5s} saliency top-{SEEDS} explain, "
                      f"batch {BATCH}: mesh:h100:1 {row['mesh']['host_ms']:.3f}"
                      f" ms host / {row['mesh']['device_ms']:.4f} ms device, "
                      f"h100 {row['single']['host_ms']:.3f} / "
                      f"{row['single']['device_ms']:.4f} (medians of "
                      f"{DP_TIMED}, interleaved)")
            print(f"  (b) mesh:h100:1 and mesh:h100:4 (capped at 1 rank) x "
                  f"f32 / bf16 / fxp16 x {', '.join(METHODS)}: explain, "
                  f"forward, replay and every residual byte bitwise the "
                  f"h100 engine's; {time.perf_counter() - t_b:.1f} s")
            res["b"] = timing

            # (c) on phase 14's model and state
            t_c = time.perf_counter()
            state, full = lm_state
            data = TokenStream(vocab=full.vocab, seq_len=TRAIN_LM_SEQ,
                               global_batch=TRAIN_LM_BATCH)
            timed = {}
            torch.cuda.reset_peak_memory_stats()
            grad = _dp_train(state, full, [_batch_on(data, s) for s in
                                           range(DP_TRAIN_STEPS)],
                             make_host_mesh(1, 1), "phase 15 (c)", timed)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            res["c"] = dict(
                dp_ms=[dict(host=h, device=e) for h, e in timed["dp"]],
                plain_ms=[dict(host=h, device=e) for h, e in timed["plain"]],
                peak_gib=peak)
            print(f"  (c) {TRAIN_LM_ARCH} FULL from phase 14's state, "
                  f"{TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens: a "
                  f"data-parallel step on each of {DP_TRAIN_STEPS} batches, "
                  f"on make_host_mesh(1, 1), bitwise the plain steps (loss, "
                  f"ce, gnorm, lr, params, mu, nu, step); a step host / "
                  f"device ms: data parallel "
                  + ", ".join(f"{h:.2f} / {e:.2f}" for h, e in timed["dp"])
                  + "; plain " + ", ".join(f"{h:.2f} / {e:.2f}"
                                           for h, e in timed["plain"])
                  + f"; peak {peak:.2f} GiB; "
                  f"{time.perf_counter() - t_c:.1f} s")

            # (d) the compressed all-reduce on the tied embedding's
            # gradient
            t_d = time.perf_counter()
            err = torch.zeros_like(grad)
            for rnd in range(2):            # then with the error fed back
                total, new_err = compressed_all_reduce(grad, err=err)
                q, scale = compress_int8(grad + err)
                want = decompress_int8(q, scale)
                if not torch.equal(total, want):
                    fail(f"phase 15 (d): round {rnd}: the sum is not "
                         f"decompress(compress(x + err)) bitwise")
                if not torch.equal(new_err, (grad + err) - want):
                    fail(f"phase 15 (d): round {rnd}: the new error is not "
                         f"the residue")
                err = new_err
            car_ms = device_time_ms(
                lambda: compressed_all_reduce(grad, err=err), reps=CAR_REPS)
            plain = grad.clone()
            ar_ms = device_time_ms(lambda: dist.all_reduce(plain),
                                   reps=CAR_REPS)
            wire = q.numel() * q.element_size() + \
                scale.numel() * scale.element_size()
            f32_bytes = grad.numel() * 4
            res["d"] = dict(shape=list(grad.shape), ms=car_ms,
                            f32_all_reduce_ms=ar_ms, wire_bytes=wire,
                            f32_bytes=f32_bytes)
            print(f"  (d) compressed_all_reduce of the tied embedding's "
                  f"gradient {list(grad.shape)} f32 over NCCL (1 rank): the "
                  f"sum and the new error bitwise decompress(compress(x + "
                  f"err)) and its residue, twice; {car_ms:.3f} ms device "
                  f"(median of {CAR_REPS}; f32 all_reduce {ar_ms:.3f} ms); "
                  f"the all-gather carries {wire / 1e6:.1f} MB (int8 + f32 "
                  f"row scales) against {f32_bytes / 1e6:.1f} MB of f32 "
                  f"({f32_bytes / wire:.2f}x fewer); "
                  f"{time.perf_counter() - t_d:.1f} s")
            del grad, err, total, new_err, want, plain, q, scale
        finally:
            dist.destroy_process_group()

    return res


def check_multi_card(x_cpu):
    """Phase 15 (e), run last (after the profiles, when the earlier
    phases' memory on card 0 is freed): a world of ``min(DP_MAX_RANKS,
    count)`` NCCL ranks, one card each, where the machine has 2 or more
    cards; None otherwise."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"phase 15 (e): the machine has {count} card: no multi-card "
              f"world")
        return None
    t_e = time.perf_counter()
    world, ranks = _dp_multi_card(x_cpu)
    print(f"phase 15 (e): {world} NCCL ranks, one card each: the sharded "
          f"engines against each card's single-device engine (fxp16 "
          f"bitwise; worst f32 / bf16 relative errors "
          + ", ".join(f"{r['engine_worst'].get('f32', 0):.2e} / "
                      f"{r['engine_worst'].get('bf16', 0):.2e}"
                      for r in ranks)
          + f"); {DP_TRAIN_STEPS} data-parallel {TRAIN_LM_ARCH} FULL train "
          f"steps, their gradients against the row-weighted sums of the "
          f"plain steps' gradients of each rank's slice (worst "
          + ", ".join(f"{r['train']['grads']:.2e}" for r in ranks)
          + " of a leaf's max; loss and ce "
          + ", ".join(f"{r['train']['metrics']:.2e}" for r in ranks)
          + "); a data-parallel step host / device ms on rank 0: "
          + ", ".join(f"{h:.2f} / {e:.2f}" for h, e in ranks[0]["train_ms"])
          + f"; {time.perf_counter() - t_e:.1f} s")
    return dict(world=world, ranks=ranks)
# ---------------------------------------------------------------------------
# phase 16: the model axis (tensor and expert parallel LM steps)
# ---------------------------------------------------------------------------

#: (a) B13 at a model rank's channels (B = 4 prompts, S = 72): falcon-
#: mamba-7b's 8192 over 2 and 4 ranks, hymba-1.5b's 3200 over 2 and 4 (800
#: is not a multiple of the backward's 128-channel dB / dC partials)
TP_SCAN_D = (4096, 2048, 1600, 800)
#: (b) the jobs of the one card's world, full width: the attribute steps of
#: falcon-mamba-7b (B13 on each rank's channels) and hymba-1.5b (25 heads:
#: split across the ranks), a llama3.2-1b train step ("train"); (c) adds
#: moonshot-v1-16b-a3b (64 experts over the ranks) and qwen2-1.5b (2 KV
#: heads over 4 ranks)
TP_JOBS = ("falcon-mamba-7b", "hymba-1.5b", "train")
TP_MULTI_JOBS = TP_JOBS + ("moonshot-v1-16b-a3b", "qwen2-1.5b")
#: each job's depth: 2 layers (the train step: RESUME_LAYERS), moonshot at
#: phase 13's 12; the f32 twins at 2 layers on LM_TWIN_BATCH x LM_TWIN_SEQ
TP_DEPTH = {"moonshot-v1-16b-a3b": ZOO_DEPTH["moonshot-v1-16b-a3b"]}
TP_LAYERS = 2
#: (b) ranks sharing card 0 (gloo: NCCL refuses two ranks on one card);
#: (c) NCCL worlds of 2 and 4 ranks, one card each
TP_ONE_CARD_RANKS, TP_WORLDS = 2, (2, 4)
#: timed calls of each step (after one warm-up), and a world's deadline
TP_TIMED, TP_RANK_TIMEOUT_S = 3, 900
#: the model-parallel bf16 step against the single-process one on the same
#: card.  Attribute scores: within TP_BF16_SCORES_TOL of max sum_d
#: |rel * e| (phase 13's scale), 5.6 x the largest reading of a job whose
#: tokens all take the same experts (6.6e-5 to 1.8e-4 at 2 and 4 ways on
#: one and four H100s); an MoE whose routing differs (a bf16 step apart in
#: the router's input flips a near tie, and the token takes another
#: expert's output: moonshot-v1-16b-a3b reads 4.3e-4 to 1.5e-3 with about
#: 1500 of its 3168 token-layers routed otherwise) by phase 13's
#: ZOO_BF16_SCORES_TOL.  The train step's loss and gnorm: within
#: TP_BF16_TRAIN_TOL relative, 5.2 x the largest reading (1.1e-5 to
#: 5.7e-5)
TP_BF16_SCORES_TOL, TP_BF16_TRAIN_TOL = 1e-3, 3e-4


def _tp_timed(fn, reps=TP_TIMED):
    """Medians of host ms and CUDA-event ms of ``reps`` calls of ``fn``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        dev.append(a.elapsed_time(e))
    return statistics.median(host), statistics.median(dev)


def _bf16_rule(what, tp, one, f32):
    """Phase 13's bf16 rule: the model-parallel bf16 result no farther
    from the f32 evaluation of the same weights than LM_LOGITS_FACTOR
    times the single-process bf16 step (floor: half a bf16 step)."""
    e_tp, e_one = _rel_err(tp, f32), _rel_err(one, f32)
    if not e_tp <= LM_LOGITS_FACTOR * max(e_one, BF16_STEP / 2):
        fail(f"phase 16 {what}: bf16 {e_tp:.3e} of max from f32, the "
             f"single-process step's {e_one:.3e}")
    return e_tp, e_one


def _routes(fn):
    """``fn()`` and the expert ids ``[T, k]`` of every MoE routing it ran,
    in order (none without experts)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[1].clone())
        return out

    moe.route = spy
    try:
        return fn(), seen
    finally:
        moe.route = real


def _terms_scale(params, cfg, batch):
    """max_t sum_d |rel * e| of the attribute step's ixg seed (saliency,
    B13 on hybrid and mamba stacks) on one process: the scale phase 13
    holds bf16 scores to."""
    from repro_torch.engine import methods as engine_methods
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    h = tf.embed_inputs(params, cfg, batch)
    tiles = steps.ssm_scan_tiles(cfg)

    def f(e):
        return tf.forward_from_embeddings(
            params, cfg, e, method="saliency",
            enc_frames=batch.get("frames"), scan_tiles=tiles)[0]

    _, rel, _ = engine_methods.attribute_tokens(f, h)
    return (rel.float() * h.float()).abs().sum(-1).max().item()


def _tp_attribute(arch, mesh, single):
    """One attribute job on ``mesh``: the ixg step in bf16 at full width
    (``TP_DEPTH``), counted, timed, its collective bytes; the f32 twin at
    TP_LAYERS (the config's int8 residuals, their row scales taken over
    the ranks' slices by ``max_over_model``); on rank 0 (``single``) the
    single-process steps beside them."""
    from repro_torch import configs
    from repro_torch import tree as trees
    from repro_torch.dist import params as dist_params
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = configs.get(arch).with_(n_layers=TP_DEPTH.get(arch, TP_LAYERS))
    params = tf.init(cfg, generator=torch.Generator(device="cuda")
                     .manual_seed(0), device="cuda")
    batch = _zoo_inputs(cfg, LM_BATCH, LM_PROMPT + LM_NEW,
                        torch.Generator(device="cuda").manual_seed(2),
                        "cuda")
    local = dist_params.shard_params(params, mesh)
    if not single:
        del params
    step = steps.make_attribute_step(cfg, mode="ixg", mesh=mesh)
    torch.cuda.synchronize()
    reset_launches()
    shd.reset_model_traffic()
    (logits, scores), routes = _routes(lambda: step(local, batch))
    torch.cuda.synchronize()
    out = dict(ways=shd.model_ways(mesh), n_layers=cfg.n_layers,
               launches={k: v for k, v in LAUNCHES.items() if v},
               traffic=dict(shd.MODEL_TRAFFIC))
    _finite(logits, f"phase 16 {arch} logits", (LM_BATCH, cfg.vocab))
    _finite(scores, f"phase 16 {arch} scores", tuple(batch["tokens"].shape))
    out["ms"] = _tp_timed(lambda: step(local, batch))
    del local
    if single:
        one = steps.make_attribute_step(cfg, mode="ixg")
        ref, want = _routes(lambda: one(params, batch))
        # tokens routed to other experts than on one process, over layers
        out["routing_flips"] = sum(int((a != b).any(-1).sum())
                                   for a, b in zip(routes, want))
        out["one_ms"] = _tp_timed(lambda: one(params, batch))
        # phase 13's rule for bf16 scores (sums over d that cancel): the
        # scale of a bf16 sum's rounding, max sum_d |rel * e|
        terms = _terms_scale(params, cfg, batch)
        p32 = trees.tree_map(lambda t: t.float(), params)
        del params
        f32 = steps.make_attribute_step(cfg.with_(dtype="float32"),
                                        mode="ixg")(p32, batch)
        del p32
        out["bf16_logits"] = _bf16_rule(f"{arch} logits", logits, ref[0],
                                        f32[0])
        out["bf16_scores"] = tuple(
            (a.float() - b.float()).abs().max().item() / terms
            for a, b in ((scores, ref[1]), (scores, f32[1]), (ref[1], f32[1])))
        tol = (ZOO_BF16_SCORES_TOL if out["routing_flips"]
               else TP_BF16_SCORES_TOL)
        if not out["bf16_scores"][0] <= tol:
            fail(f"phase 16 {arch} scores: bf16 {out['bf16_scores'][0]:.3e} "
                 f"of max sum_d |rel*e| from the single-process step's, "
                 f"beyond {tol} ({out['routing_flips']} tokens routed "
                 f"otherwise)")
    torch.cuda.empty_cache()
    # the f32 twin: TP_LAYERS, the config's residual policy, the twin's
    # batch
    twin = configs.get(arch).with_(n_layers=TP_LAYERS, dtype="float32")
    p32 = tf.init(twin, generator=torch.Generator(device="cuda")
                  .manual_seed(0), device="cuda")
    tb = _zoo_inputs(twin, LM_TWIN_BATCH, LM_TWIN_SEQ,
                     torch.Generator(device="cuda").manual_seed(3), "cuda")
    got = steps.make_attribute_step(twin, mode="ixg", mesh=mesh)(
        dist_params.shard_params(p32, mesh), tb)
    if single:
        want = steps.make_attribute_step(twin, mode="ixg")(p32, tb)
        out["f32"] = (_rel_err(got[0], want[0]), _rel_err(got[1], want[1]))
        if not (out["f32"][0] <= DOT_TOL and out["f32"][1] <= REPLAY_TOL):
            fail(f"phase 16 {arch}: the f32 twin's logits / scores "
                 f"{out['f32'][0]:.3e} / {out['f32'][1]:.3e} of max from "
                 f"the single-process step (DOT_TOL / REPLAY_TOL)")
    del p32
    torch.cuda.empty_cache()
    return out


def _tp_train(mesh, single):
    """The train job on ``mesh``: llama3.2-1b FULL width at RESUME_LAYERS
    layers, bf16 compute, one step from the seed-0 state (timed on the
    next batch, its collective bytes); its f32 twin two steps on 2 x 16
    tokens; on rank 0 the single-process steps beside them."""
    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps, train
    cut = configs.get(TRAIN_LM_ARCH).with_(n_layers=RESUME_LAYERS)
    init = steps.make_train_state_init(cut)
    data = TokenStream(vocab=cut.vocab, seq_len=TRAIN_LM_SEQ,
                       global_batch=TRAIN_LM_BATCH)
    batches = [_batch_on(data, s) for s in range(2)]
    out = dict(ways=shd.model_ways(mesh), n_layers=cut.n_layers)

    def run(cfg, m, bs, timed=False):
        state = init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        step = train.build(cfg, total_steps=10, mesh=m)[1]
        local = steps.shard_state(state, m)
        del state
        shd.reset_model_traffic()
        metrics = []
        for b in bs:
            new, met = step(local, b)
            metrics.append({k: float(v) for k, v in met.items()})
        traffic = dict(shd.MODEL_TRAFFIC)
        ms = _tp_timed(lambda: step(local, bs[-1])) if timed else None
        whole = steps.gather_state(new, m)
        del local, new
        torch.cuda.empty_cache()
        return whole, metrics, traffic, ms

    _, met, out["traffic"], out["ms"] = run(cut, mesh, batches[:1], True)
    for k in ("loss", "ce", "gnorm"):
        if not float("-inf") < met[0][k] < float("inf"):
            fail(f"phase 16 train: {k} {met[0][k]} not finite")
    if single:
        _, one, _, out["one_ms"] = run(cut, None, batches[:1], True)
        _, f32, _, _ = run(cut.with_(dtype="float32"), None, batches[:1])
        out["bf16"] = {}
        for k in ("loss", "gnorm"):
            tp, o, w = met[0][k], one[0][k], f32[0][k]
            out["bf16"][k] = (abs(tp - o) / abs(o), abs(tp - w) / abs(w),
                              abs(o - w) / abs(w))
            if not out["bf16"][k][0] <= TP_BF16_TRAIN_TOL:
                fail(f"phase 16 train: bf16 {k} {tp!r} is "
                     f"{out['bf16'][k][0]:.3e} relative from the "
                     f"single-process step's {o!r} (TP_BF16_TRAIN_TOL)")
    twin = cut.with_(dtype="float32")
    tdata = TokenStream(vocab=twin.vocab, seq_len=16, global_batch=2)
    tbatches = [_batch_on(tdata, s) for s in range(2)]
    got, got_m, _, _ = run(twin, mesh, tbatches)
    if single:
        want, want_m, _, _ = run(twin, None, tbatches)
        worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                    for g, w in zip(got_m, want_m)
                    for k in ("loss", "ce", "gnorm"))
        moments = max(_rel_err(a, b) for a, b in zip(
            _state_leaves(got)[:-1], _state_leaves(want)[:-1])
            if b.abs().max() > 0)
        if not (worst <= DOT_TOL and moments <= REPLAY_TOL):
            fail(f"phase 16 train: the f32 twin's metrics {worst:.3e} "
                 f"(DOT_TOL) and state {moments:.3e} (REPLAY_TOL) of the "
                 f"single-process steps'")
        out["f32"] = (worst, moments)
    del got
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank, world, store, backend, jobs, out_dir):
    """One rank of a phase 16 world: ``make_host_mesh(1, world)``, each
    job's results in ``out_dir/rank<r>.json``, a failure's traceback in
    ``rank<r>.err``."""
    import traceback

    import torch.distributed as dist
    try:
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_host_mesh
        _build.library()
        mesh = make_host_mesh(1, world)
        out = dict(backend=dist.get_backend(), mesh=repr(mesh))
        for job in jobs:
            out[job] = (_tp_train(mesh, rank == 0) if job == "train"
                        else _tp_attribute(job, mesh, rank == 0))
        dist.destroy_process_group()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def _tp_world(backend, world, jobs):
    """A world of ``world`` ranks running :func:`_tp_rank`; rank 0's
    results (every rank checks its own run; rank 0 also the
    single-process steps)."""
    import multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="tp_") as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_tp_rank, args=(
            r, world, str(Path(d, "store")), backend, jobs, d))
            for r in range(world)]
        for p in procs:
            p.start()
        # a failed rank leaves the others waiting in a collective: stop
        # them at once
        deadline = time.monotonic() + TP_RANK_TIMEOUT_S
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        bad = [e.read_text() for e in (Path(d, f"rank{r}.err")
                                       for r in range(world)) if e.exists()]
        if bad or any(p.exitcode != 0 for p in procs):
            fail(f"phase 16: {backend} ranks failed (exit codes "
                 f"{[p.exitcode for p in procs]}):\n" + "\n".join(bad))
        return json.loads(Path(d, "rank0.json").read_text())


def _print_tp(what, res, jobs):
    print(f"phase 16 {what}: backend {res['backend']}, {res['mesh']}")
    for job in jobs:
        r = res[job]
        t = r["traffic"]
        line = (f"  {job:22s} model {r['ways']}, {r['n_layers']} layers: "
                f"host / device ms {r['ms'][0]:.2f} / {r['ms'][1]:.2f}, "
                f"model 1 {r['one_ms'][0]:.2f} / {r['one_ms'][1]:.2f}; "
                f"model-axis bytes all-reduce {t['all_reduce'] / 1e6:.2f} "
                f"MB, all-gather {t['all_gather'] / 1e6:.2f} MB in "
                f"{t['calls']} collectives")
        if job == "train":
            line += ("; bf16 loss / gnorm from model 1's "
                     + ", ".join(f"{k} {a:.2e} (from f32 {b:.2e}, model 1 "
                                 f"{c:.2e})"
                                 for k, (a, b, c) in r["bf16"].items())
                     + f"; f32 twin metrics {r['f32'][0]:.2e}, state "
                     f"{r['f32'][1]:.2e}")
        else:
            line += (f"; bf16 logits {r['bf16_logits'][0]:.2e} of max from "
                     f"f32 (model 1 {r['bf16_logits'][1]:.2e}), scores "
                     f"{r['bf16_scores'][0]:.2e} of max sum_d |rel*e| from "
                     f"model 1's (from f32 {r['bf16_scores'][1]:.2e}, model "
                     f"1 {r['bf16_scores'][2]:.2e}; {r['routing_flips']} "
                     f"tokens routed otherwise); f32 twin logits "
                     f"{r['f32'][0]:.2e}, scores {r['f32'][1]:.2e} of max; "
                     f"launches {r['launches']}")
        print(line)


def check_model_axis(kc, launches, multi):
    """Phase 16: (a) B13 and its backward at a model rank's shapes
    (:data:`TP_SCAN_D`) against their plain versions; (b) the model-axis
    steps in a gloo world of ranks sharing card 0 (:data:`TP_JOBS`), each
    against the single-process step by phase 13's bf16 rule and an f32
    twin; (c) with ``multi`` and 2 or more cards, NCCL worlds of 2 and 4
    ranks (:data:`TP_MULTI_JOBS`)."""
    print(f"phase 16 (a): B13 and its backward at a model rank's channels, "
          f"[{LM_BATCH},{LM_PROMPT + LM_NEW},D] bf16, D in {TP_SCAN_D}")
    gen = torch.Generator(device="cuda").manual_seed(1616)
    for d in TP_SCAN_D:
        _scan_row(kc, gen, LM_PROMPT + LM_NEW, torch.bfloat16, d,
                  every=False)
    print(f"phase 16 (b): a gloo world of {TP_ONE_CARD_RANKS} ranks sharing "
          f"card 0 (NCCL refuses two ranks on one card; gloo carries the "
          f"card's tensors through the host), make_host_mesh(1, "
          f"{TP_ONE_CARD_RANKS})")
    t0 = time.perf_counter()
    res = _tp_world("gloo", TP_ONE_CARD_RANKS, TP_JOBS)
    _print_tp("(b)", res, TP_JOBS)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s")
    totals = launches.setdefault("tp", {})
    for job in TP_JOBS:
        for k, v in res[job].get("launches", {}).items():
            totals[k] = totals.get(k, 0) + v
    out = {"b": res}
    count = torch.cuda.device_count()
    if multi and count >= 2:
        for world in (w for w in TP_WORLDS if w <= count):
            t0 = time.perf_counter()
            res = _tp_world("nccl", world, TP_MULTI_JOBS)
            _print_tp(f"(c) {world} cards", res, TP_MULTI_JOBS)
            print(f"  (c) {world} cards took "
                  f"{time.perf_counter() - t0:.1f} s")
            out[f"c{world}"] = res
    elif multi:
        print(f"phase 16 (c): the machine has {count} card: no NCCL world")
    return out


# ---------------------------------------------------------------------------


#: The counters each path must launch; the others must stay at 0 there.
PATH_KERNELS = {"f32": tuple(PER_EXPLAIN["f32"]),
                "bf16": tuple(PER_EXPLAIN["bf16"]),
                "bf16_literal": tuple(PER_LITERAL_EXPLAIN),
                "fxp16": tuple(PER_EXPLAIN["fxp16"]),
                "vjp_fused": tuple(PER_EXPLAIN_VJP["vjp_fused"]),
                "vjp_unfused": tuple(PER_EXPLAIN_VJP["vjp_unfused"]),
                "train": tuple(PER_TRAIN_STEP),
                "vjp_fused_bf16": tuple(PER_EXPLAIN_VJP["vjp_fused_bf16"]),
                "vjp_unfused_bf16": tuple(
                    PER_EXPLAIN_VJP["vjp_unfused_bf16"]),
                "train_bf16": tuple(PER_TRAIN_STEP),
                "lm": ("selective_scan", "selective_scan_bwd"),
                "lm_twin": ("selective_scan", "selective_scan_bwd"),
                "lm_zoo": ("selective_scan", "selective_scan_bwd"),
                "serve_cnn": tuple(PER_COLD_BATCH),
                "perturb_f32": tuple(PER_PERTURB["f32"]),
                "perturb_bf16": tuple(PER_PERTURB["bf16"]),
                "perturb_fxp16": tuple(PER_PERTURB["fxp16"]),
                "plan_f32": tuple(PER_EXPLAIN["f32"]),
                "plan_bf16": tuple(PER_EXPLAIN["bf16"]),
                "plan_fxp16": tuple(PER_EXPLAIN["fxp16"]),
                "train_lm": (),
                "train_cnn": tuple(PER_TRAIN_CNN_STEP),
                "dp_f32": tuple(PER_EXPLAIN["f32"]),
                "dp_bf16": tuple(PER_EXPLAIN["bf16"]),
                "dp_fxp16": tuple(PER_EXPLAIN["fxp16"]),
                "tp": ("selective_scan", "selective_scan_bwd")}
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
    ap.add_argument("--multi-device", action="store_true",
                    help="after phase 1, run phase 15 alone (on a "
                         "llama3.2-1b state drawn from seed 0 in place of "
                         "phase 14's) and stop: on a machine of several "
                         "cards, its multi-card world (e)")
    ap.add_argument("--model-axis", action="store_true",
                    help="after phase 1, run phase 16 alone and stop: on "
                         "a machine of several cards also its NCCL worlds "
                         "(c)")
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

    if args.multi_device:
        from repro_torch import configs
        from repro_torch.launch import steps
        cfg = cnn.CNNConfig()
        params = cnn.init(torch.Generator().manual_seed(0), cfg)
        x_cpu = torch.randn((BATCH, 32, 32, 3),
                            generator=torch.Generator().manual_seed(1))
        full = configs.get(TRAIN_LM_ARCH)
        state = steps.make_train_state_init(full)(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        print("phase 15 (multi-device) alone")
        launches = {}
        out = check_multi_device(params, cfg, x_cpu, launches,
                                 (state, full))
        for precision in ("f32", "bf16", "fxp16"):
            check_path_launches(f"dp_{precision}",
                                launches[f"dp_{precision}"])
        del state
        torch.cuda.empty_cache()
        out["e"] = check_multi_card(x_cpu)
        print("phase 16 (model axis) after phase 15")
        out["model_axis"] = check_model_axis(
            KernelCheck(imad_per_s, mufu_per_s), launches, multi=True)
        check_path_launches("tp", launches["tp"])
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "multi_device.json").write_text(json.dumps(dict(
                device=kind, nvidia_smi=smi, multi_device=out,
                launches=launches), indent=1))
        print(smi)
        return 0

    if args.model_axis:
        print("phase 16 (model axis) alone")
        launches = {}
        out = check_model_axis(KernelCheck(imad_per_s, mufu_per_s),
                               launches, multi=True)
        check_path_launches("tp", launches["tp"])
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            (args.out / "model_axis.json").write_text(json.dumps(dict(
                device=kind, nvidia_smi=smi, model_axis=out,
                launches=launches), indent=1))
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
    vjp_results = check_vjp(params, cfg, x_cpu, launches, entry_launches,
                            to_profile)
    for branch in ("vjp_fused", "vjp_unfused", "vjp_fused_bf16",
                   "vjp_unfused_bf16"):
        check_path_launches(branch, launches[branch])
    print(f"phase 6 (train): {TRAIN_STEPS} AdamW steps, autodiff "
          f"cross-entropy on the kernel path, batch {BATCH}")
    train_results = check_train(params, cfg, x_cpu, launches,
                                entry_launches, to_profile)
    check_path_launches("train", launches["train"])
    check_path_launches("train_bf16", launches["train_bf16"])

    # phases 7-8: LM token attribution, each explain counted from 0
    print(f"phase 7 (lm): {LM_ARCH} full width and depth, bf16, "
          f"{LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} greedy "
          f"tokens, per-token and engine explains")
    # the model stays on the card for phase 12's planned explains
    lm_state, lm_results = check_lm(launches, to_profile)
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
    torch.cuda.empty_cache()
    print(f"phase 11 (perturb): Engine.perturb at full Table III width, "
          f"batch {BATCH}, occlusion / LIME / RISE x f32 / bf16 / fxp16, "
          f"a fold of {PERTURB_BIG_SAMPLES * BATCH} rows, "
          f"{PERTURB_SERVE_N} served requests, the kernel profiler")
    perturb_results, profiled_calls = check_perturb(params, cfg, x_cpu,
                                                    launches)
    torch.cuda.empty_cache()
    print(f"phase 12 (plan): the tile planner's h100 profile at full Table "
          f"III width, batch {BATCH}, top-{SEEDS}: analytic plans, "
          f"autotuned engines, warm builds, the LM's scan, edge-tiny's "
          f"audit, the drift table")
    with tempfile.TemporaryDirectory(prefix="plan_") as tmp:
        plan_results = check_plan(params, cfg, x_cpu, launches, lm_state,
                                  Path(args.out if args.out is not None
                                       else tmp))
    del lm_state
    torch.cuda.empty_cache()
    print(f"phase 13 (lm zoo): the other nine configs at full width, bf16, "
          f"{LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_NEW} greedy tokens "
          f"(depth cut: {ZOO_DEPTH}); hymba-1.5b through B13; "
          f"{len(ZOO_TWINS)} twins in f32 and in bf16; the MoE's "
          f"determinism")
    zoo_results = check_lm_zoo(launches, to_profile)
    check_path_launches("lm_zoo", launches["lm_zoo"])
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14 (train): {TRAIN_LM_ARCH} FULL trained {TRAIN_LM_STEPS} "
          f"steps (launch.train), crash-resume and a CPU "
          f"twin at {RESUME_LAYERS} layers, the prefill / decode steps; the "
          f"Table III CNN trained {CNN_TRAIN_STEPS} steps, then explained")
    train_lm_results, lm_train_state = check_train_lm(launches, to_profile)
    check_path_launches("train_lm", launches["train_lm"])
    train_cnn_results = check_train_cnn(launches)
    check_path_launches("train_cnn", launches["train_cnn"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 (multi-device): a NCCL process group of 1 rank; the "
          f"data-parallel engines mesh:h100:{DP_SHARDS} against h100 at "
          f"full Table III width, batch {BATCH}, top-{SEEDS}, f32 / bf16 / "
          f"fxp16; {DP_TRAIN_STEPS} data-parallel {TRAIN_LM_ARCH} FULL "
          f"train steps against the plain ones; the int8 compressed "
          f"all-reduce ((e), a multi-card world, runs last)")
    multi_results = check_multi_device(params, cfg, x_cpu, launches,
                                       lm_train_state)
    del lm_train_state
    for precision in ("f32", "bf16", "fxp16"):
        check_path_launches(f"dp_{precision}", launches[f"dp_{precision}"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 16 (model axis): B13 and its backward at a model rank's "
          f"channels; the tensor / expert parallel steps ({', '.join(TP_JOBS)}"
          f") in a gloo world of {TP_ONE_CARD_RANKS} ranks on this card "
          f"against the single-process steps")
    tp_results = check_model_axis(kc, launches, multi=False)
    check_path_launches("tp", launches["tp"])

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
          "and one per-token LM explain (falcon-mamba-7b, hymba-1.5b), "
          "llama3.2-1b's train step and its clip + AdamW under "
          "torch.profiler")
    profiles = {what: profile_breakdown(fn, what, wall)
                for what, fn, wall in to_profile}
    bf16_explain = "bf16 saliency explain"
    check_bf16_kernel_names(profiles[bf16_explain], lambda: next(
        profile_breakdown(fn, what, wall) for what, fn, wall in to_profile
        if what == bf16_explain))
    print("phase 11's kernel profiler beside CUPTI: the same two calls")
    print_profiler_vs_cupti(perturb_results, profiled_calls)
    del to_profile
    gc.collect()
    torch.cuda.empty_cache()
    multi_results["e"] = check_multi_card(x_cpu)

    kernels = []
    rows = [(name, launches[KERNEL_PATH[name]][name], source, replaces)
            for name, (source, replaces) in KERNELS.items()]
    rows += [(name, route_launches["bf16"][BF16_ROUTES[name]]
              if name in BF16_ROUTES else entry_launches[
                  BF16_INSTANCE_PATHS.get(name, "bf16")][entry])
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
            lm_twin=twin_results, lm_zoo=zoo_results, serve=serve_results,
            train_lm=train_lm_results, train_cnn=train_cnn_results,
            multi_device=multi_results, model_axis=tp_results,
            perturb=perturb_results, plan=plan_results,
            scan_backward_ms=kc.scan_backward_ms,
            mma_accumulation=kc.accumulation, bf16_one_seed=kc.one_seed,
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
        "lm": {m: r["launches"] for m, r in lm_results["serve"].items()},
        "lm_zoo": {m: r["launches"] for m, r in zoo_results["archs"][
            "hymba-1.5b"]["serve"].items()}}}))
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
