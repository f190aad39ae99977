#!/usr/bin/env python3
"""Where the time of the bf16 tensor-core conv backward goes, block by block.

Builds an instrumented copy of the kernels (``csrc/conv_bwd_mma.cu`` with
``clock64`` stamps between its phases and ``%globaltimer`` at a block's
start and end) into ``src/repro_torch/_build/phases/`` (git-ignored), runs
the four Table III backward launches of a seed-batched bf16 explain (S = 3,
N = 32) under the rule's plan (``conv_bwd_bf16_plan``) and, with
``--plans``, under a few others, and prints per launch the blocks, the SMs
they ran on, the span from the first block's start to the last one's end,
the median block duration, and the median SM cycles a block spends on each
phase: issuing the first ring stage's copies, waiting for them, the
unpool + gate prologue, the products, and the epilogue.  Needs one card:

    python3 tools/conv_bwd_phases.py [--plans]

The stamps add a barrier after the products; the timings are the
instrumented kernel's, a few % above the kernel's own.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "src" / "repro_torch" / "_build" / "phases"
FIELDS = 9  # start, end (ns), wait, expand, mma, epilogue, total, SM, issue


def instrument(src: str) -> str:
    """The kernel source with the stamps."""
    def rep(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"conv_bwd_phases: the kernel source changed "
                             f"(no single {old[:50]!r}); update the anchors")
        src = src.replace(old, new)

    rep("namespace cbm {\n",
        f"namespace cbm {{\n__device__ unsigned long long g_phase[8192]"
        f"[{FIELDS}];\n")
    rep("  if (npairs > 0) load(0, 0);\n"
        "  for (int t = 0; t < npairs; ++t) {\n",
        "  unsigned long long gt0, gt1, c0 = clock64(), cw = 0, ce = 0,\n"
        "      cm = 0, cp = 0, cx;\n"
        "  unsigned smid;\n"
        "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n"
        "  if (npairs > 0) load(0, 0);\n"
        "  const unsigned long long ci = clock64() - c0;\n"
        "  for (int t = 0; t < npairs; ++t) {\n    cx = clock64();\n")
    rep("    if (t + 1 < npairs) load((t + 1) & 1, t + 1);\n"
        "    expand(t & 1, t);\n    __syncthreads();\n",
        "    cw += clock64() - cx;\n    cx = clock64();\n"
        "    if (t + 1 < npairs) load((t + 1) & 1, t + 1);\n"
        "    expand(t & 1, t);\n    __syncthreads();\n"
        "    ce += clock64() - cx;\n    cx = clock64();\n")
    rep("    if (t % nchunks != nchunks - 1) continue;\n",
        "    __syncthreads();\n    cm += clock64() - cx;\n"
        "    cx = clock64();\n"
        "    if (t % nchunks != nchunks - 1) continue;\n")
    rep("        for (int q = 0; q < 4; ++q) run[f][j][q] = 0.f;\n  }\n}\n",
        "        for (int q = 0; q < 4; ++q) run[f][j][q] = 0.f;\n"
        "    __syncthreads();\n    cp += clock64() - cx;\n  }\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt1));\n"
        "  const int bid =\n"
        "      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *\n"
        "      blockIdx.z);\n"
        "  if (tid == 0 && bid < 8192) {\n"
        "    unsigned long long* d = g_phase[bid];\n"
        "    d[0] = gt0, d[1] = gt1, d[2] = cw, d[3] = ce, d[4] = cm;\n"
        "    d[5] = cp, d[6] = clock64() - c0, d[7] = smid, d[8] = ci;\n"
        "  }\n}\n")
    return src + (
        "\nREPRO_API int repro_conv_bwd_phases(void* dst, int n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
        f"      dst, cbm::g_phase,\n"
        f"      sizeof(unsigned long long) * {FIELDS} * n));\n}}\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true",
                    help="also time a few plans other than the rule's")
    args = ap.parse_args()
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(ROOT / "src" / "repro_torch", COPY / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = COPY / "repro_torch" / "csrc" / "conv_bwd_mma.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY))
    import torch
    if not torch.cuda.is_available():
        print("conv_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import masks
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d.conv2d import (ConvBwdMmaPlan,
                                                   conv2d_bwd_fused,
                                                   conv_bwd_bf16_plan)
    from repro_torch.kernels.pool import ref as pool_ref
    lib = _build.library()
    lib.repro_conv_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_conv_bwd_phases.restype = ctypes.c_int
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    s, n = 3, 32
    for h, c, cout, pooled in ((16, 64, 64, True), (16, 64, 32, False),
                               (32, 32, 32, True), (32, 32, 3, False)):
        y = randn(n, h, h, c)
        hg = h // 2 if pooled else h
        g = randn(s, n, hg, hg, c, scale=1e-2).to(torch.bfloat16)
        wt = randn(3, 3, c, cout, scale=0.1).to(torch.bfloat16)
        kw = dict(pool_idx=(pool_ref.maxpool_fwd(torch.clamp_min(y, 0))[1]
                            if pooled else None),
                  relu_mask=masks.pack_mask(y > 0), gate=True,
                  method="saliency")
        rule = conv_bwd_bf16_plan(s, n, h, h, c, cout, 3, pooled=pooled)
        plans = [rule]
        if args.plans:   # one seed a warp, at two rows a warp and at one
            tco = min(rule.tco, 32)
            plans += [p for p in (ConvBwdMmaPlan(4, 2, tco, c, 1, s),
                                  ConvBwdMmaPlan(2, 1, tco, c, 1, s))
                      if p != rule]
        for plan in plans:
            for _ in range(3):
                conv2d_bwd_fused(g, wt, plan=plan, **kw)
            torch.cuda.synchronize()
            nb = plan.blocks(n, h, h, cout)
            buf = (ctypes.c_ulonglong * (FIELDS * nb))()
            if lib.repro_conv_bwd_phases(buf, nb) != 0:
                raise SystemExit("conv_bwd_phases: reading the stamps failed")
            rows = [buf[FIELDS * i:FIELDS * (i + 1)] for i in range(nb)]
            t0 = min(r[0] for r in rows)
            span = (max(r[1] for r in rows) - t0) / 1e3
            dur = statistics.median((r[1] - r[0]) / 1e3 for r in rows)
            med = {k: statistics.median(r[i] for r in rows) for k, i in
                   (("issue", 8), ("wait", 2), ("prologue", 3),
                    ("products", 4), ("epilogue", 5), ("total", 6))}
            print(f"[{s},{n},{hg},{hg},{c}]->{cout}"
                  + (" pool" if pooled else "") + f" {plan}: {nb} blocks on "
                  f"{len({r[7] for r in rows})} SMs, span {span:.2f} us, "
                  f"block {dur:.2f} us (median); SM cycles a block: "
                  + ", ".join(f"{k} {v:.0f}" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
