#!/usr/bin/env python3
"""Where the time of the selective scan's backward (B13 bwd) goes, block by
block.

Builds an instrumented copy of the kernels (``csrc/ssm_scan_bwd.cu`` with
``clock64`` stamps between its passes and ``%globaltimer`` at a block's
start and end) into ``src/repro_torch/_build/scan_phases/`` (git-ignored),
runs the backward at falcon-mamba-7b's per-token explain shape ([4, 72,
8192], N 16, bf16 x and gy, the explain's gradients dt, x, B, C, no gh)
and hymba-1.5b's ([4, 72, 3200]), and prints per shape the blocks, the SMs
they ran on, the most blocks one SM held at once, the span from the first
block's start to the last one's end, the median block duration, and the
median SM cycles a block spends in each pass: the checkpoint pass (the
forward from h0), the segments' recompute, the adjoint, the block's dB/dC
reduction, and (the staged design) the waits for a segment's operands.
Needs one card:

    python3 tools/scan_bwd_phases.py [--package DIR] [--set NAME=VALUE ...]

``--package`` instruments another copy of ``repro_torch`` (a parent
commit's, unpacked by ``git archive``); both the staged design and the
first design (per-step loads from device memory, blocks of 32 channels
each writing its own dB/dC partials) are recognised.
``--set kMinBlocks=6`` rebuilds with a ``constexpr int`` of the kernel
source changed, to compare a knob of the design.  The stamps add a
barrier after each pass but the reduction; the timings are the
instrumented kernel's, a few % above the kernel's own.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "src" / "repro_torch" / "_build" / "scan_phases"
MAX_BLOCKS = 4096
# start, end (ns); stage, checkpoint, recompute, adjoint, reduction,
# total (cycles); SM
FIELDS = 9
PASSES = (("stage", 2), ("checkpoint", 3), ("recompute", 4),
          ("adjoint", 5), ("reduction", 6), ("total", 7))
SHAPES = (("falcon-mamba-7b", 8192), ("hymba-1.5b", 3200))

START = ("  const bool need_bc = ws_b != nullptr || ws_c != nullptr;\n")
STAMPS = ("  unsigned long long c0 = clock64(), cx = c0, cw = 0, cf = 0,\n"
          "      cr = 0, ca = 0, cb = 0, gt0, gt1;\n"
          "  unsigned smid;\n"
          "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n")
ADJOINT = "      // the adjoint, back over the segment"
TO_ADJOINT = ("      __syncthreads();\n      cr += clock64() - cx;\n"
              "      cx = clock64();\n")
END = "#pragma unroll\n  for (int j = 0; j < kSpl; ++j) {\n    if (!"
RECORD = ("  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt1));\n"
          "  {\n    const int bid = blockIdx.x + gridDim.x * blockIdx.y;\n"
          f"    if (tid == 0 && bid < {MAX_BLOCKS}) {{\n"
          "      unsigned long long* r = g_phase[bid];\n"
          "      r[0] = gt0, r[1] = gt1, r[2] = cw, r[3] = cf, r[4] = cr;\n"
          "      r[5] = ca, r[6] = cb, r[7] = clock64() - c0, r[8] = smid;\n"
          "    }\n  }\n")

# (old, new) pairs per design, on top of the shared ones
STAGED = (
    ("    for (int j = 0; j < jobs; ++j) {\n",
     "    for (int j = 0; j < jobs; ++j) {\n      cx = clock64();\n"),
    ("      if (j + kAhead < jobs) issue(j + kAhead);\n",
     "      if (j + kAhead < jobs) issue(j + kAhead);\n"
     "      cw += clock64() - cx;\n      cx = clock64();\n"),
    ("        continue;\n      }\n\n      const int k = segs",
     "        __syncthreads();\n        cf += clock64() - cx;\n"
     "        continue;\n      }\n\n      const int k = segs"),
    ("      if (!need_bc) continue;\n",
     "      __syncthreads();\n      ca += clock64() - cx;\n"
     "      cx = clock64();\n      if (!need_bc) continue;\n"),
    ("      box = box + 1 == kBoxes ? 0 : box + 1;\n",
     "      box = box + 1 == kBoxes ? 0 : box + 1;\n"
     "      cb += clock64() - cx;\n"),
    ("    if (armed && started) {",
     "    cx = clock64();\n    if (armed && started) {"),
    ("      armed = false;\n    }\n  }\n",
     "      armed = false;\n    }\n    cb += clock64() - cx;\n  }\n"),
)
FIRST = (
    ("    for (int k = 0; k < ws0 / kSeg + segs - 1; ++k) {\n",
     "    cx = clock64();\n"
     "    for (int k = 0; k < ws0 / kSeg + segs - 1; ++k) {\n"),
    ("    ckpt[(segs - 1) * kThreads + tid] = make_float4(h[0], h[1], h[2], "
     "h[3]);\n",
     "    ckpt[(segs - 1) * kThreads + tid] = make_float4(h[0], h[1], h[2], "
     "h[3]);\n    __syncthreads();\n    cf += clock64() - cx;\n"),
    ("      float hs[kSeg + 1][kSpl];\n",
     "      cx = clock64();\n      float hs[kSeg + 1][kSpl];\n"),
    ("      if (!need_bc) continue;\n",
     "      __syncthreads();\n      ca += clock64() - cx;\n"
     "      cx = clock64();\n      if (!need_bc) continue;\n"),
    ("      __syncthreads();                // before the next segment's "
     "partials\n",
     "      __syncthreads();                // before the next segment's "
     "partials\n      cb += clock64() - cx;\n"),
)


def instrument(src: str, settings: dict) -> tuple[str, str]:
    """The kernel source with the stamps, and the design's name."""
    def rep(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"scan_bwd_phases: the kernel source changed "
                             f"(no single {old.strip()[:50]!r}); update the "
                             f"anchors")
        src = src.replace(old, new)

    for name, value in settings.items():
        pat = re.compile(rf"constexpr int {name} = [^;]+;")
        if len(pat.findall(src)) != 1:
            raise SystemExit(f"scan_bwd_phases: no single constexpr {name}")
        src = pat.sub(f"constexpr int {name} = {value};", src)
    design = "first" if "struct Step" in src else "staged"
    rep("using namespace repro::scan;\n",
        "using namespace repro::scan;\n__device__ unsigned long long "
        f"g_phase[{MAX_BLOCKS}][{FIELDS}];\n")
    rep(START, START + STAMPS)
    rep(ADJOINT, TO_ADJOINT + ADJOINT)
    for old, new in (FIRST if design == "first" else STAGED):
        rep(old, new)
    rep(END, RECORD + END)
    return src + (
        "\nREPRO_API int repro_scan_bwd_phases(void* dst, int n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
        "      dst, g_phase, sizeof(unsigned long long) * "
        f"{FIELDS} * n));\n}}\n"
        "REPRO_API int repro_scan_bwd_phases_clear() {\n"
        "  void* p;\n"
        "  cudaError_t e = cudaGetSymbolAddress(&p, g_phase);\n"
        "  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_phase));\n"
        "  return static_cast<int>(e);\n}\n"), design


def most_resident(rows) -> int:
    """The most blocks that overlapped in time on one SM."""
    best = 0
    by_sm = {}
    for r in rows:
        by_sm.setdefault(r[8], []).extend(((r[0], 1), (r[1], -1)))
    for ev in by_sm.values():
        live = 0
        for _, step in sorted(ev, key=lambda e: (e[0], e[1])):
            live += step
            best = max(best, live)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", type=Path,
                    default=ROOT / "src" / "repro_torch",
                    help="the repro_torch package to instrument")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="change a constexpr int of the kernel source")
    args = ap.parse_args()
    settings = dict(s.split("=", 1) for s in args.set)
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(args.package.resolve(), COPY / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = COPY / "repro_torch" / "csrc" / "ssm_scan_bwd.cu"
    text, design = instrument(cu.read_text(), settings)
    cu.write_text(text)
    sys.path.insert(0, str(COPY))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("scan_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan_bwd
    lib = _build.library()
    lib.repro_scan_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.repro_scan_bwd_phases.restype = ctypes.c_int
    lib.repro_scan_bwd_phases_clear.argtypes = []
    lib.repro_scan_bwd_phases_clear.restype = ctypes.c_int
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(f"design: {design}" + "".join(f", {k} = {v}"
                                        for k, v in settings.items()))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    b, s, n = 4, 72, 16
    for name, d in SHAPES:
        dt = F.softplus(randn(b, s, d) - 4.6)
        x = randn(b, s, d).to(torch.bfloat16)
        ops = (dt, x, randn(b, s, n), randn(b, s, n),
               -torch.exp(randn(d, n) * 0.3), randn(b, d, n))
        gy = randn(b, s, d).to(torch.bfloat16)
        for i in range(3):
            torch.cuda.synchronize()
            if i == 2 and lib.repro_scan_bwd_phases_clear() != 0:
                raise SystemExit("scan_bwd_phases: clearing the stamps "
                                 "failed")
            selective_scan_bwd(*ops, gy, None, d_tile=d, chunk=128,
                               needs=(True, True, True, True, False, False))
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (FIELDS * MAX_BLOCKS))()
        if lib.repro_scan_bwd_phases(buf, MAX_BLOCKS) != 0:
            raise SystemExit("scan_bwd_phases: reading the stamps failed")
        rows = [r for r in (buf[FIELDS * i:FIELDS * (i + 1)]
                            for i in range(MAX_BLOCKS)) if r[1] > r[0]]
        t0 = min(r[0] for r in rows)
        span = (max(r[1] for r in rows) - t0) / 1e3
        dur = statistics.median((r[1] - r[0]) / 1e3 for r in rows)
        med = {k: statistics.median(r[i] for r in rows) for k, i in PASSES}
        print(f"{name} [{b},{s},{d}] bf16: {len(rows)} blocks on "
              f"{len({r[8] for r in rows})} SMs, at most "
              f"{most_resident(rows)} an SM at once, span {span:.2f} us, "
              f"block {dur:.2f} us (median); SM cycles a block: "
              + ", ".join(f"{k} {v:.0f}" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
