"""Build, load and launch the CUDA kernels of ``repro_torch/csrc/``.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Each ``csrc/*.cu`` compiles to an object file in its own ``nvcc`` process,
all started together, and the objects link into
``repro_torch/_build/libreprotorch_<hash>.so``; the hash covers the sources
and flags, so an edited source rebuilds.  ``nvcc`` is looked up in
``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda/bin``.

Nothing here runs at import time: :func:`library` builds and loads on the
first kernel launch, so CPU-only installs import the package without a
compiler.  Every C entry point takes device pointers, sizes and a
``cudaStream_t`` and returns ``cudaGetLastError()``; :func:`launch` raises on
a non-zero code and counts the launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: Where the CUDA toolkit puts nvcc when neither $CUDA_HOME nor PATH names it.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry point -> argtypes (pointers and the stream as void*, sizes int).
SIGNATURES = {
    "repro_relu_fwd": [_P, _P, _P, _I, _I, _P],
    "repro_maxpool_fwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    # f32 forward: x, w, bias, y, m, k, n, then the split-K workspace, the
    # number of K slices and their length
    "repro_vmm_fwd": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    "repro_vmm_bwd_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    # f32 forward: x, w, bias, y, n, h, w, cin, cout, k, then the tile plan
    # (rows, pixels per thread, Cout per block, Cin per stage)
    "repro_conv2d_fwd": [_P, _P, _P, _P] + [_I] * 10 + [_P],
    "repro_conv2d_bwd_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
    # the fxp16 path: int16 instances of B2/B3 and the int16 kernels B7-B10
    "repro_relu_fwd_i16": [_P, _P, _P, _I, _I, _P],
    "repro_maxpool_fwd_i16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_conv2d_fxp_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_conv2d_bwd_fused_fxp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _P],
    "repro_vmm_fxp_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_vmm_bwd_fused_fxp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _P],
    # the autograd paths: B11 and B12 (f32, and int16 for the unpool)
    "repro_relu_bwd": [_P, _P, _P, _I, _I, _I, _P],
    "repro_unpool_bwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_unpool_bwd_i16": [_P, _P, _P, _I, _I, _I, _I, _P],
    # LM token attribution: B13, x in f32 or bf16
    "repro_selective_scan": [_P] * 8 + [_I] * 6 + [_P],
    "repro_selective_scan_bf16": [_P] * 8 + [_I] * 6 + [_P],
}

#: Launches per kernel wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else, so a run
#: can show that its path went through the kernels.  The int16 instances of
#: ReLU+mask, pool and unpool count under ``relu_fwd``, ``maxpool_fwd`` and
#: ``unpool_bwd``, both element types of the scan under ``selective_scan``.
LAUNCHES: Dict[str, int] = {
    "conv2d_fwd": 0, "relu_fwd": 0, "maxpool_fwd": 0, "vmm_fwd": 0,
    "conv2d_bwd_fused": 0, "vmm_bwd_fused": 0,
    "conv2d_fxp_fwd": 0, "conv2d_bwd_fused_fxp": 0, "vmm_fxp_fwd": 0,
    "vmm_bwd_fused_fxp": 0, "relu_bwd": 0, "unpool_bwd": 0,
    "selective_scan": 0,
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("repro_torch: a CUDA tensor needs the kernels, and "
                       "no nvcc was found ($CUDA_HOME/bin, PATH, "
                       "/usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the library.

    Returns its path; a library already built from the same sources is
    reused.  ``nvcc``'s output (``-Xptxas=-v``: registers, shared memory,
    spills per kernel) is kept in ``build.log`` beside it.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    cus, _ = _sources()
    tmp = BUILD_DIR / f"tmp_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for cu in cus:
        obj = tmp / (cu.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu),
               "-o", str(obj)]
        procs.append((cu, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for cu, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {cu.name} (rc {p.returncode})\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(cu.name)
    if not failed:
        so = tmp / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"repro_torch: nvcc failed on {failed}:\n"
                           + "\n".join(log))
    os.replace(so, out)            # atomic: a concurrent build wins cleanly
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_set_device.argtypes = [ctypes.c_int]
        lib.repro_set_device.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(counter: str, entry: str, device, *args) -> None:
    """Call one C entry point on ``device`` and PyTorch's current stream
    there; raise on error.

    ``args`` are the entry point's arguments without the trailing stream.
    The library's CUDA runtime keeps its own current device, so it is set
    to the operands' device before every launch.
    """
    import torch
    lib = library()
    rc = lib.repro_set_device(device.index)
    if rc == 0:
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    LAUNCHES[counter] += 1


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()
