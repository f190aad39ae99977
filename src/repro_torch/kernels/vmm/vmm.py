"""FC matmul kernels (paper §III.C, §III.E): forward and fused backward.

:func:`vmm` wraps ``repro_vmm_fwd`` of ``csrc/vmm.cu`` (the port of
``repro.kernels.vmm.vmm.vmm_pallas``), with the FC bias added in its
epilogue.  The forward splits K across blocks: :func:`vmm_splits` chooses
the number of slices from the shape, and with more than one the wrapper
hands the kernel a ``[splits, M, N]`` f32 workspace, which a second kernel
of the same entry point sums in slice order.  :func:`vmm_bwd_fused` wraps
``repro_vmm_bwd_fused`` (the port of ``vmm_bwd_fused_pallas``): the 1-bit mask gate runs on the gradient as it
is loaded, then the product with ``W^T``, then an optional epilogue gate —
an FC layer's whole backward step in one launch, all S seeds sharing the
stored mask.  :func:`vmm_bwd_fused_plain` is that kernel's plain twin.

The int16 twins (``vmm.fxp``) share the argument contract, checks and plain
dataflow defined here; only the element type, the entry point and the
product itself differ.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import (METHOD_CODES, _build, check,
                                 check_kernel_operands, on_card,
                                 validate_bp_gates)
from repro_torch.kernels.relu_mask.relu_mask import gate_gradient, unpack_bits
from repro_torch.kernels.tiling import H100_SMS, align_up, cdiv, mask_bytes
from repro_torch.kernels.vmm import ref

#: The split-K forward's output tile and K chunk (``csrc/vmm.cu`` SK_BM,
#: SK_BN, SK_KC): a slice of K is a whole number of chunks.
SPLIT_TILE_M, SPLIT_TILE_N, SPLIT_CHUNK_K = 32, 32, 32


def vmm_max_splits(k: int) -> int:
    """The most slices K can be cut into: one chunk each."""
    return max(1, cdiv(k, SPLIT_CHUNK_K))


def vmm_slice(k: int, splits: int) -> int:
    """Length of each K slice for ``splits`` slices (the last may be
    shorter): a whole number of chunks, at least one."""
    return align_up(max(1, cdiv(k, splits)), SPLIT_CHUNK_K)


def vmm_splits(m: int, k: int, n: int) -> int:
    """Number of K slices for ``[m, k] @ [k, n]`` on an H100.

    One slice, with no second pass, where K is at most four chunks or the
    output tiles alone fill the card; otherwise enough slices for about two
    blocks per SM, each at least one chunk long, and none empty.
    """
    tiles = cdiv(m, SPLIT_TILE_M) * cdiv(n, SPLIT_TILE_N)
    if k <= 4 * SPLIT_CHUNK_K or tiles >= H100_SMS:
        return 1
    per = vmm_slice(k, cdiv(2 * H100_SMS, tiles))
    return cdiv(k, per)


def _vmm_dims(name: str, x: torch.Tensor, w: torch.Tensor):
    """``(m, k, n)`` of ``[M, K] @ [K, N]``, or raise."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: need [M, K] @ [K, N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def vmm_fwd(name: str, counter: str, entry: str, dtype: torch.dtype,
            plain: Callable, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor], extra: tuple = ()) -> torch.Tensor:
    """Check, then run ``plain(x, w, b)`` on the CPU or launch ``entry``
    with ``extra`` after its common arguments."""
    m, k, n = _vmm_dims(name, x, w)
    check(name, x, dtype, what="x")
    check(name, w, dtype, what="w")
    if b is not None:
        check(name, b, dtype, (n,), what="b")
    if not on_card(name, x, w, b):
        return plain(x, w, b)
    check_kernel_operands(name, x, w, b)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel():
        _build.launch(counter, entry, x.device, x.data_ptr(), w.data_ptr(),
                      _build.ptr(b), y.data_ptr(), m, k, n, *extra)
    return y


def _vmm_plain(x, w, b):
    y = ref.vmm(x, w)
    return y if b is None else y + b


def vmm(x: torch.Tensor, w: torch.Tensor,
        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, K] @ [K, N] (+ b [N]) -> [M, N], f32 accumulation.

    CPU tensors run :func:`ref.vmm` (then ``+ b``); CUDA tensors the kernel,
    with :func:`vmm_splits` slices of K.
    """
    return vmm_with_splits(x, w, b)


def vmm_with_splits(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    splits: Optional[int] = None) -> torch.Tensor:
    """:func:`vmm` with the number of K slices (1 to :func:`vmm_max_splits`)
    chosen by the caller, for tests and sweeps; one count of ``vmm_fwd``
    per call, whatever the split.  The slices are :func:`vmm_slice` long
    and as many as K fills, so none is empty."""
    m, k, n = _vmm_dims("vmm", x, w)
    if splits is None:
        splits = vmm_splits(m, k, n)
    elif not 1 <= splits <= vmm_max_splits(k):
        raise ValueError(f"vmm: splits={splits} not in [1, "
                         f"{vmm_max_splits(k)}] for K = {k}")
    ks = vmm_slice(k, splits)
    splits = max(1, cdiv(k, ks))
    # the kernel's [splits, M, N] partial sums where K is split (the plain
    # version leaves them unused)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    return vmm_fwd("vmm", "vmm_fwd", "repro_vmm_fwd", torch.float32,
                   _vmm_plain, x, w, b, (_build.ptr(part), splits, ks))


def bwd_fused_plain(matmul: Callable, g, w, *, relu_mask=None, gate=None,
                    method="saliency", out_relu_mask=None, out_gate=None):
    """Gate, ``matmul(g, w)``, gate, as separate PyTorch ops."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 3
    if not seeded:
        g = g[None]
    k, n = w.shape
    if gate:
        bits = None if relu_mask is None else unpack_bits(relu_mask)[:, :k]
        g = gate_gradient(g, bits, method)
    out = matmul(g, w)
    if out_gate:
        bits = (None if out_relu_mask is None
                else unpack_bits(out_relu_mask)[:, :n])
        out = gate_gradient(out, bits, method)
    return out if seeded else out[0]


def vmm_bwd_fused_plain(g, w, **kw):
    """Plain twin of :func:`vmm_bwd_fused`: gate, matmul, gate, as separate
    PyTorch ops."""
    return bwd_fused_plain(torch.matmul, g, w, **kw)


def bwd_fused(name: str, entry: str, dtype: torch.dtype, plain: Callable,
              g: torch.Tensor, w: torch.Tensor, *, relu_mask, gate, method,
              out_relu_mask, out_gate) -> torch.Tensor:
    """Check the fused-backward operands, then run ``plain`` on the CPU or
    launch ``entry`` (counted under ``name``)."""
    gate, out_gate = validate_bp_gates(method, gate, relu_mask, out_gate,
                                       out_relu_mask)
    seeded = g.dim() == 3
    g3 = g if seeded else g[None]
    if g3.dim() != 3 or w.dim() != 2 or g3.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: need g [S, M, K] and w [K, N], got "
                         f"{tuple(g.shape)}, {tuple(w.shape)}")
    s, m, k = g3.shape
    n = w.shape[1]
    check(name, g3, dtype, what="g")
    check(name, w, dtype, what="w")
    if relu_mask is not None:
        check(name, relu_mask, torch.uint8, (m, mask_bytes(k)),
              what="relu_mask")
    if out_relu_mask is not None:
        check(name, out_relu_mask, torch.uint8, (m, mask_bytes(n)),
              what="out_relu_mask")
    if not on_card(name, g3, w, relu_mask, out_relu_mask):
        return plain(g, w, relu_mask=relu_mask, gate=gate, method=method,
                     out_relu_mask=out_relu_mask, out_gate=out_gate)
    check_kernel_operands(name, g3, w, relu_mask, out_relu_mask)
    out = torch.empty((s, m, n), dtype=g.dtype, device=g.device)
    if out.numel():
        _build.launch(name, entry, g.device, g3.data_ptr(), w.data_ptr(),
                      _build.ptr(relu_mask), _build.ptr(out_relu_mask),
                      out.data_ptr(), s, m, k, n, int(gate), int(out_gate),
                      METHOD_CODES[method])
    return out if seeded else out[0]


def vmm_bwd_fused(g: torch.Tensor, w: torch.Tensor, *,
                  relu_mask: Optional[torch.Tensor] = None,
                  gate: Optional[bool] = None,
                  method: str = "saliency",
                  out_relu_mask: Optional[torch.Tensor] = None,
                  out_gate: Optional[bool] = None) -> torch.Tensor:
    """One launch for an FC layer's whole backward step.

    ``g``: [M, K] or seed-batched [S, M, K] gradients w.r.t. the FC output.
    ``w``: [K, N], the TRANSPOSED weight (``W.T``, made contiguous once by
    the caller).  ``relu_mask``: [M, ceil(K/8)] packed mask of the layer's
    ReLU; ``gate=True`` with no mask selects the deconvnet rule.
    ``out_relu_mask``/``out_gate``: epilogue gate on the outgoing gradient,
    [M, ceil(N/8)].  Masks carry no seeds axis — shared across S.
    CPU tensors run :func:`vmm_bwd_fused_plain`; CUDA tensors the kernel.
    """
    return bwd_fused("vmm_bwd_fused", "repro_vmm_bwd_fused", torch.float32,
                     vmm_bwd_fused_plain, g, w, relu_mask=relu_mask,
                     gate=gate, method=method, out_relu_mask=out_relu_mask,
                     out_gate=out_gate)
