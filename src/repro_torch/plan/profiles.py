"""DeviceProfile — the resource envelope the planner fits tiles into.

The JAX package's analytic profiles, field for field (``repro.plan.
profiles``): an on-chip (VMEM) byte budget, the vector-unit geometry
every TPU block shape aligns to, and the bandwidth / compute peaks its
cost model converts footprints into time with:

  * ``detected`` — the host: on an NVIDIA card the ``h100`` profile below;
    elsewhere the JAX package's 16 MB ``detected`` profile, so a plan made
    on the CPU is the plan the reference makes there;
  * ``tpu-v4`` — an explicit full-size TPU core target;
  * ``edge-large`` / ``edge-small`` / ``edge-tiny`` — constrained 4/2/1 MB
    on-chip budgets mirroring the paper's edge-FPGA deployment points;
  * ``mesh:<profile>:<n>`` — a :class:`MeshProfile`: N cores of
    ``<profile>``; the planner splits the batch and seeds axes across the
    cores first, then tiles the per-core slice.

On the card these plans are audits: a TPU tile sizes a VMEM block that
the CUDA kernels do not have, so an engine planned for ``edge-small``
checks its budget (and raises ``InfeasiblePlanError`` before any launch)
exactly as the JAX package does, and its kernels launch under the card's
own choices.

``h100`` (:class:`GpuProfile`) is the card's own profile: its plans are
the CUDA kernels' launch objects (``ConvPlan``, ``VmmBwdPlan``, ...).  The
SM count and shared-memory sizes come from
``torch.cuda.get_device_properties`` of the current device at run time,
the bandwidth and peak rates from the card's data sheet, keyed on its
name.  Without a card there is no ``h100`` profile: :func:`get_profile`
raises, and tests build one from an explicit properties record
(:func:`gpu_profile`).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from types import SimpleNamespace
from typing import Dict, Tuple

#: The JAX package's TPU alignment geometry (``repro.kernels.tiling``):
#: second-to-last block dims are multiples of SUBLANE, last ones of LANE.
SUBLANE = 8
LANE = 128

MB = 1 << 20


@dataclass(frozen=True)
class DeviceProfile:
    """A planning target: alignment geometry + resource budget + peaks."""

    name: str
    #: on-chip working-set budget every kernel invocation must fit (bytes).
    vmem_bytes: int
    #: second-to-last block-dim multiple (f32 VPU rows).
    sublane: int = SUBLANE
    #: last block-dim multiple (VPU lanes / MXU edge).
    lane: int = LANE
    #: MXU/MAC-array edge — tiles at or above this saturate the array.
    mxu: int = 128
    #: DRAM/HBM bandwidth the cost model charges traffic against (GB/s).
    hbm_gbps: float = 100.0
    #: peak MAC throughput at full utilization (TFLOP/s).
    mxu_tflops: float = 10.0

    def __post_init__(self):
        if self.vmem_bytes <= 0:
            raise ValueError(f"vmem_bytes must be positive, got "
                             f"{self.vmem_bytes}")

    @property
    def cache_device(self) -> str:
        """The planning target as the tuning cache keys it."""
        return self.name


@dataclass(frozen=True)
class MeshProfile(DeviceProfile):
    """N identical cores, each with a per-core :class:`DeviceProfile`
    envelope (every inherited field is PER CORE); ``n_shards`` is the mesh
    extent the planner splits the batch / seeds axes over."""

    n_shards: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    @property
    def core(self) -> DeviceProfile:
        """The per-core envelope this mesh replicates."""
        return DeviceProfile(
            name=self.name.split(":")[1] if ":" in self.name else self.name,
            vmem_bytes=self.vmem_bytes, sublane=self.sublane,
            lane=self.lane, mxu=self.mxu, hbm_gbps=self.hbm_gbps,
            mxu_tflops=self.mxu_tflops)


@dataclass(frozen=True)
class GpuProfile(DeviceProfile):
    """One NVIDIA card.  ``vmem_bytes`` is the shared memory a block may
    opt in to, ``hbm_gbps`` / ``mxu_tflops`` the data sheet's HBM rate and
    f32 peak; the other peaks are per operand type, as the kernel table's
    bound takes them (``PERF.md`` §6)."""

    #: the card's name (``torch.cuda.get_device_name``).
    card: str = ""
    #: streaming multiprocessors.
    sms: int = 0
    #: shared memory of one SM in all (bytes), of which the card reserves
    #: :data:`SMEM_RESERVED` per resident block.
    smem_per_sm: int = 0
    #: threads and blocks one SM holds at most.
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32
    #: dense bf16 tensor-core peak (FLOP/s), IMAD peak (int32
    #: multiply-adds/s), SFU ``exp`` peak (/s).
    bf16_flops: float = 0.0
    imad_ops: float = 0.0
    exp_ops: float = 0.0

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def f32_flops(self) -> float:
        return self.mxu_tflops * 1e12

    @property
    def cache_device(self) -> str:
        """The profile name with the card's name and SM count, so a cache
        written on one card (an H100 PCIe's 114 SMs) is never read on
        another (an SXM's 132)."""
        return f"{self.name}/{self.card}/{self.sms}sm"


#: Shared memory the card reserves per resident block (bytes).
SMEM_RESERVED = 1024

#: Data-sheet rates by card name (NVIDIA H100 SXM at 700 W): HBM3 3.35
#: TB/s, f32 67 TFLOP/s, dense bf16 989 TFLOP/s; IMAD = 132 SMs x 64 lanes
#: x 1980 MHz, SFU ``exp`` = 132 x 16 x 1980 MHz (upper bounds: the
#: sustained clock under load may be lower).  The same rates as the kernel
#: table's bound column.
DATASHEETS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_gbps=3350.0, mxu_tflops=67.0,
                                  bf16_flops=989e12, imad_ops=1.673e13,
                                  exp_ops=4.182e12),
}

#: An explicit properties record with the H100 SXM's values, for planning
#: without a card (tests): 132 SMs, 232,448 B a block, 233,472 B an SM.
H100_SXM_PROPERTIES = SimpleNamespace(
    name="NVIDIA H100 80GB HBM3", multi_processor_count=132,
    shared_memory_per_block_optin=232448,
    shared_memory_per_multiprocessor=233472,
    max_threads_per_multi_processor=2048)


def gpu_profile(props, name: str = "h100") -> GpuProfile:
    """The profile of a card from its properties record (the fields of
    ``torch.cuda.get_device_properties``: ``name``,
    ``multi_processor_count``, ``shared_memory_per_block_optin``,
    ``shared_memory_per_multiprocessor``); its rates from
    :data:`DATASHEETS` by the card's name."""
    card = props.name
    sheet = DATASHEETS.get(card)
    if sheet is None:
        raise ValueError(f"no data sheet for card {card!r}; the h100 profile "
                         f"knows {tuple(DATASHEETS)}")
    return GpuProfile(
        name=name, vmem_bytes=int(props.shared_memory_per_block_optin),
        mxu=16, card=card, sms=int(props.multi_processor_count),
        smem_per_sm=int(props.shared_memory_per_multiprocessor),
        threads_per_sm=int(getattr(props, "max_threads_per_multi_processor",
                                   2048)),
        **sheet)


def h100() -> GpuProfile:
    """The current card's profile, read at run time; raises without one."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the h100 profile reads the card (torch.cuda."
            "get_device_properties) and no CUDA device is available; plan "
            "for an analytic profile, or build one from a properties "
            "record with repro_torch.plan.profiles.gpu_profile")
    return gpu_profile(torch.cuda.get_device_properties(
        torch.cuda.current_device()))


@dataclass(frozen=True)
class GpuMeshProfile(MeshProfile, GpuProfile):
    """N cards, each with the :class:`GpuProfile` envelope: the planner
    splits the batch / seeds axes over the cards first, then plans each
    card's launch objects at its slice (``mesh:h100:<n>``)."""

    @property
    def core(self) -> GpuProfile:
        kw = {f.name: getattr(self, f.name) for f in fields(GpuProfile)}
        return GpuProfile(**dict(kw, name=self.name.split(":")[1]))


def mesh_profile(core, n_shards: int) -> MeshProfile:
    """N-core mesh of ``core`` (a profile name or :class:`DeviceProfile`),
    named ``mesh:<core>:<n>``; a mesh of cards is a
    :class:`GpuMeshProfile`."""
    base = get_profile(core)
    if isinstance(base, MeshProfile):
        raise ValueError(f"cannot nest meshes: {base.name!r}")
    cls = GpuMeshProfile if isinstance(base, GpuProfile) else MeshProfile
    kw = {f.name: getattr(base, f.name) for f in fields(type(base))}
    kw.update(name=f"mesh:{base.name}:{int(n_shards)}",
              n_shards=int(n_shards))
    return cls(**kw)


PROFILES: Dict[str, DeviceProfile] = {
    p.name: p for p in (
        DeviceProfile("tpu-v4", vmem_bytes=16 * MB, mxu=128,
                      hbm_gbps=1200.0, mxu_tflops=137.5),
        # Paper-style edge targets: small on-chip budgets, narrow MAC
        # arrays, DDR-class bandwidth.
        DeviceProfile("edge-large", vmem_bytes=4 * MB, mxu=64,
                      hbm_gbps=25.6, mxu_tflops=1.0),
        DeviceProfile("edge-small", vmem_bytes=2 * MB, mxu=32,
                      hbm_gbps=12.8, mxu_tflops=0.5),
        DeviceProfile("edge-tiny", vmem_bytes=1 * MB, mxu=16,
                      hbm_gbps=6.4, mxu_tflops=0.25),
    )
}


def detect() -> DeviceProfile:
    """The profile of the host: the card's (``h100``) where CUDA is
    available, else the JAX package's 16 MB ``detected`` profile."""
    import torch
    if torch.cuda.is_available():
        return h100()
    return DeviceProfile("detected", vmem_bytes=16 * MB, mxu=128,
                         hbm_gbps=1200.0, mxu_tflops=137.5)


def profile_names() -> Tuple[str, ...]:
    """Single-core names accepted by :func:`get_profile` /
    ``EngineSpec(device=...)``; ``mesh:<name>:<n>`` is accepted on top."""
    return ("detected",) + tuple(PROFILES) + ("h100",)


def get_profile(name) -> DeviceProfile:
    """Resolve a profile by name (``None``/"detected" -> :func:`detect`,
    "h100" -> the card's, ``mesh:<profile>:<n>`` -> :func:`mesh_profile`),
    or pass a :class:`DeviceProfile` through unchanged."""
    if isinstance(name, DeviceProfile):
        return name
    if name is None or name == "detected":
        return detect()
    if name == "h100":
        return h100()
    if isinstance(name, str) and name.startswith("mesh:"):
        parts = name.split(":")
        if len(parts) != 3 or not parts[2].isdigit() or int(parts[2]) < 1:
            raise ValueError(
                f"malformed mesh profile {name!r}; expected "
                f"mesh:<profile>:<n> with n >= 1, e.g. 'mesh:edge-small:4'")
        return mesh_profile(parts[1], int(parts[2]))
    try:
        return PROFILES[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown device profile {name!r}; choose from "
                         f"{profile_names()} or 'mesh:<profile>:<n>'"
                         ) from None
