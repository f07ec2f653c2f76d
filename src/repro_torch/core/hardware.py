"""Hardware architecture description (COMET §II Fig. 2(b), §V Table V).

An :class:`Arch` describes a spatial accelerator:

    DRAM -> per-cluster Global Buffer (GB) -> per-core IB/WB/OB ->
    GEMM unit (grid of systolic arrays) + SIMD unit

Clusters are connected by a cluster-level NoC mesh; cores within a cluster
by a core-level NoC mesh.  The same dataclass family also hosts the TPU-v5e
adaptation used by the framework integration (HBM->VMEM->MXU/VPU; the ICI
torus plays the role of the cluster NoC).

Energy constants: the paper derives DRAM energy from DRAMPower (DDR4),
SRAM energies from CACTI-7 and compute energies from synthesized
DesignWare IP.  Those toolchains are not available offline, so we use
published-ballpark constants (documented inline); see DESIGN.md §8 —
*ratios*, not absolute joules, are the validation target.

Port-local copy of ``repro/core/hardware.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_overlap.py`` holds it to the original
field by field.  Two differences: the calibration file loader
(``repro.calibrate.persist``) is not ported yet, so a ``calibrated=`` path
raises ``NotImplementedError`` (see :func:`_coerce_calibrated_noc`); and
the port adds :func:`h100`, its card, to ``PRESETS``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

__all__ = [
    "MemLevel",
    "NoCParams",
    "GemmUnit",
    "SimdUnit",
    "Arch",
    "apply_calibration",
    "edge",
    "cloud",
    "tpu_v5e",
    "tileflow_like",
    "h100",
    "PRESETS",
]

GIGA = 1e9


@dataclass(frozen=True)
class MemLevel:
    """One memory level. Bandwidth in bytes/s, energy in pJ/byte."""

    name: str
    size_bytes: int
    bandwidth: float
    read_energy_pj_per_byte: float
    write_energy_pj_per_byte: float
    double_buffered: bool = True

    def access_energy(self, read_bytes: float, write_bytes: float) -> float:
        """Energy in pJ."""
        return (read_bytes * self.read_energy_pj_per_byte
                + write_bytes * self.write_energy_pj_per_byte)


@dataclass(frozen=True)
class NoCParams:
    """Network-on-chip parameters for Eq. 3 (HiSIM/Orion model).

    t_router/t_enq in seconds; channel_width in links (bytes moved per
    enqueue slot); channel_bandwidth in bytes/s (effective BW cap used for
    the MemLat term of collective ops, Eq. 1/4); hop energy in pJ/byte/hop.
    """

    mesh: Tuple[int, int]
    channel_width: int
    channel_bandwidth: float
    t_router: float
    t_enq: float
    hop_energy_pj_per_byte: float = 0.1

    @property
    def num_nodes(self) -> int:
        return self.mesh[0] * self.mesh[1]

    def manhattan(self, a: int, b: int) -> int:
        """Manhattan hop distance between linear node ids on the mesh."""
        r, c = self.mesh
        ax, ay = divmod(a, c)
        bx, by = divmod(b, c)
        return abs(ax - bx) + abs(ay - by)


@dataclass(frozen=True)
class GemmUnit:
    """Grid of systolic arrays (SCALE-Sim-style analytical timing)."""

    array_rows: int = 32
    array_cols: int = 32
    grid: Tuple[int, int] = (8, 8)
    freq_hz: float = 1.0 * GIGA
    mac_energy_pj: float = 0.5  # bf16 MAC, 32nm-ballpark

    @property
    def num_arrays(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def peak_macs_per_sec(self) -> float:
        return self.num_arrays * self.array_rows * self.array_cols * self.freq_hz

    @property
    def peak_flops(self) -> float:
        return 2.0 * self.peak_macs_per_sec


@dataclass(frozen=True)
class SimdUnit:
    lanes: int = 256
    freq_hz: float = 1.0 * GIGA
    op_energy_pj: float = 0.3

    @property
    def peak_ops_per_sec(self) -> float:
        return self.lanes * self.freq_hz


@dataclass(frozen=True)
class Arch:
    """Full accelerator description."""

    name: str
    dram: MemLevel
    gb: MemLevel          # per-cluster global buffer
    ib: MemLevel          # per-core input buffer
    wb: MemLevel          # per-core weight buffer
    ob: MemLevel          # per-core output buffer
    cluster_noc: NoCParams
    core_noc: NoCParams
    gemm_unit: GemmUnit
    simd_unit: SimdUnit

    @property
    def num_clusters(self) -> int:
        return self.cluster_noc.num_nodes

    @property
    def cores_per_cluster(self) -> int:
        return self.core_noc.num_nodes

    @property
    def total_cores(self) -> int:
        return self.num_clusters * self.cores_per_cluster

    def level(self, name: str) -> MemLevel:
        m = {lvl.name: lvl for lvl in (self.dram, self.gb, self.ib, self.wb, self.ob)}
        return m[name]

    # Order of levels root->leaf used by the mapping tree.
    LEVELS: Tuple[str, ...] = ("DRAM", "GB", "OB")

    def parent_of(self, level: str) -> Optional[str]:
        order = list(self.LEVELS)
        i = order.index(level)
        return order[i - 1] if i > 0 else None

    def signature(self) -> Tuple:
        """Hashable identity covering *every* architecture parameter.

        Evaluation caches must key on this, never on ``name`` alone: two
        Arch instances sharing a name but differing in bandwidth/capacity
        are different machines and must not reuse each other's results.
        Enumerated via ``dataclasses.fields`` so fields added later are
        covered automatically; all members are frozen dataclasses / tuples,
        so the tuple is hashable and equality tracks parameter equality.

        Memoized on the (frozen) instance: this sits on the hot search
        path as the cache-key prefix of every grid/spec lookup, so the
        field tuple is built once per Arch object.  ``dataclasses.replace``
        constructs a fresh instance, so derived Archs never inherit a
        stale signature.
        """
        sig = self.__dict__.get("_signature_memo")
        if sig is None:
            sig = tuple(getattr(self, f.name) for f in fields(self))
            object.__setattr__(self, "_signature_memo", sig)
        return sig

    def spatial_fanout(self, level: str) -> int:
        """Number of peer instances of ``level`` under one parent instance."""
        if level == "DRAM":
            return 1
        if level == "GB":
            return self.num_clusters
        return self.cores_per_cluster  # IB/WB/OB are per-core

    def peak_flops_total(self) -> float:
        return self.gemm_unit.peak_flops * self.total_cores


# ----------------------------------------------------------- calibration


def _coerce_calibrated_noc(calibrated) -> Optional[NoCParams]:
    """Resolve a ``calibrated=`` argument to the NoCParams carrying the
    measured timing constants.

    Accepts a :class:`NoCParams` or a calibration object (anything with a
    ``params`` NoCParams attribute).  The JAX package also takes a path to
    a persisted ``calibrated_noc.json``; its loader (``calibrate/persist``)
    is not ported yet, so a path raises ``NotImplementedError`` here.
    """
    if calibrated is None:
        return None
    if isinstance(calibrated, NoCParams):
        return calibrated
    params = getattr(calibrated, "params", None)
    if isinstance(params, NoCParams):
        return params
    raise NotImplementedError(
        f"calibrated={calibrated!r}: loading a persisted calibration file "
        f"needs calibrate/persist, which the port does not have yet; pass "
        f"a NoCParams or an object with a .params NoCParams")


def apply_calibration(arch: Arch, calibrated, *,
                      core_noc: bool = False) -> Arch:
    """Return ``arch`` with its cluster NoC's *timing* constants replaced
    by measured-and-fitted values (the calibration loop).

    Only the three fitted constants transfer — ``channel_bandwidth``,
    ``t_router`` (per hop) and ``t_enq`` (per enqueue slot) — because
    they are mesh-shape-independent; the preset's mesh geometry, channel
    width and hop energy are kept.  ``core_noc=True`` additionally
    applies the same constants to the core-level NoC.  The replaced
    NoCParams flows through ``Arch.signature()``, so every downstream
    cache (factor tables, search grids, plan fingerprints) sees the
    calibrated machine as distinct from the preset.

    A ``calibrated`` that resolves to nothing (e.g. a missing or stale
    ``calibrated_noc.json``) returns ``arch`` unchanged.
    """
    noc = _coerce_calibrated_noc(calibrated)
    if noc is None:
        return arch
    def patch(base: NoCParams) -> NoCParams:
        return replace(base, channel_bandwidth=noc.channel_bandwidth,
                       t_router=noc.t_router, t_enq=noc.t_enq)
    out = replace(arch, cluster_noc=patch(arch.cluster_noc))
    if core_noc:
        out = replace(out, core_noc=patch(arch.core_noc))
    return out


# ---------------------------------------------------------------- presets


def _mk_mem(name: str, size: int, bw_gbs: float, re: float, we: float) -> MemLevel:
    return MemLevel(name, size, bw_gbs * GIGA, re, we)


def edge(calibrated=None) -> Arch:
    """Table V 'Edge' column.

    DRAM 1 GB @ 25 GB/s; 2x2 clusters of 2x2 cores; GB 2 MB @ 2 TB/s;
    IB/WB 32 KB, OB 128 KB @ 4 TB/s; channel width 256 links, channel BW
    64 GB/s, t_router 5 ns, t_enq 2 ns.
    Energy: DDR4 ~150 pJ/B (DRAMPower ballpark), MB-scale SRAM ~6 pJ/B,
    KB-scale SRAM ~1 pJ/B.

    ``calibrated`` (a NoCParams / Calibration / ``calibrated_noc.json``
    path) replaces the cluster NoC timing constants with measured ones
    via :func:`apply_calibration`.
    """
    arch = Arch(
        name="edge",
        dram=_mk_mem("DRAM", 1 << 30, 25, 150.0, 150.0),
        gb=_mk_mem("GB", 2 << 20, 2000, 6.0, 6.0),
        ib=_mk_mem("IB", 32 << 10, 4000, 1.0, 1.0),
        wb=_mk_mem("WB", 32 << 10, 4000, 1.0, 1.0),
        ob=_mk_mem("OB", 128 << 10, 4000, 1.0, 1.0),
        cluster_noc=NoCParams((2, 2), 256, 64 * GIGA, 5e-9, 2e-9, 0.10),
        core_noc=NoCParams((2, 2), 256, 64 * GIGA, 5e-9, 2e-9, 0.05),
        gemm_unit=GemmUnit(32, 32, (8, 8), 1.0 * GIGA, 0.5),
        simd_unit=SimdUnit(256, 1.0 * GIGA, 0.3),
    )
    return apply_calibration(arch, calibrated)


def cloud(calibrated=None) -> Arch:
    """Table V 'Cloud' column."""
    arch = Arch(
        name="cloud",
        dram=_mk_mem("DRAM", 4 << 30, 50, 150.0, 150.0),
        gb=_mk_mem("GB", 8 << 20, 4000, 8.0, 8.0),
        ib=_mk_mem("IB", 32 << 10, 4000, 1.0, 1.0),
        wb=_mk_mem("WB", 32 << 10, 4000, 1.0, 1.0),
        ob=_mk_mem("OB", 128 << 10, 4000, 1.0, 1.0),
        cluster_noc=NoCParams((4, 4), 2048, 512 * GIGA, 5e-9, 2e-9, 0.10),
        core_noc=NoCParams((4, 4), 2048, 512 * GIGA, 5e-9, 2e-9, 0.05),
        gemm_unit=GemmUnit(32, 32, (8, 8), 1.0 * GIGA, 0.5),
        simd_unit=SimdUnit(256, 1.0 * GIGA, 0.3),
    )
    return apply_calibration(arch, calibrated)


def tpu_v5e(mesh: Tuple[int, int] = (16, 16), calibrated=None) -> Arch:
    """TPU-v5e adaptation (DESIGN.md §3).

    DRAM -> HBM (16 GB, 819 GB/s); GB -> VMEM (128 MB, ~8 TB/s on-chip);
    IB/WB/OB -> Pallas BlockSpec VMEM tiles (modelled as fast small
    buffers feeding the MXU/VPU); GEMM unit -> 4 MXUs of 128x128 (peak
    197 bf16 TFLOP/s => 1.5 GHz effective); SIMD -> VPU ~4 Tops/s.
    Cluster NoC -> ICI torus @ 50 GB/s/link (mesh = the jax device mesh);
    core NoC degenerates (1 core per chip).
    """
    peak = 197e12
    freq = peak / (4 * 128 * 128 * 2)
    arch = Arch(
        name="tpu_v5e",
        dram=_mk_mem("DRAM", 16 << 30, 819, 3.9, 3.9),   # HBM2e ~3.9 pJ/B
        gb=_mk_mem("GB", 128 << 20, 8000, 1.2, 1.2),      # VMEM
        ib=_mk_mem("IB", 512 << 10, 16000, 0.3, 0.3),
        wb=_mk_mem("WB", 512 << 10, 16000, 0.3, 0.3),
        ob=_mk_mem("OB", 1 << 20, 16000, 0.3, 0.3),
        cluster_noc=NoCParams(mesh, 4096, 50 * GIGA, 1e-7, 5e-9, 0.05),
        core_noc=NoCParams((1, 1), 4096, 8000 * GIGA, 1e-9, 1e-9, 0.01),
        gemm_unit=GemmUnit(128, 128, (2, 2), freq, 0.15),
        simd_unit=SimdUnit(4096, 0.94 * GIGA, 0.1),
    )
    return apply_calibration(arch, calibrated)


def tileflow_like(calibrated=None) -> Arch:
    """The 3-level architecture used for the Fig. 6 cost-model comparison:
    DRAM, one on-chip buffer, one MAC array (single cluster/core)."""
    arch = Arch(
        name="tileflow_like",
        dram=_mk_mem("DRAM", 4 << 30, 50, 150.0, 150.0),
        gb=_mk_mem("GB", 4 << 20, 2000, 6.0, 6.0),
        # Fig 6 arch has a single on-chip buffer level: the core buffers
        # are sized so GB is the binding constraint.
        ib=_mk_mem("IB", 2 << 20, 4000, 1.0, 1.0),
        wb=_mk_mem("WB", 2 << 20, 4000, 1.0, 1.0),
        ob=_mk_mem("OB", 2 << 20, 4000, 1.0, 1.0),
        cluster_noc=NoCParams((1, 1), 256, 64 * GIGA, 5e-9, 2e-9, 0.1),
        core_noc=NoCParams((1, 1), 256, 64 * GIGA, 5e-9, 2e-9, 0.05),
        gemm_unit=GemmUnit(32, 32, (1, 1), 1.0 * GIGA, 0.5),
        simd_unit=SimdUnit(256, 1.0 * GIGA, 0.3),
    )
    return apply_calibration(arch, calibrated)


def h100(calibrated=None) -> Arch:
    """NVIDIA H100 SXM5 (Hopper, sm_90), the port's card, as one node: the
    kernel arch for per-kernel tile selection, the whole card in aggregate.

    Level mapping: DRAM -> HBM3 (80 GB, 3.35 TB/s); GB -> one CTA's shared
    memory (227 KB, the most a block may take of an SM's 228 KB), the
    capacity a kernel's tile must fit, at the card's aggregate shared-memory
    rate; IB/WB/OB -> the register file (256 KB an SM: 64 KB each of
    operand staging, 128 KB of accumulators); cluster NoC -> the DSMEM
    network of a thread-block cluster; core NoC degenerates (1, 1).  With a
    (1, 1) cluster mesh the whole card is one instance, so no collective is
    charged; the 50 MB L2 is not a level (every DRAM byte is charged at
    the HBM3 rate).

    GEMM unit -> the 528 tensor cores (132 SMs x 4), each modelled as a
    16 x 32 array (512 bf16 MACs a clock), clocked so the card's dense
    bf16 peak is 989.4 TFLOP/s (spec sheet: 1.83 GHz); SIMD -> the 16,896
    FP32 lanes (132 x 128) at the 1.98 GHz boost clock (67 TFLOP/s FP32
    counting an FMA as two).  Shared-memory rate: 128 B a clock an SM
    (32 banks x 4 B) x 132 x 1.98 GHz = 33.45 TB/s; the register file is
    modelled at 4x that (an estimate, not from the spec sheet).

    Energy: published-ballpark constants like the other presets', not
    measured here: HBM3 ~3.5 pJ/bit (28 pJ/B); shared memory ~1.2 pJ/B;
    registers ~0.3 pJ/B; a bf16 tensor-core MAC ~0.2 pJ; an FP32 lane op
    ~0.1 pJ.  DSMEM: an SM-to-SM hop ~100 ns (~190 cycles, published
    microbenchmarks), 128 B a clock a link (~253 GB/s), ~0.5 pJ/B a hop.
    """
    peak = 989.4e12                      # dense bf16 FLOP/s
    arrays = (132, 4)                    # SMs x tensor cores an SM
    freq = peak / (arrays[0] * arrays[1] * 16 * 32 * 2)
    smem_gbs = 132 * 128 * 1.98          # GB/s over the card
    arch = Arch(
        name="h100",
        dram=_mk_mem("DRAM", 80 << 30, 3350, 28.0, 28.0),        # HBM3
        gb=_mk_mem("GB", 227 << 10, smem_gbs, 1.2, 1.2),          # smem
        ib=_mk_mem("IB", 64 << 10, 4 * smem_gbs, 0.3, 0.3),       # regs
        wb=_mk_mem("WB", 64 << 10, 4 * smem_gbs, 0.3, 0.3),
        ob=_mk_mem("OB", 128 << 10, 4 * smem_gbs, 0.3, 0.3),
        cluster_noc=NoCParams((1, 1), 128, 128 * 1.98 * GIGA, 1e-7,
                              1 / (1.98 * GIGA), 0.5),            # DSMEM
        core_noc=NoCParams((1, 1), 128, 4 * smem_gbs * GIGA, 1e-9, 1e-9,
                           0.01),
        gemm_unit=GemmUnit(16, 32, arrays, freq, 0.2),
        simd_unit=SimdUnit(132 * 128, 1.98 * GIGA, 0.1),
    )
    return apply_calibration(arch, calibrated)


PRESETS = {
    "edge": edge,
    "cloud": cloud,
    "tpu_v5e": tpu_v5e,
    "tileflow_like": tileflow_like,
    "h100": h100,
}
