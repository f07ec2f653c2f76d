"""COMET cost model (§IV-B, Eqs. 1–7).

Latency
-------
* Eq. 1  MemLat = DV / BW
* Eq. 2  Lat(T_n) = N·MW + CS + OS   (N temporal iterations; MW = memory
  window = per-iteration child latency; CS = compulsory stall — initial
  fill + final drain; OS = optional stall — transfer time in excess of the
  window, assuming double-buffered overlap)
* Eq. 3  NoCLat = t_router·hops + t_enq·DV/W
* Eq. 4  Lat(CO) = MemLat + NoCLat
* Eq. 5–7 scheduling: sequential = Σ children; pipelined/parallel =
  max(children) + conflictStall where conflictTime =
  Σ MemLat(children) − max(Lat(children)).

Semantics of the tree (see mapping.py):
* A :class:`TileNode` at level L represents **one instance** of that level;
  its ``spatial_loops`` give the number of peer instances (fanout).
  Latency is per-instance (instances run in parallel); energy and
  parent-boundary traffic aggregate across instances.
* ``loops`` at L iterate the parent-streamed tiles resident at L;
  children execute once per iteration (their costs scale by N).
* Tensors whose dims are **not** spatially partitioned at L are multicast:
  parent-side traffic is charged once, instance-side writes per instance.

Energy: access-count model (FLAT-style) + compute energy + Orion-style NoC
hop energy for collectives.

Compute timing: SCALE-Sim weight-stationary analytical model (GEMM tiles on
the per-core systolic grid); lanes × frequency for SIMD.

Port-local copy of ``repro/core/cost.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from .collectives import collective_latency_terms
from .hardware import Arch
from .mapping import CollectiveNode, ComputeNode, Node, TileNode, Tiling
from .numerics import ceil_div, is_array, reduce_max, vmax, vmin, vwhere
from .workload import TensorSpec

__all__ = ["NodeCost", "CostModel", "systolic_gemm_cycles"]


LAT_KEYS = ("gemm", "simd", "collective", "cs", "os")
ENERGY_KEYS = ("DRAM", "GB", "corebuf", "noc", "gemm", "simd")


def _zeros(keys) -> Dict[str, float]:
    return {k: 0.0 for k in keys}


@dataclass
class NodeCost:
    latency: float = 0.0                       # seconds (per top-level execution)
    mem_lat: float = 0.0                       # boundary transfer time at this node
    energy_pj: float = 0.0
    lat_breakdown: Dict[str, float] = field(default_factory=lambda: _zeros(LAT_KEYS))
    energy_breakdown: Dict[str, float] = field(default_factory=lambda: _zeros(ENERGY_KEYS))

    def add_energy(self, key: str, pj: float) -> None:
        if self.energy_breakdown:
            self.energy_breakdown[key] += pj
        self.energy_pj = self.energy_pj + pj

    def scaled(self, lat_scale: float, energy_scale: float) -> "NodeCost":
        out = NodeCost(
            latency=self.latency * lat_scale,
            mem_lat=self.mem_lat * lat_scale,
            energy_pj=self.energy_pj * energy_scale,
            lat_breakdown={k: v * lat_scale for k, v in self.lat_breakdown.items()},
            energy_breakdown={k: v * energy_scale
                              for k, v in self.energy_breakdown.items()},
        )
        return out

    def accumulate(self, other: "NodeCost") -> None:
        if self.lat_breakdown:
            for k, v in other.lat_breakdown.items():
                self.lat_breakdown[k] += v
            for k, v in other.energy_breakdown.items():
                self.energy_breakdown[k] += v
        self.energy_pj = self.energy_pj + other.energy_pj


def _energy_key(level_name: str) -> str:
    if level_name == "DRAM":
        return "DRAM"
    if level_name == "GB":
        return "GB"
    return "corebuf"


# ------------------------------------------------------------ compute time


def systolic_gemm_cycles(m: int, n: int, k: int, rows: int, cols: int,
                         num_arrays: int) -> int:
    """Weight-stationary SCALE-Sim analytical timing for an (m,k)x(k,n) tile
    on ``num_arrays`` arrays of ``rows x cols`` PEs: the weight matrix folds
    into ceil(k/rows)*ceil(n/cols) array loads; each fold streams m rows:
    cycles = rows (fill) + m + cols - 1 (drain)."""
    folds = ceil_div(k, rows) * ceil_div(n, cols)
    per_fold = rows + m + cols - 1
    return ceil_div(folds, num_arrays) * per_fold


class CostModel:
    """Evaluates a mapping tree bottom-up (§IV-B).

    ``track_breakdown=False`` skips the per-key latency/energy breakdown
    dicts (total latency / energy / mem_lat are unaffected) — used by the
    batched engine where only the totals feed the argmin.
    """

    def __init__(self, arch: Arch, tiling: Tiling,
                 tensors: Dict[str, TensorSpec], *,
                 track_breakdown: bool = True):
        self.arch = arch
        self.tiling = tiling
        self.tensors = tensors
        self.track_breakdown = track_breakdown

    def _cost(self) -> NodeCost:
        if self.track_breakdown:
            return NodeCost()
        return NodeCost(lat_breakdown={}, energy_breakdown={})

    # ------------------------------------------------------------- leaves
    def compute_cost(self, node: ComputeNode) -> NodeCost:
        c = self._cost()
        if node.unit == "gemm":
            u = self.arch.gemm_unit
            red = node.op.reduce_dims
            out_dims = [d for d in node.op.dims if d not in red]
            m = node.tile_shape.get(out_dims[0], 1) if out_dims else 1
            n = node.tile_shape.get(out_dims[1], 1) if len(out_dims) > 1 else 1
            k = node.tile_shape.get(red[0], 1) if red else 1
            cyc = systolic_gemm_cycles(m, n, k, u.array_rows, u.array_cols,
                                       u.num_arrays)
            c.latency = cyc / u.freq_hz
            if self.track_breakdown:
                c.lat_breakdown["gemm"] = c.latency
            c.add_energy("gemm", m * n * k * u.mac_energy_pj)
        else:
            s = self.arch.simd_unit
            ops = node.points * node.op.flops_per_point
            c.latency = ops / s.peak_ops_per_sec
            if self.track_breakdown:
                c.lat_breakdown["simd"] = c.latency
            c.add_energy("simd", ops * s.op_energy_pj)
        return c

    # -------------------------------------------------------- collectives
    def collective_cost_node(self, node: CollectiveNode) -> NodeCost:
        c = self._cost()
        noc = (self.arch.cluster_noc if node.noc_level == "GB"
               else self.arch.core_noc)
        # Eq. 1 (capped by NoC BW) + Eq. 4 via the shared helper the
        # calibration fitter inverts (bit-identical to inlining it here).
        cc, mem_lat, lat_once = collective_latency_terms(
            node.col_type, node.data_volume_bytes, node.participants, noc)
        c.latency = lat_once * node.count
        c.mem_lat = mem_lat * node.count
        if self.track_breakdown:
            c.lat_breakdown["collective"] = c.latency
        c.add_energy("noc", cc.volume_bytes * cc.hops
                     * noc.hop_energy_pj_per_byte * node.count)
        if node.src:
            lvl = self.arch.level(node.src[0])
            c.add_energy(_energy_key(lvl.name),
                         lvl.access_energy(cc.volume_bytes, cc.volume_bytes)
                         * node.count)
        return c

    # --------------------------------------------------------- tile nodes
    def tile_cost(self, node: TileNode) -> NodeCost:
        child_costs = [self.evaluate(ch) for ch in node.children]
        fracs = [getattr(ch, "exec_fraction", 1.0) for ch in node.children]
        n_iter = node.iterations
        fanout = node.spatial_fanout

        c = self._cost()
        # Children execute exec_fraction * n_iter times, in every instance.
        for cc, fr in zip(child_costs, fracs):
            c.accumulate(cc.scaled(lat_scale=n_iter * fr,
                                   energy_scale=n_iter * fr * fanout))

        # Eq. 5: per-iteration memory window from children (amortized by
        # each child's execution fraction).  ``node.schedule`` is either a
        # name (scalar path) or a boolean mask array (batched path, True =
        # pipelined) — the mask folds the schedule axis into one SoA pass.
        sched = node.schedule
        sched_is_mask = is_array(sched)
        # Overlap extension to Eqs. 5–7: ``node.overlap`` in [0, 1] hides
        # that fraction of the window's *hideable* collective time (the
        # Eq. 1 mem_lat of CollectiveNode children; the Eq. 3 enqueue /
        # router term stays exposed) under sibling compute.  The hidden
        # time is capped by the compute time available to hide under, so
        # the window never drops below compute + exposed collective cost.
        # ``overlap`` may be an array (a grid axis, like the schedule
        # mask).  The guard keeps overlap == 0.0 bit-identical to the
        # pre-overlap serial charging: the code path is literally the old
        # one when overlap is the scalar 0.0, and ``x - 0.0 * y`` for the
        # array path.
        ov = node.overlap
        ov_on = is_array(ov) or ov != 0.0  # scalar-ok: scalar 0.0 short-circuit
        if ov_on:
            col_hideable = sum(
                cc.mem_lat * fr
                for cc, ch, fr in zip(child_costs, node.children, fracs)
                if isinstance(ch, CollectiveNode))
            comp_lat = sum(
                cc.latency * fr
                for cc, ch, fr in zip(child_costs, node.children, fracs)
                if not isinstance(ch, CollectiveNode))
            hidden = ov * vmin(col_hideable, comp_lat)
        else:
            hidden = 0.0
        if not child_costs:
            mw = 0.0
        elif len(child_costs) == 1:
            # single child: pipelined degenerates to sequential (stall <= 0)
            mw = child_costs[0].latency * fracs[0]
        elif not sched_is_mask and sched == "sequential":
            mw = sum(cc.latency * fr for cc, fr in zip(child_costs, fracs))
            if ov_on:
                mw = mw - hidden
                if self.track_breakdown:
                    c.lat_breakdown["collective"] -= hidden * n_iter
        else:
            mx = reduce_max(cc.latency * fr for cc, fr in zip(child_costs, fracs))
            conflict = (sum(cc.mem_lat * fr for cc, fr in zip(child_costs, fracs))
                        - mx)                                       # Eq. 7
            if ov_on:
                # hidden collective traffic no longer contends for the
                # pipeline window (Eq. 7's conflict time shrinks)
                conflict = conflict - hidden
            stall = vmax(0.0, conflict)                             # Eq. 6
            pipe = mx + stall
            if sched_is_mask:
                seq = sum(cc.latency * fr for cc, fr in zip(child_costs, fracs))
                if ov_on:
                    seq = seq - hidden
                mw = vwhere(sched, pipe, seq)
                stall = vwhere(sched, stall, 0.0)
                if self.track_breakdown and ov_on:
                    c.lat_breakdown["collective"] -= \
                        vwhere(sched, 0.0, hidden) * n_iter
            else:
                mw = pipe
            if self.track_breakdown:
                c.lat_breakdown["os"] += stall * n_iter

        # ---- boundary traffic parent(level) -> level (Eq. 1)
        parent_level = self.arch.parent_of(node.level)
        total_in = total_out = 0.0
        iter_in = iter_out = 0.0
        if parent_level is not None:
            lvl = self.arch.level(node.level)
            parent = self.arch.level(parent_level)
            eff_bw = min(lvl.bandwidth, parent.bandwidth)  # scalar-ok: arch params
            sp_factors = {lp.dim: lp.factor for lp in node.spatial_loops}

            def _traffic(t: str) -> Tuple[float, float]:
                """(parent-side bytes, instance-side bytes x fanout)."""
                spec = self.tensors[t]
                nest = node.tensor_nests.get(t)
                fetches = node.tensor_fetches(spec.dims, nest)
                tile_b = self.tiling.tensor_tile_bytes(spec, node.level, below=True)
                part = 1
                for d, f in sp_factors.items():
                    if d in spec.dims:
                        part *= f
                # parent side: partitioned slices are distinct (charge all);
                # non-partitioned dims are multicast (charge once).
                return fetches * tile_b * part, fetches * tile_b * fanout

            fill_b = drain_b = 0.0
            write_child = read_child = 0.0
            for t in node.input_tensors:
                if t in node.bypass_tensors:
                    continue
                pb, cb = _traffic(t)
                total_in += pb
                write_child += cb
                fill_b += pb / vmax(1, node.tensor_fetches(
                    self.tensors[t].dims, node.tensor_nests.get(t)))
            for t in node.output_tensors:
                if t in node.bypass_tensors:
                    continue
                pb, cb = _traffic(t)
                total_out += pb
                read_child += cb
                drain_b += pb / vmax(1, node.tensor_fetches(
                    self.tensors[t].dims, node.tensor_nests.get(t)))

            mem_time = (total_in + total_out) / eff_bw
            cs = (fill_b + drain_b) / eff_bw                       # ramp-up/down
            c.add_energy(_energy_key(parent.name),
                         parent.access_energy(total_in, total_out))
            c.add_energy(_energy_key(lvl.name),
                         lvl.access_energy(read_child, write_child))
        else:
            mem_time = 0.0
            cs = 0.0

        # Eq. 2
        window_total = n_iter * mw
        os_stall = vmax(0.0, mem_time - window_total)
        c.latency = window_total + cs + os_stall
        c.mem_lat = mem_time
        if self.track_breakdown:
            c.lat_breakdown["cs"] += cs
            c.lat_breakdown["os"] += os_stall
        return c

    # ------------------------------------------------------------ dispatch
    def evaluate(self, node: Node) -> NodeCost:
        if isinstance(node, ComputeNode):
            return self.compute_cost(node)
        if isinstance(node, CollectiveNode):
            return self.collective_cost_node(node)
        if isinstance(node, TileNode):
            return self.tile_cost(node)
        raise TypeError(type(node))
