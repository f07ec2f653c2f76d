"""Mapping IR (COMET §IV-A).

A *mapping* is a hierarchical tree (Fig. 4(c)) of

* :class:`TileNode` ``T_i^j`` — data residing at one memory level, with a
  **unique temporal loop nest per tensor** (the paper's key representational
  extension over Timeloop/TileFlow's one-nest-per-level), plus spatial
  unrolling factors;
* :class:`ComputeNode` — a leaf executing one elementary operation tile on
  the GEMM (systolic/MXU) or SIMD (VPU) unit;
* :class:`CollectiveNode` ``CO_i^j`` — an explicit peer-to-peer collective
  among the memory instances at one level, annotated with
  ColOpType / Tensor / ReduceOp / Src / Dest exactly as in §IV-A.

The :class:`Tiling` helper owns the per-dimension factorization across
levels (temporal and spatial) so that tile sizes at any level and loop
iteration counts are consistent by construction.

Port-local copy of ``repro/core/mapping.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .numerics import ceil_div, is_array, vmax
from .workload import Operation, TensorSpec

__all__ = [
    "Loop",
    "Tiling",
    "TileNode",
    "ComputeNode",
    "CollectiveNode",
    "Node",
    "SCHEDULES",
]

SCHEDULES = ("sequential", "pipelined", "parallel")

# Canonical level order root -> leaf (matches Arch.LEVELS).
LEVEL_ORDER = ("DRAM", "GB", "OB")


@dataclass(frozen=True)
class Loop:
    """One loop: iterate ``factor`` times over tiles of dimension ``dim``."""

    dim: str
    factor: int
    spatial: bool = False

    def __post_init__(self) -> None:
        # Batched evaluation passes an array of factors; bounds are then
        # enforced by the grid construction, not per-Loop.
        if not is_array(self.factor) and self.factor < 1:  # scalar-ok
            raise ValueError(f"loop factor must be >=1, got {self.factor}")


class Tiling:
    """Per-dimension factorization across memory levels.

    ``temporal[level][dim] = factor`` and ``spatial[level][dim] = factor``.
    The leaf tile of dim ``d`` is ``ceil(size / prod(all factors of d))``.
    Factors need not divide exactly; ceil-division semantics are used and
    edge tiles are charged as full tiles (consistent with Timeloop).
    """

    def __init__(self, dim_sizes: Dict[str, int],
                 temporal: Dict[str, Dict[str, int]],
                 spatial: Dict[str, Dict[str, int]]):
        self.dim_sizes = dict(dim_sizes)
        self.temporal = {lvl: dict(temporal.get(lvl, {})) for lvl in LEVEL_ORDER}
        self.spatial = {lvl: dict(spatial.get(lvl, {})) for lvl in LEVEL_ORDER}
        # Factors are fixed after construction, so tile queries are
        # memoized — one tree evaluation asks for the same (dim, level)
        # tiles many times (and, on the batched path, each query is an
        # array op worth amortizing).
        self._memo: Dict[Tuple, object] = {}

    # ------------------------------------------------------------------
    def factors_of(self, dim: str) -> int:
        key = ("f", dim)
        out = self._memo.get(key)
        if out is None:
            p = 1
            for lvl in LEVEL_ORDER:
                p *= self.temporal[lvl].get(dim, 1)
                p *= self.spatial[lvl].get(dim, 1)
            out = self._memo[key] = p
        return out

    def leaf_tile(self, dim: str) -> int:
        return vmax(1, ceil_div(self.dim_sizes[dim], self.factors_of(dim)))

    def tile_at(self, dim: str, level: str) -> int:
        """Tile size of ``dim`` *resident at* ``level`` (i.e. after applying
        all factors at levels strictly above ``level``)."""
        key = ("at", dim, level)
        out = self._memo.get(key)
        if out is None:
            p = 1
            for lvl in LEVEL_ORDER:
                if lvl == level:  # scalar-ok: level names are strings
                    break
                p *= self.temporal[lvl].get(dim, 1)
                p *= self.spatial[lvl].get(dim, 1)
            out = self._memo[key] = vmax(1, ceil_div(self.dim_sizes[dim], p))
        return out

    def tile_below(self, dim: str, level: str) -> int:
        """Tile size of ``dim`` handed to the *children* of ``level`` (after
        this level's temporal+spatial factors as well)."""
        key = ("below", dim, level)
        out = self._memo.get(key)
        if out is None:
            p = 1
            for lvl in LEVEL_ORDER:
                p *= self.temporal[lvl].get(dim, 1)
                p *= self.spatial[lvl].get(dim, 1)
                if lvl == level:  # scalar-ok: level names are strings
                    break
            out = self._memo[key] = vmax(1, ceil_div(self.dim_sizes[dim], p))
        return out

    def tensor_tile_bytes(self, t: TensorSpec, level: str, *, below: bool) -> int:
        key = ("tb", t.name, t.dims, t.dtype_bytes, level, below)
        out = self._memo.get(key)
        if out is None:
            n = t.dtype_bytes
            for d in t.dims:
                n *= self.tile_below(d, level) if below else self.tile_at(d, level)
            out = self._memo[key] = n
        return out

    def validate(self) -> None:
        for d, size in self.dim_sizes.items():
            f = self.factors_of(d)
            if is_array(f):
                raise TypeError("use overfactor_mask() for batched tilings")
            if f > size:  # scalar-ok: is_array(f) raised above
                raise ValueError(
                    f"dim {d}: product of factors {f} exceeds size {size}")

    def overfactor_mask(self):
        """Batched analogue of :meth:`validate`: elementwise True where the
        per-dimension factor products are within the dimension sizes (i.e.
        where the scalar path would *not* raise)."""
        ok = True
        for d, size in self.dim_sizes.items():
            ok = np.logical_and(ok, self.factors_of(d) <= size)
        return ok


# ------------------------------------------------------------------- nodes


@dataclass
class ComputeNode:
    """Leaf: one elementary op tile on a compute unit."""

    op: Operation
    tile_shape: Dict[str, int]          # dim -> leaf tile size
    unit: str                           # 'gemm' | 'simd'
    label: str = ""
    # Fraction of the parent's temporal iterations on which this child
    # executes (e.g. 1/n_tiles for a per-M-tile op under an (M,N) nest).
    exec_fraction: float = 1.0

    @property
    def points(self) -> int:
        p = 1
        for d in self.op.dims:
            p *= self.tile_shape.get(d, 1)
        return p


@dataclass
class CollectiveNode:
    """Explicit collective among peer memories at one level (CO_i^j)."""

    col_type: str                       # AllReduce | AllGather | ...
    tensor: str
    reduce_op: str                      # 'add' | 'max' | 'none'
    src: Tuple[str, ...]                # e.g. ("GB",) — peers at GB level
    dest: Tuple[str, ...]
    participants: int
    data_volume_bytes: float            # logical tensor bytes per occurrence
    count: float = 1                    # occurrences per parent iteration
    noc_level: str = "GB"               # which NoC: 'GB' -> cluster, 'OB' -> core
    label: str = ""
    exec_fraction: float = 1.0


@dataclass
class TileNode:
    """T_i^j: data staged at ``level``; per-tensor temporal loop nests.

    ``tensor_nests[t]`` is the ordered (outer->inner) list of temporal
    loops for tensor ``t`` at this node.  ``loops`` is the node's overall
    temporal loop order; per-tensor nests are its projections but may be
    reordered per tensor (the unique-nest-per-tensor feature).
    ``spatial_loops`` unroll across the child instances (clusters for a
    DRAM node, cores for a GB node).
    """

    level: str
    index: int
    loops: List[Loop] = field(default_factory=list)              # temporal, outer->inner
    spatial_loops: List[Loop] = field(default_factory=list)
    tensor_nests: Dict[str, List[Loop]] = field(default_factory=dict)
    input_tensors: Tuple[str, ...] = ()
    output_tensors: Tuple[str, ...] = ()
    bypass_tensors: Tuple[str, ...] = ()   # tensors NOT staged here (fusion bypass)
    children: List["Node"] = field(default_factory=list)
    schedule: str = "sequential"
    label: str = ""
    # Extra bytes resident at this level beyond the staged tiles (e.g. a
    # gathered full-row tensor in the standard-SM mapping) — validation only.
    extra_resident_bytes: float = 0.0
    exec_fraction: float = 1.0
    # Compute–collective overlap factor in [0, 1] for this node's window:
    # the fraction of its collective children's hideable time (Eq. 1
    # mem_lat) hidden under sibling compute.  May be an array on the
    # batched path (an overlap grid axis, like the ``schedule`` mask).
    overlap: float = 0.0

    def __post_init__(self) -> None:
        # Batched evaluation passes a boolean mask array (True = pipelined)
        # spanning a grid of schedule choices; names are validated only on
        # the scalar path.
        if not is_array(self.schedule) and self.schedule not in SCHEDULES:
            raise ValueError(f"bad schedule {self.schedule}")

    @property
    def iterations(self) -> int:
        n = 1
        for lp in self.loops:
            n *= lp.factor
        return n

    @property
    def spatial_fanout(self) -> int:
        n = 1
        for lp in self.spatial_loops:
            n *= lp.factor
        return n

    def tensor_fetches(self, tensor_dims: Tuple[str, ...],
                       nest: Optional[List[Loop]] = None) -> int:
        """Number of times the tensor's tile must be (re)fetched across this
        node's temporal iterations, with classic stationary reuse: loops
        *below* (inside) the innermost relevant loop give free reuse.
        """
        loops = nest if nest is not None else self.loops
        relevant = [i for i, lp in enumerate(loops) if lp.dim in tensor_dims]
        if not relevant:
            return 1
        last = relevant[-1]
        n = 1
        for lp in loops[: last + 1]:
            n *= lp.factor
        return n


Node = Union[TileNode, ComputeNode, CollectiveNode]


def walk(node: Node):
    """Depth-first iterator over a mapping tree."""
    yield node
    if isinstance(node, TileNode):
        for c in node.children:
            yield from walk(c)


def tree_str(node: Node, depth: int = 0) -> str:
    pad = "  " * depth
    if isinstance(node, TileNode):
        sp = ",".join(f"{l.dim}:{l.factor}" for l in node.spatial_loops)
        tp = ",".join(f"{l.dim}:{l.factor}" for l in node.loops)
        s = (f"{pad}T[{node.level}]^{node.index} {node.label} "
             f"Tp({tp}) Sp({sp}) sched={node.schedule}\n")
        for c in node.children:
            s += tree_str(c, depth + 1)
        return s
    if isinstance(node, CollectiveNode):
        return (f"{pad}CO[{node.noc_level}] {node.col_type}({node.tensor},"
                f" {node.reduce_op}) P={node.participants}"
                f" DV={node.data_volume_bytes:.0f}B x{node.count}\n")
    return (f"{pad}C[{node.unit}] {node.op.name} tile="
            f"{dict(node.tile_shape)}\n")
