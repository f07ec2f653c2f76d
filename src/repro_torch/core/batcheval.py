"""Vectorized batch map-space evaluation engine (DFModel-style factoring).

The mapping space of Fig. 1 factors into

* a **topology** — the discrete shape of the mapping tree: fusion variant
  x collective granularity x GB loop order.  A compound op has only a
  handful of topologies, and the tree structure (nodes, labels, tensors,
  collectives) is fully determined by the topology; and
* **grid axes** — the m/k/n temporal tile counts, the ``sp_cluster``/
  ``sp_core`` spatial unrolling fanouts and the ``schedule`` choice.
  Tile counts and fanouts only change Loop factors, tile sizes, collective
  participants and data volumes; the schedule enters Eqs. 5-7 as a
  mask-select (True = pipelined) rather than a separate tree build, which
  halves the topology count per space.

Exploiting that, one topology's entire grid is evaluated in a single
structure-of-arrays pass: ``build_tree`` is called once with NumPy int
arrays for the tiling/fanout parameters (plus the schedule mask), and the
unchanged Eq. 1-7 formulas in :mod:`.cost`, :mod:`.collectives` and
:mod:`.validate` broadcast through the tree.  Results are bit-identical to
the per-spec path (same code, same formulas) at a fraction of the
per-mapping Python overhead.  ``track_breakdown=True`` additionally
carries the per-key latency/energy breakdown dicts through the same SoA
pass (used by the benchmark breakdown figures — no scalar tree walk).

:meth:`BatchResult.pareto_front` extracts the latency/energy Pareto front
of a grid as a vectorized skyline (argsort + running min), and
``objective='pareto'`` in :func:`repro_torch.core.search.search` merges the
per-topology fronts into a global front.  Every batch also carries a
**capacity-headroom** channel (worst relative buffer slack, see
:func:`repro_torch.core.validate.validity_and_headroom`);
:meth:`BatchResult.pareto_front3` filters the 3-D
latency/energy/headroom front (minimize the first two, maximize the
third) for provisioning studies (``objective='pareto3'``), and
:class:`ParetoArchive` is the bounded online non-dominated archive the
randomized search fallback uses for both front objectives.

Two LRU caches sit on top:

* a **grid cache** keyed on (compound-op signature, ``Arch.signature()``,
  topology, candidate axes) holding whole :class:`BatchResult` arrays, and
* a **spec cache** keyed on (compound-op signature, ``Arch.signature()``,
  spec) holding lightweight (latency, energy, valid, headroom) tuples for
  the randomized fallback path.

Cache keys use the *full architecture parameter signature*
(:meth:`repro_torch.core.hardware.Arch.signature`), never ``arch.name`` alone:
two Arch instances sharing a name but differing in bandwidth/capacity
must not reuse each other's results.  Both caches are shared across
searches (see :func:`repro_torch.core.search.search` and ``search_many``).

**Executor contract.**  The caches and every evaluation entry point here
are executor-agnostic: ``search_many`` may run them in the calling
thread (``'serial'``), in a thread pool sharing this module's caches
(``'thread'``), or in process-pool workers that each hold their own
module-level cache instance (``'process'``) — the numbers are
bit-identical either way because the same code evaluates the same grids.
For the process path, :func:`batch_to_shm` serializes a
:class:`BatchResult`'s arrays into one ``multiprocessing.shared_memory``
segment and returns a tiny picklable :class:`ShmBatchRef`;
:func:`batch_from_shm` reattaches the arrays zero-copy in the parent.
Segments are created by workers and unlinked by the consumer, with
``repro_torch.core.search.cleanup_shm_segments`` as the crash backstop — see
the lifecycle notes on :class:`ShmBatchRef`.

Port-local copy of ``repro/core/batcheval.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost import ENERGY_KEYS, LAT_KEYS, CostModel
from .hardware import Arch
from .ir import MappingSpec, build_tree
from .mapping import SCHEDULES
from .validate import validity_headroom_levels
from .workload import CompoundOp

__all__ = [
    "Topology",
    "BatchResult",
    "ParetoArchive",
    "ShmBatchRef",
    "batch_to_shm",
    "batch_from_shm",
    "shm_unlink",
    "co_signature",
    "numeric_axes",
    "enumerate_topologies",
    "evaluate_specs_batch",
    "evaluate_topology_grid",
    "evaluate_cached",
    "pareto_merge",
    "pareto_merge3",
    "cache_info",
    "cache_clear",
]

GEMM_EPILOGUE_COS = ("gemm", "gemm_softmax", "gemm_layernorm")
ATTENTION_COS = ("attention", "flash_attention")

OBJECTIVES = ("latency", "energy", "edp", "pareto", "pareto3")


@dataclass(frozen=True)
class Topology:
    """The discrete (non-numeric) part of a MappingSpec.

    ``schedule`` is retained for API compatibility (explicit
    ``evaluate_specs_batch`` callers may pin it) but is no longer a
    topology axis: grids enumerate it via the schedule mask instead.
    """

    variant: str
    schedule: str = "sequential"
    collective_gran: str = "tile"
    loop_order_gb: Tuple[str, ...] = ("M", "N")

    def spec(self, m_tiles: int = 1, k_tiles: int = 1, n_tiles: int = 1,
             sp_cluster: int = 0, sp_core: int = 0,
             schedule: Optional[str] = None,
             overlap: float = 0.0) -> MappingSpec:
        return MappingSpec(
            variant=self.variant, m_tiles=m_tiles, k_tiles=k_tiles,
            n_tiles=n_tiles, sp_cluster=sp_cluster, sp_core=sp_core,
            schedule=self.schedule if schedule is None else schedule,
            collective_gran=self.collective_gran,
            loop_order_gb=self.loop_order_gb, overlap=overlap)


@dataclass
class BatchResult:
    """Structure-of-arrays result of one topology's grid."""

    topo: Topology
    m_tiles: np.ndarray
    k_tiles: np.ndarray
    n_tiles: np.ndarray
    sp_cluster: np.ndarray
    sp_core: np.ndarray
    schedule: np.ndarray            # per-point schedule names (str array)
    overlap: np.ndarray             # per-point compute–collective overlap
    latency: np.ndarray
    energy_pj: np.ndarray
    valid: np.ndarray
    # Worst relative buffer slack per grid point (the 'pareto3' channel);
    # negative where some buffer overflows.
    headroom: Optional[np.ndarray] = None
    # Per-level slack arrays ({'GB': ..., 'OB': ...}, same shape):
    # ``headroom`` folded per memory level instead of across all levels,
    # so provisioning studies can size the cluster (GB) and core (OB =
    # IB+WB+OB) buffers independently.  None for rejected topologies.
    headroom_levels: Optional[Dict[str, np.ndarray]] = None
    # Per-key breakdown arrays (same shape), present only when the batch
    # was evaluated with track_breakdown=True.
    lat_breakdown: Optional[Dict[str, np.ndarray]] = None
    energy_breakdown: Optional[Dict[str, np.ndarray]] = None

    @property
    def size(self) -> int:
        return int(self.latency.shape[0])

    def scores(self, objective: str = "latency") -> np.ndarray:
        """Objective value per grid point; +inf where invalid."""
        if objective == "latency":
            s = self.latency
        elif objective == "energy":
            s = self.energy_pj
        elif objective == "edp":
            s = self.latency * self.energy_pj
        else:
            raise ValueError(f"unknown scalar objective {objective!r}")
        return np.where(self.valid, s, np.inf)

    def best_index(self, objective: str = "latency") -> Optional[int]:
        if self.size == 0 or not bool(self.valid.any()):
            return None
        return int(np.argmin(self.scores(objective)))

    def pareto_front(self) -> np.ndarray:
        """Indices of the non-dominated (latency, energy) points among the
        valid grid entries, in ascending-latency order.

        Vectorized 2-D skyline: lexsort by (latency, energy), then a point
        survives iff its energy is strictly below the running minimum of
        all points with better-or-equal latency (weakly dominated points
        and duplicates are dropped).
        """
        idx = np.flatnonzero(self.valid)
        if idx.size == 0:
            return idx
        lat = self.latency[idx]
        en = self.energy_pj[idx]
        order = np.lexsort((en, lat))
        en_s = en[order]
        cummin = np.minimum.accumulate(en_s)
        keep = np.ones(order.size, dtype=bool)
        keep[1:] = en_s[1:] < cummin[:-1]
        return idx[order[keep]]

    def pareto_front3(self) -> np.ndarray:
        """Indices of the non-dominated (latency, energy, headroom) points
        among the valid grid entries — latency/energy minimized, headroom
        maximized — in ascending-latency order.  Weakly dominated points
        and duplicates are dropped, matching :meth:`pareto_front`."""
        if self.headroom is None:
            raise ValueError("batch evaluated without a headroom channel")
        idx = np.flatnonzero(self.valid)
        if idx.size == 0:
            return idx
        keep = _pareto3_sorted_indices(self.latency[idx], self.energy_pj[idx],
                                       -self.headroom[idx])
        return idx[keep]

    def spec_at(self, i: int) -> MappingSpec:
        return self.topo.spec(
            int(self.m_tiles[i]), int(self.k_tiles[i]), int(self.n_tiles[i]),
            sp_cluster=int(self.sp_cluster[i]), sp_core=int(self.sp_core[i]),
            schedule=str(self.schedule[i]), overlap=float(self.overlap[i]))

    def _breakdown_at(self, bd: Dict[str, np.ndarray], i: int) -> Dict[str, float]:
        return {k: float(np.broadcast_to(np.asarray(v, dtype=np.float64),
                                         self.latency.shape)[i])
                for k, v in bd.items()}

    def lat_breakdown_at(self, i: int) -> Dict[str, float]:
        if self.lat_breakdown is None:
            raise ValueError("batch evaluated without track_breakdown")
        return self._breakdown_at(self.lat_breakdown, i)

    def energy_breakdown_at(self, i: int) -> Dict[str, float]:
        if self.energy_breakdown is None:
            raise ValueError("batch evaluated without track_breakdown")
        return self._breakdown_at(self.energy_breakdown, i)


def pareto_merge(points: Sequence[Tuple]) -> List[Tuple]:
    """Skyline of ``(latency, energy, *payload)`` tuples: the merged
    latency/energy Pareto front across several :class:`BatchResult` fronts
    (ascending latency, strictly descending energy)."""
    best_en = np.inf
    out: List[Tuple] = []
    for p in sorted(points, key=lambda p: (p[0], p[1])):
        if p[1] < best_en:  # scalar-ok: merged points are float tuples
            out.append(p)
            best_en = p[1]
    return out


def _pareto3_sorted_indices(a: np.ndarray, b: np.ndarray,
                            c: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated points of the all-minimized (a, b, c)
    triples, in lexicographic (a, b, c) order.

    Lexsort makes every earlier point <= the current one in ``a``, so a
    point is dominated iff some kept point has b <= and c <= (weak
    dominance — duplicates are dropped too, as in the 2-D skyline); the
    membership test against the kept staircase is a vectorized NumPy
    reduction per point.  Kept points are final: a later point can never
    dominate an earlier one under the lex order.
    """
    order = np.lexsort((c, b, a))
    n = order.size
    kb = np.empty(n)
    kc = np.empty(n)
    m = 0
    kept: List[int] = []
    for j in order:
        if m and bool(np.any((kb[:m] <= b[j]) & (kc[:m] <= c[j]))):
            continue
        kb[m] = b[j]
        kc[m] = c[j]
        m += 1
        kept.append(int(j))
    return np.asarray(kept, dtype=np.int64)


def pareto_merge3(points: Sequence[Tuple]) -> List[Tuple]:
    """Non-dominated subset of ``(latency, energy, headroom, *payload)``
    tuples — latency/energy minimized, headroom maximized — in
    ascending-latency order: the merged 3-D front across several
    :class:`BatchResult` fronts."""
    if not points:
        return []
    a = np.asarray([p[0] for p in points], dtype=np.float64)
    b = np.asarray([p[1] for p in points], dtype=np.float64)
    c = np.asarray([-p[2] for p in points], dtype=np.float64)
    return [points[j] for j in _pareto3_sorted_indices(a, b, c)]


def _crowding_distances(keys: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance per point of an (n, dims) objective
    matrix (all objectives minimized): for each objective, the span-
    normalized gap between a point's two neighbours in that objective's
    ordering, summed over objectives.  Per-objective extreme points get
    +inf so boundary points are never pruned; a degenerate objective
    (zero span) contributes nothing."""
    n, dims = keys.shape
    dist = np.zeros(n)
    for j in range(dims):
        order = np.argsort(keys[:, j], kind="stable")
        col = keys[order, j]
        span = float(col[-1] - col[0])
        dist[order[0]] = np.inf
        dist[order[-1]] = np.inf
        if span > 0.0 and n > 2:  # scalar-ok: span is float(), n is int
            dist[order[1:-1]] += (col[2:] - col[:-2]) / span
    return dist


class ParetoArchive:
    """Bounded online non-dominated archive (ROADMAP: the randomized
    multi-objective fallback must not hold every valid sample once budgets
    grow past ~10k).

    Points are ``(latency, energy, *payload)`` for ``dims=2`` or
    ``(latency, energy, headroom, *payload)`` for ``dims=3``
    (latency/energy minimized, headroom maximized).  ``add`` rejects
    points weakly dominated by the archive and evicts points the newcomer
    dominates, so the archive is mutually non-dominated at all times.
    When it outgrows ``maxlen`` it is thinned by **crowding-distance
    pruning** (NSGA-II style): the per-objective extreme points always
    survive and the most-crowded interior points — the ones whose
    neighbours along every objective sit closest — are dropped first, so
    a dense cluster loses points before a sparse stretch of the front
    does.  (The previous every-other-point decimation kept clusters dense
    and halved sparse regions instead.)  Thinning bounds memory at the
    cost of front *fidelity*: once points have been evicted, a later
    sample that only an evicted point dominated can be re-admitted, so
    the final front is an approximation of the true front over all
    evaluated samples — though always mutually non-dominated.
    """

    def __init__(self, dims: int = 2, maxlen: int = 512):
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        if maxlen < 2:  # scalar-ok: constructor int arg
            raise ValueError(f"maxlen must be >= 2, got {maxlen}")
        self.dims = dims
        self.maxlen = maxlen
        self._points: List[Tuple] = []

    def __len__(self) -> int:
        return len(self._points)

    def _key(self, p: Tuple) -> Tuple[float, ...]:
        # all-minimized objective vector
        if self.dims == 2:  # scalar-ok: dims validated to 2 or 3
            return (p[0], p[1])
        return (p[0], p[1], -p[2])

    def add(self, point: Tuple) -> bool:
        """Insert ``point``; True iff it joined the archive (i.e. it is
        not weakly dominated by a current member)."""
        k = self._key(point)
        keep: List[Tuple] = []
        for q in self._points:
            qk = self._key(q)
            if all(a <= b for a, b in zip(qk, k)):
                return False                    # dominated (or duplicate)
            if not all(a <= b for a, b in zip(k, qk)):
                keep.append(q)                  # q survives the newcomer
        keep.append(point)
        self._points = keep
        if len(self._points) > self.maxlen:
            self._thin()
        return True

    def _thin(self) -> None:
        """Crowding-distance pruning down to ``maxlen // 2`` points (the
        same amortization ratio as the old decimation, so ``add`` still
        thins at most once per ~maxlen/2 insertions).  Points are removed
        one at a time — always a currently lowest-crowding interior point
        — and distances are recomputed after each removal, so pruning one
        of two tight neighbours immediately un-crowds the other."""
        pts = sorted(self._points, key=self._key)
        target = max(2, self.maxlen // 2)  # scalar-ok: ints
        keys = np.asarray([self._key(p) for p in pts], dtype=np.float64)
        alive = list(range(len(pts)))
        while len(alive) > target:
            d = _crowding_distances(keys[alive])
            if np.isfinite(d).any():
                alive.pop(int(np.argmin(d)))
            else:
                # every survivor is extreme in some objective — drop from
                # the middle rather than eat into a front endpoint
                alive.pop(len(alive) // 2)
        self._points = [pts[i] for i in alive]

    def front(self) -> List[Tuple]:
        """The archived non-dominated points in ascending-latency order."""
        return sorted(self._points, key=self._key)


# ------------------------------------------------- shared-memory transport

# BatchResult array fields shipped through a segment, in declaration order.
# Dict-valued channels (headroom_levels / breakdowns) are flattened to
# dotted keys ("hl.GB", "lb.gemm", "eb.dram", ...).
_SHM_FIELDS = ("m_tiles", "k_tiles", "n_tiles", "sp_cluster", "sp_core",
               "schedule", "overlap", "latency", "energy_pj", "valid",
               "headroom")
_SHM_ALIGN = 64      # cache-line alignment for each array's offset


@dataclass(frozen=True)
class ShmBatchRef:
    """Picklable reference to a :class:`BatchResult` serialized into one
    ``multiprocessing.shared_memory`` segment.

    The ref itself is tiny (segment name, topology, and per-array
    (key, offset, dtype, shape) descriptors): it crosses the process
    boundary through the ordinary pickle channel while the grid arrays
    stay in the segment, so the parent reattaches them **zero-copy** with
    :func:`batch_from_shm` instead of unpickling megabytes per result.

    Lifecycle contract: the creating process (a pool worker) writes the
    arrays, closes its mapping and returns the ref; the consuming process
    (the sweep parent) attaches, reduces, then **unlinks** the segment.
    Create-in-worker / unlink-in-parent is tracker-clean on every
    multiprocessing start method: pool workers inherit the parent's
    resource-tracker fd (``multiprocessing.spawn`` passes ``tracker_fd``
    in the preparation data, fork inherits it outright), so register and
    unregister land in the same tracker and no "leaked shared_memory"
    warning fires at pool shutdown.  A segment whose ref is lost (worker
    crash mid-job) is reclaimed by the sweep driver's prefix sweep — see
    ``repro_torch.core.search.cleanup_shm_segments``.
    """

    shm_name: str
    nbytes: int
    topo: Topology
    # (key, byte offset, numpy dtype str, shape) per serialized array
    arrays: Tuple[Tuple[str, int, str, Tuple[int, ...]], ...]


def _shm_group(arrs: Dict[str, np.ndarray], tag: str
               ) -> Optional[Dict[str, np.ndarray]]:
    d = {k.split(".", 1)[1]: v for k, v in arrs.items()
         if k.startswith(tag + ".")}
    return d or None


def batch_to_shm(br: BatchResult, *, prefix: str = "cmbatch") -> ShmBatchRef:
    """Serialize ``br``'s arrays into a fresh shared-memory segment named
    ``{prefix}_{random}`` and return the picklable :class:`ShmBatchRef`.
    The caller's process keeps no mapping open; the segment lives until
    the consumer unlinks it (or a prefix sweep reclaims it).

    Keep ``prefix`` short: POSIX shm names are capped at 31 chars
    **including** the leading slash on macOS (PSHMNAMLEN), and this
    function appends ``_`` + 8 hex chars — so prefixes up to ~21 chars
    are portable.  Name collisions (8 hex chars of randomness) are
    retried with a fresh suffix."""
    import secrets
    from multiprocessing import shared_memory

    items: List[Tuple[str, np.ndarray]] = []
    for f in _SHM_FIELDS:
        a = getattr(br, f)
        if a is not None:
            items.append((f, np.ascontiguousarray(a)))
    for tag, d in (("hl", br.headroom_levels), ("lb", br.lat_breakdown),
                   ("eb", br.energy_breakdown)):
        if d:
            for k in sorted(d):
                items.append((f"{tag}.{k}", np.ascontiguousarray(d[k])))
    metas: List[Tuple[str, int, str, Tuple[int, ...]]] = []
    off = 0
    for key, a in items:
        off = -(-off // _SHM_ALIGN) * _SHM_ALIGN
        metas.append((key, off, a.dtype.str, tuple(a.shape)))
        off += a.nbytes
    total = max(off, 1)  # scalar-ok: byte offsets are ints
    for _attempt in range(8):
        try:
            shm = shared_memory.SharedMemory(
                name=f"{prefix}_{secrets.token_hex(4)}", create=True,
                size=total)
            break
        except FileExistsError:
            continue
    else:
        raise FileExistsError(
            f"could not allocate a fresh shm name under prefix {prefix!r}")
    try:
        for (_key_m, o, _dt, shape), (_key, a) in zip(metas, items):
            dst = np.ndarray(shape, dtype=a.dtype, buffer=shm.buf, offset=o)
            dst[...] = a
            del dst             # release the buffer export before close()
        ref = ShmBatchRef(shm.name, total, br.topo, tuple(metas))
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    shm.close()
    return ref


def batch_from_shm(ref: ShmBatchRef):
    """Reattach a :class:`BatchResult` from ``ref``'s segment.

    Returns ``(batch, shm)``: the batch's arrays are zero-copy views over
    the segment, so ``shm`` (the ``SharedMemory`` handle) must stay alive
    while the batch is in use, and the caller is responsible for
    ``shm.unlink()`` exactly once when done (drop the batch's arrays
    before ``shm.close()``, or skip close and let refcounting reclaim the
    mapping)."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=ref.shm_name)
    arrs = {key: np.ndarray(shape, dtype=np.dtype(dt), buffer=shm.buf,
                            offset=off)
            for key, off, dt, shape in ref.arrays}
    br = BatchResult(
        ref.topo, arrs["m_tiles"], arrs["k_tiles"], arrs["n_tiles"],
        arrs["sp_cluster"], arrs["sp_core"], arrs["schedule"],
        arrs["overlap"], arrs["latency"], arrs["energy_pj"], arrs["valid"],
        headroom=arrs.get("headroom"),
        headroom_levels=_shm_group(arrs, "hl"),
        lat_breakdown=_shm_group(arrs, "lb"),
        energy_breakdown=_shm_group(arrs, "eb"))
    return br, shm


def shm_unlink(name: str) -> bool:
    """Unlink segment ``name`` if it still exists; True iff it did.
    Tolerates already-unlinked segments (idempotent cleanup)."""
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    shm.unlink()
    shm.close()
    return True


# ------------------------------------------------------------- signatures


def co_signature(co: CompoundOp) -> Tuple:
    """Hashable identity of a compound op for cache keying: name, dims and
    tensor layouts (ops are derived from the builder, so name+dims+tensors
    pin the workload)."""
    return (
        co.name,
        tuple(sorted(co.dim_sizes.items())),
        tuple(sorted((t.name, t.dims, t.dtype_bytes)
                     for t in co.tensors.values())),
    )


NUMERIC_AXES = ("m_tiles", "k_tiles", "n_tiles", "sp_cluster", "sp_core")


def numeric_axes(co: CompoundOp) -> Tuple[str, ...]:
    """Which numeric MappingSpec axes actually reach the tree builder for
    this compound op (the rest are degenerate and pinned).  The spatial
    fanout axes apply to every builder family."""
    if co.name in GEMM_EPILOGUE_COS:
        return ("m_tiles", "k_tiles", "sp_cluster", "sp_core")
    if co.name in ATTENTION_COS:
        return ("m_tiles", "n_tiles", "sp_cluster", "sp_core")
    return ("m_tiles", "sp_cluster", "sp_core")


def topology_fields(co: CompoundOp) -> Tuple[str, ...]:
    """Which discrete MappingSpec fields alter the tree for this compound
    op.  GEMM-epilogue trees ignore the GB loop order; attention trees
    ignore the collective granularity; the generic builder only branches
    on fused-vs-unfused.  ``schedule`` is never a topology field: the
    batched engine folds it into the grid as an Eq. 5-7 mask-select."""
    if co.name in GEMM_EPILOGUE_COS:
        return ("variant", "collective_gran")
    if co.name in ATTENTION_COS:
        return ("variant", "loop_order_gb")
    return ("variant",)


def enumerate_topologies(co: CompoundOp,
                         cands: Dict[str, List]) -> List[Topology]:
    """All distinct topologies for ``co`` given the candidate sets from
    :func:`repro_torch.core.search.candidate_specs`.  Fields that do not alter
    the tree are pinned to their first candidate, so the enumeration has
    no duplicate-cost topologies."""
    fields = topology_fields(co)

    def opts(name: str) -> List:
        return cands[name] if name in fields else cands[name][:1]

    out = []
    for variant in opts("variant"):
        for schedule in opts("schedule"):
            for gran in opts("collective_gran"):
                for lo in opts("loop_order_gb"):
                    out.append(Topology(variant=variant, schedule=schedule,
                                        collective_gran=gran,
                                        loop_order_gb=tuple(lo)))
    return out


# ------------------------------------------------------------- evaluation


def evaluate_specs_batch(co: CompoundOp, arch: Arch, topo: Topology,
                         m_tiles: Sequence[int], k_tiles: Sequence[int],
                         n_tiles: Sequence[int],
                         sp_cluster: Optional[Sequence[int]] = None,
                         sp_core: Optional[Sequence[int]] = None,
                         schedule: Optional[Sequence[str]] = None,
                         overlap: Optional[Sequence[float]] = None, *,
                         track_breakdown: bool = False) -> BatchResult:
    """Evaluate parallel arrays of (m, k, n[, sp_cluster, sp_core,
    schedule, overlap]) grid points for one topology in a single
    vectorized pass.

    ``sp_cluster``/``sp_core`` default to 0 (= full architecture fanout);
    ``schedule`` is a parallel array of schedule *names* defaulting to the
    topology's pinned schedule; ``overlap`` is a parallel array of
    compute–collective overlap factors in [0, 1] defaulting to the scalar
    0.0 (the pre-overlap serial charging, bit-identical by construction).
    With ``track_breakdown=True`` the result carries per-key
    latency/energy breakdown arrays.
    """
    m = np.asarray(m_tiles, dtype=np.int64)
    k = np.asarray(k_tiles, dtype=np.int64)
    n = np.asarray(n_tiles, dtype=np.int64)
    spc = (np.asarray(sp_cluster, dtype=np.int64)
           if sp_cluster is not None else np.asarray(0, dtype=np.int64))
    spo = (np.asarray(sp_core, dtype=np.int64)
           if sp_core is not None else np.asarray(0, dtype=np.int64))
    ov = (np.asarray(overlap, dtype=np.float64)
          if overlap is not None else np.asarray(0.0))
    if overlap is not None and ov.size:
        if float(ov.min()) < 0.0 or float(ov.max()) > 1.0:
            # mirror the scalar range contract of MappingSpec.overlap
            raise ValueError("overlap must lie in [0, 1]")
    if schedule is not None:
        sched_names = np.asarray(schedule)
        bad = set(np.unique(sched_names).tolist()) - set(SCHEDULES)
        if bad:
            # mirror the scalar path, which rejects unknown schedule names
            # at TileNode construction
            raise ValueError(f"bad schedule {sorted(bad)}")
        sched_mask = sched_names != "sequential"
        m, k, n, spc, spo, sched_mask, ov = np.broadcast_arrays(
            m, k, n, spc, spo, sched_mask, ov)
        sched_names = np.broadcast_to(sched_names, m.shape)
        spec_schedule = sched_mask
    else:
        m, k, n, spc, spo, ov = np.broadcast_arrays(m, k, n, spc, spo, ov)
        sched_names = np.broadcast_to(np.asarray(topo.schedule), m.shape)
        spec_schedule = topo.schedule
    shape = m.shape
    # ``overlap=None`` keeps the scalar 0.0 in the spec so the cost model
    # takes its pre-overlap short-circuit; the BatchResult still records
    # the per-point zeros for spec reconstruction.
    spec_overlap = ov if overlap is not None else 0.0
    ov_names = np.broadcast_to(np.asarray(ov, dtype=np.float64), shape)
    spec = MappingSpec(
        variant=topo.variant, m_tiles=m, k_tiles=k, n_tiles=n,
        sp_cluster=spc, sp_core=spo, schedule=spec_schedule,
        collective_gran=topo.collective_gran,
        loop_order_gb=topo.loop_order_gb, overlap=spec_overlap)
    try:
        root, tiling = build_tree(co, arch, spec)
    except (ValueError, KeyError):
        # Whole topology rejected (e.g. unknown variant for this builder):
        # mirror the scalar path, which skips these specs.  Every field
        # and breakdown key gets its OWN zeros array — a single shared
        # buffer would alias them, so an in-place edit of one breakdown
        # entry would silently corrupt every other key plus the
        # latency/energy fields.
        return BatchResult(
            topo, m, k, n, spc, spo, sched_names, ov_names,
            np.zeros(shape), np.zeros(shape), np.zeros(shape, dtype=bool),
            headroom=np.zeros(shape),
            lat_breakdown={k_: np.zeros(shape) for k_ in LAT_KEYS}
            if track_breakdown else None,
            energy_breakdown={k_: np.zeros(shape) for k_ in ENERGY_KEYS}
            if track_breakdown else None)
    ok, hr, levels = validity_headroom_levels(root, arch, tiling, co.tensors)
    valid = np.broadcast_to(ok, shape).copy()
    headroom = np.ascontiguousarray(
        np.broadcast_to(np.asarray(hr, dtype=np.float64), shape))
    # Read-only broadcast views, not copies: the levels unfold the
    # already-materialized folded channel, so charging two extra
    # full-grid arrays per evaluation would be pure waste (batch_to_shm
    # makes them contiguous if and when a grid is serialized).
    headroom_levels = {
        lvl: np.broadcast_to(np.asarray(v, dtype=np.float64), shape)
        for lvl, v in levels.items()}
    cost = CostModel(arch, tiling, co.tensors,
                     track_breakdown=track_breakdown).evaluate(root)
    latency = np.ascontiguousarray(
        np.broadcast_to(np.asarray(cost.latency, dtype=np.float64), shape))
    energy = np.ascontiguousarray(
        np.broadcast_to(np.asarray(cost.energy_pj, dtype=np.float64), shape))
    lat_bd = dict(cost.lat_breakdown) if track_breakdown else None
    en_bd = dict(cost.energy_breakdown) if track_breakdown else None
    return BatchResult(topo, m, k, n, spc, spo, sched_names, ov_names,
                       latency, energy, valid, headroom=headroom,
                       headroom_levels=headroom_levels,
                       lat_breakdown=lat_bd, energy_breakdown=en_bd)


def _grid_arrays(co: CompoundOp, cands: Dict[str, List]) -> Tuple[np.ndarray, ...]:
    """Flattened meshgrid over the numeric axes + the schedule and overlap
    axes: (m, k, n, sp_cluster, sp_core, schedule-names, overlap) parallel
    arrays."""
    axes = numeric_axes(co)
    per_axis = [np.asarray(cands[ax], dtype=np.int64) if ax in axes
                else np.asarray([0 if ax.startswith("sp_") else 1],
                                dtype=np.int64)
                for ax in NUMERIC_AXES]
    per_axis.append(np.asarray(cands["schedule"]))
    per_axis.append(np.asarray(cands.get("overlap", [0.0]),
                               dtype=np.float64))
    mg = np.meshgrid(*per_axis, indexing="ij")
    return tuple(g.reshape(-1) for g in mg)


def grid_size(co: CompoundOp, cands: Dict[str, List]) -> int:
    """Number of grid points per topology for this compound op (numeric
    axes x the schedule x overlap axes).  Missing axes count as pinned
    (PR 1-shaped candidate dicts without sp_*/schedule/overlap keys remain
    accepted)."""
    n = len(cands.get("schedule", ("sequential",)))
    n *= len(cands.get("overlap", (0.0,)))
    for ax in numeric_axes(co):
        n *= len(cands.get(ax, (0,)))
    return n


# ------------------------------------------------------------------ caches


class _LRU:
    """Tiny thread-safe LRU (search_many fans searches out over threads
    that share these caches)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self.data:
                self.data.move_to_end(key)
                self.hits += 1
                return self.data[key]
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self.data[key] = value
            self.data.move_to_end(key)
            while len(self.data) > self.maxsize:
                self.data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self.data.clear()
            self.hits = 0
            self.misses = 0


_GRID_CACHE = _LRU(maxsize=1024)
_SPEC_CACHE = _LRU(maxsize=65536)


def cache_info() -> Dict[str, Dict[str, int]]:
    return {
        "grid": {"hits": _GRID_CACHE.hits, "misses": _GRID_CACHE.misses,
                 "size": len(_GRID_CACHE.data)},
        "spec": {"hits": _SPEC_CACHE.hits, "misses": _SPEC_CACHE.misses,
                 "size": len(_SPEC_CACHE.data)},
    }


def cache_clear() -> None:
    _GRID_CACHE.clear()
    _SPEC_CACHE.clear()


def evaluate_topology_grid(co: CompoundOp, arch: Arch, topo: Topology,
                           cands: Dict[str, List]) -> BatchResult:
    """Whole-grid evaluation of one topology, LRU-cached on the compound
    op signature, the full arch parameter signature, the topology and the
    candidate axes (tiling, spatial fanouts and schedules).  Candidate
    dicts without the sp_*/schedule axes (the PR 1 shape) pin them to the
    auto fanout / the topology's schedule."""
    full = dict(cands)
    full.setdefault("sp_cluster", [0])
    full.setdefault("sp_core", [0])
    full.setdefault("schedule", [topo.schedule])
    full.setdefault("overlap", [0.0])
    key = (co_signature(co), arch.signature(), topo,
           tuple(full["m_tiles"]), tuple(full["k_tiles"]),
           tuple(full["n_tiles"]),
           tuple(full["sp_cluster"]), tuple(full["sp_core"]),
           tuple(full["schedule"]), tuple(full["overlap"]))
    hit = _GRID_CACHE.get(key)
    if hit is not None:
        return hit
    m, k, n, spc, spo, sched, ov = _grid_arrays(co, full)
    # a pure-serial grid ([0.0] overlap axis) passes overlap=None so the
    # cost model takes the bit-identical pre-overlap path
    ov_arg = None if tuple(full["overlap"]) == (0.0,) else ov  # scalar-ok: host-side axis tuple
    br = evaluate_specs_batch(co, arch, topo, m, k, n, spc, spo, sched,
                              ov_arg)
    _GRID_CACHE.put(key, br)
    return br


def evaluate_cached(co: CompoundOp, arch: Arch, spec: MappingSpec
                    ) -> Optional[Tuple[float, float, bool, float]]:
    """Lightweight cached per-spec evaluation: (latency, energy_pj, valid,
    headroom), or None when the spec is rejected outright (the scalar path
    raises).  Shared by the randomized search fallback across searches."""
    key = (co_signature(co), arch.signature(), spec)
    hit = _SPEC_CACHE.get(key)
    if hit is not None:
        return hit if hit != () else None
    from .ir import evaluate_mapping
    try:
        r = evaluate_mapping(co, arch, spec)
        val = (r.latency, r.energy_pj, r.valid, r.headroom)
    except (ValueError, KeyError):
        val = ()
    _SPEC_CACHE.put(key, val)
    return val if val != () else None
