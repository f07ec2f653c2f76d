"""Collective-operation hop/volume models (COMET §IV-B, Eq. 3/4).

The paper uses the recursive doubling/halving algorithms [30] to compute
both the total number of hops and the total data volume moved for each
collective type.  Participants are peer memory instances at one level of
the hierarchy (e.g. the GBs of all clusters), laid out row-major on the
level's NoC mesh; hop distances are Manhattan distances between exchange
partners.

Conventions
-----------
``data_volume`` (DV) passed in is the *logical tensor size in bytes* on
which the collective operates (the full tensor for All-Reduce / the
gathered result for All-Gather, matching the paper's Tensor annotation on
CO nodes).  Each model returns:

    CollectiveCost(volume_bytes, hops, steps)

where ``volume_bytes`` is the total bytes moved across the NoC per
participant (the busiest node's traffic, which Eq. 3 charges), and
``hops`` is the summed hop distance of its exchange schedule.

Tabulated factors
-----------------
For every collective type the busiest-node volume is ``DV * f(P)`` where
``f`` depends only on the participant count (and the NoC, for All-to-All
hops) — the per-partition communication-factor formulation of DFModel and
of the multi-commodity-flow view of collectives.  Both the scalar path
and the batched array path therefore read one precomputed, per-NoC cached
``P -> (volume_factor, hops, steps)`` table (:func:`_factor_table`): the
scalar path indexes it at one P, the array path gathers it with a single
``np.take``, so the two are bit-identical by construction no matter how
many unique participant counts a divisor-complete fanout grid produces.

Non-power-of-two participants use the dissemination (Bruck) exchange
schedule: step ``i`` moves ``min(2^i, P - 2^i)`` shards of ``DV/P``,
which sums to exactly ``(P-1)/P * DV`` for *every* P.  For powers of two
this equals the recursive halving/doubling volumes; for other P it
replaces the old next-power-of-two round-up that silently overcharged
3/5/6-way fanouts.

Port-local copy of ``repro/core/collectives.py``, held to the original by
``tests/test_torch_overlap.py``.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .hardware import NoCParams
from .numerics import is_array

__all__ = [
    "CollectiveCost",
    "collective_cost",
    "collective_latency_terms",
    "collective_seconds",
    "collective_overlap_terms",
    "overlapped_collective_seconds",
    "noc_latency",
    "collective_cache_clear",
    "COLLECTIVE_TYPES",
]

COLLECTIVE_TYPES = (
    "AllReduce",
    "AllGather",
    "ReduceScatter",
    "Gather",
    "Broadcast",
    "AllToAll",
)


@dataclass(frozen=True)
class CollectiveCost:
    volume_bytes: float   # bytes through the busiest participant
    hops: int             # summed exchange-partner hop distance
    steps: int            # number of communication steps


def _step_distances(noc: NoCParams, participants: int) -> Tuple[int, ...]:
    """Manhattan distance of the partner at linear offset 2^i, for each
    dissemination step i (ceil(log2 P) steps)."""
    if participants <= 1:
        return ()
    steps = max(1, math.ceil(math.log2(participants)))
    return tuple(
        noc.manhattan(0, min((1 << i), noc.num_nodes - 1) if noc.num_nodes > 1 else 0)
        or 1
        for i in range(steps)
    )


# ----------------------------------------------------- per-P factor tables


@dataclass(frozen=True)
class _FactorTable:
    """P-indexed (volume_factor, hops, steps) arrays for one (NoC,
    collective type): ``volume_bytes = DV * volume_factor[P]``.  Arrays are
    read-only — they are shared across every query against this NoC."""

    volume_factor: np.ndarray   # float64, vol = DV * volume_factor[P]
    hops: np.ndarray            # int64
    steps: np.ndarray           # int64

    @property
    def size(self) -> int:
        return int(self.volume_factor.shape[0])


# NoCParams is a frozen dataclass, so instances hash by parameter value:
# equal-parameter NoCs share one table.  search_many fans searches out over
# threads that share these caches, hence the lock around table builds.
_FACTOR_TABLES: Dict[Tuple[NoCParams, str], _FactorTable] = {}
_MESH_AVG_CACHE: Dict[NoCParams, float] = {}
_TABLE_LOCK = threading.Lock()


def collective_cache_clear() -> None:
    """Drop the per-NoC factor tables and mesh-distance cache (tests)."""
    with _TABLE_LOCK:
        _FACTOR_TABLES.clear()
        _MESH_AVG_CACHE.clear()


def _scalar_factors(col_type: str, P: int, noc: NoCParams
                    ) -> Tuple[float, int, int]:
    """(volume_factor, hops, steps) for one participant count — the single
    source of truth the table is built from.

    Dissemination (Bruck) schedule: step i moves min(2^i, P-2^i) shards of
    DV/P, so every type's busiest-node volume is exactly (P-1)/P * DV
    (recursive halving/doubling recovers the same volumes at power-of-two
    P); All-Reduce is ReduceScatter + AllGather.  Gather/Broadcast are
    binomial trees whose root moves (P-1)/P * DV; All-to-All is P-1 paired
    direct exchanges at the mesh-average Manhattan distance.
    """
    if P <= 1:
        return 0.0, 0, 0
    if col_type == "AllReduce":
        vf, hops, steps = _scalar_factors("ReduceScatter", P, noc)
        return 2.0 * vf, 2 * hops, 2 * steps
    if col_type == "AllToAll":
        avg = _mesh_avg_distance(noc)
        return (P - 1) / P, int(round(avg * (P - 1))), P - 1
    dists = _step_distances(noc, P)
    if col_type in ("ReduceScatter", "AllGather", "Gather", "Broadcast"):
        return (P - 1) / P, sum(dists), len(dists)
    raise ValueError(f"unknown collective type {col_type!r}")


def _factor_table(noc: NoCParams, col_type: str, max_p: int) -> _FactorTable:
    """Cached (noc, col_type) -> P-indexed factor table covering at least
    ``max_p`` participants (tables are built to the NoC node count up
    front, so divisor-complete fanout grids never rebuild them)."""
    key = (noc, col_type)
    tbl = _FACTOR_TABLES.get(key)
    if tbl is not None and tbl.size > max_p:
        return tbl
    with _TABLE_LOCK:
        tbl = _FACTOR_TABLES.get(key)
        if tbl is not None and tbl.size > max_p:
            return tbl
        size = max(max_p, noc.num_nodes, 1) + 1
        vf = np.zeros(size, dtype=np.float64)
        hops = np.zeros(size, dtype=np.int64)
        steps = np.zeros(size, dtype=np.int64)
        for p in range(2, size):
            vf[p], hops[p], steps[p] = _scalar_factors(col_type, p, noc)
        for arr in (vf, hops, steps):
            arr.flags.writeable = False
        tbl = _FactorTable(vf, hops, steps)
        _FACTOR_TABLES[key] = tbl
        return tbl


def collective_cost(
    col_type: str,
    data_volume: float,
    participants: int,
    noc: NoCParams,
) -> CollectiveCost:
    """Volume/hops for one collective over ``participants`` peers.

    Every type moves (P-1)/P * DV through the busiest node (All-Reduce =
    RS + AG => 2*DV*(P-1)/P); see :func:`_scalar_factors` for the exchange
    schedules.  Both the scalar path and the array path read the cached
    per-NoC factor table, so array results are bit-identical elementwise
    to the scalar-P calls.

    ``participants`` may be a NumPy int array (the batched engine folds
    the spatial-fanout axes into its grid, so CO nodes carry one
    participant count per grid point); the result is then a
    :class:`CollectiveCost` of arrays gathered from the same table.
    """
    if is_array(participants):
        return _collective_cost_array(col_type, data_volume, participants,
                                      noc)
    P = int(participants)
    if P <= 1:  # scalar-ok: int() cast above
        return CollectiveCost(0.0, 0, 0)
    if is_array(data_volume):
        if np.all(data_volume <= 0):
            return CollectiveCost(0.0, 0, 0)
    elif data_volume <= 0:  # scalar-ok: is_array branch above
        return CollectiveCost(0.0, 0, 0)
    if col_type not in COLLECTIVE_TYPES:
        raise ValueError(f"unknown collective type {col_type!r}")

    tbl = _factor_table(noc, col_type, P)
    vol = data_volume * tbl.volume_factor[P]
    hops = int(tbl.hops[P])
    steps = int(tbl.steps[P])
    if is_array(vol):
        # Batched-DV path: grid points with dv <= 0 move nothing (the
        # scalar path short-circuits those to a zero CollectiveCost above).
        vol = np.where(np.asarray(data_volume) > 0, vol, 0.0)
        return CollectiveCost(vol, hops, steps)
    return CollectiveCost(float(vol), hops, steps)


def _collective_cost_array(col_type: str, data_volume, participants,
                           noc: NoCParams) -> CollectiveCost:
    """Batched participants: gather (volume_factor, hops, steps) from the
    cached per-NoC table with one ``np.take`` per field.  The scalar path
    reads the same table entries, so results are bit-identical elementwise
    regardless of how many unique participant counts the grid holds."""
    if col_type not in COLLECTIVE_TYPES:
        raise ValueError(f"unknown collective type {col_type!r}")
    P = np.asarray(participants)
    dv = np.asarray(data_volume, dtype=np.float64)
    shape = np.broadcast_shapes(P.shape, dv.shape)
    max_p = int(P.max()) if P.size else 1
    tbl = _factor_table(noc, col_type, max_p)
    # P <= 1 rows in the table are zero, matching the scalar short-circuit;
    # negative requests clamp onto the zero row.
    idx = np.maximum(P, 0)
    vf = np.take(tbl.volume_factor, idx)
    vol = np.where(dv > 0, dv * vf, 0.0)
    hops = np.broadcast_to(np.take(tbl.hops, idx), shape)
    steps = np.broadcast_to(np.take(tbl.steps, idx), shape)
    return CollectiveCost(np.broadcast_to(vol, shape), hops, steps)


def _mesh_avg_distance(noc: NoCParams) -> float:
    """Mean Manhattan distance between distinct nodes of the NoC mesh,
    cached per NoCParams — the O(nodes^2) scan runs once per NoC, not once
    per All-to-All query (a 16x16 mesh is ~65k ``manhattan`` calls)."""
    hit = _MESH_AVG_CACHE.get(noc)
    if hit is not None:
        return hit
    r, c = noc.mesh
    if r * c <= 1:
        out = 1.0
    else:
        total = 0
        for a in range(r * c):
            for b in range(r * c):
                if a != b:
                    total += noc.manhattan(a, b)
        out = total / (r * c * (r * c - 1))
    _MESH_AVG_CACHE[noc] = out
    return out


def collective_latency_terms(
    col_type: str,
    data_volume: float,
    participants: int,
    noc: NoCParams,
) -> Tuple[CollectiveCost, float, float]:
    """End-to-end seconds for ONE collective execution, decomposed.

    Returns ``(cost, mem_lat, total)`` where ``mem_lat`` is the Eq. 1
    MemLat term charged at the NoC channel bandwidth (the collective's
    boundary-transfer time) and ``total = mem_lat + NoCLat`` is the full
    Eq. 4 latency.  This is the single prediction the cost model
    (``CostModel.collective_cost_node`` of the JAX package's ``core/cost.py``) and the
    measured-collective calibration loop (``calibrate``) both
    charge — the calibration fitter inverts exactly this formula, so a
    fitted ``NoCParams`` fed back through here reproduces the measured
    sweep by construction.  Array-polymorphic like :func:`collective_cost`.
    """
    cc = collective_cost(col_type, data_volume, participants, noc)
    mem_lat = cc.volume_bytes / noc.channel_bandwidth
    return cc, mem_lat, mem_lat + noc_latency(cc, noc)


def collective_seconds(
    col_type: str,
    data_volume: float,
    participants: int,
    noc: NoCParams,
) -> float:
    """Eq. 4 total seconds for one collective (convenience over
    :func:`collective_latency_terms`)."""
    return collective_latency_terms(col_type, data_volume, participants,
                                    noc)[2]


def collective_overlap_terms(
    col_type: str,
    data_volume: float,
    participants: int,
    noc: NoCParams,
) -> Tuple[float, float]:
    """Per-collective-type ``(hideable, exposed)`` decomposition, seconds.

    ``hideable`` is the Eq. 1 MemLat term — the channel-bandwidth transfer
    time a double-buffered fused kernel can run concurrently with compute
    (gather chunk *i+1* in flight while chunk *i* is consumed).  ``exposed``
    is the Eq. 3 NoCLat enqueue/router term that stays serial no matter the
    schedule: every chunk still pays its injection and routing cost.  The
    cost model's overlap factor scales only the hideable term, and the
    calibration fitter (``calibrate/overlap.py``) expresses measured
    concurrent sweeps in exactly this split, so a fitted *achievable*
    overlap plugs into the model without unit conversion.
    """
    cc, mem_lat, total = collective_latency_terms(
        col_type, data_volume, participants, noc)
    return mem_lat, total - mem_lat


def overlapped_collective_seconds(
    col_type: str,
    data_volume: float,
    participants: int,
    noc: NoCParams,
    *,
    overlap: float = 0.0,
    compute_seconds: float = math.inf,
) -> float:
    """Eq. 4 seconds for one collective with ``overlap`` of its hideable
    time hidden under ``compute_seconds`` of dependency-adjacent compute
    (the scalar analog of the ``TileNode.overlap`` window adjustment in
    ``CostModel.tile_cost`` of the JAX package's ``core/cost.py``).  ``overlap=0`` is exactly
    :func:`collective_seconds`; the result never drops below the exposed
    enqueue term."""
    hideable, exposed = collective_overlap_terms(
        col_type, data_volume, participants, noc)
    hidden = overlap * min(hideable, compute_seconds)
    return hideable + exposed - hidden


def noc_latency(cost: CollectiveCost, noc: NoCParams) -> float:
    """Eq. 3: NoCLat = t_router * hops + t_enq * DV / W  (seconds)."""
    if is_array(cost.volume_bytes):
        lat = (noc.t_router * cost.hops
               + noc.t_enq * (cost.volume_bytes / noc.channel_width))
        return np.where(cost.volume_bytes > 0, lat, 0.0)
    if cost.volume_bytes <= 0:  # scalar-ok: is_array returned above
        return 0.0
    return noc.t_router * cost.hops + noc.t_enq * (cost.volume_bytes / noc.channel_width)
