"""Map-space search (COMET §V-A).

The 4-D design space of Fig. 1 — tiling factors x loop order/spatial
unrolling x collective strategy x scheduling — factors into a handful of
discrete *topologies* and a dense grid per topology (see
:mod:`.batcheval`): temporal tiling counts, the ``sp_cluster``/``sp_core``
spatial unrolling fanouts and the schedule mask are all grid axes.  For
the paper's compound ops the whole enumerable space is a few thousand
points, so ``search()`` is **exhaustive by default**: every topology's
grid is evaluated in one vectorized pass and the global optimum is
returned.  When the grid exceeds ``exhaustive_limit`` (custom candidate
sets, huge dims) it falls back to the paper's randomized + hill-climb
sampling (budget up to 10,000 iterations, deterministic under ``seed``),
now served through a shared LRU evaluation cache.

The spatial-fanout axes are **divisor-complete** by default: the
``sp_cluster``/``sp_core`` candidate sets take every divisor of the
physical instance counts *and* every divisor of the partitioned workload
dims that fits them (so a 3-way unrolling of N=768 on a 4-cluster mesh is
enumerated, not just powers of two), on top of the power-of-two ladder.
``candidate_specs(..., fanouts='pow2')`` recovers the old sets and
``divisor_tilings=True`` extends the m/k/n temporal axes the same way.

``objective='pareto'`` returns the latency/energy Pareto front instead of
a single scalar winner: ``SearchResult.front`` holds the non-dominated
(latency, energy_pj, spec) points in ascending-latency order and
``SearchResult.best`` is the front's minimum-latency mapping.
``objective='pareto3'`` adds the capacity-headroom channel for
provisioning studies: front points are (latency, energy_pj, headroom,
spec), latency/energy minimized and headroom maximized.

``search(..., candidate_list=[MappingSpec, ...])`` is **candidates
mode**: an explicit (possibly correlated) spec list is evaluated through
the batched engine instead of the enumerated axes — the entry point the
kernel autotuner and the :mod:`repro_torch.core.plan` layer use for
VMEM-prefiltered tile-pair sweeps.

``search_many()`` fans independent (workload, arch, kwargs) search cells
out over a ``concurrent.futures`` pool — the sweep driver used by the
benchmark harnesses.  Process-pool chunk assignment is **size-aware** by
default (``chunking='size'``): jobs are ordered by estimated space size
and dealt longest first, each to the chunk with the least estimated
work so far, so a ~117k-point exhaustive job starts immediately, and
alone, instead of serializing behind tiny cells;
``chunking='contiguous'`` restores plain slicing.  Chunking only
moves jobs between workers — results always come back in job order and
stay bit-identical.

**Executor contract** (``search_many``/``parallel_map``): results are
always returned in job order and are bit-identical across executors —
the same grids are evaluated by the same code regardless of where they
run, so ``executor='serial' | 'thread' | 'process'`` may be swapped
freely for scale without perturbing any reported optimum.

* ``'serial'`` — everything in the calling thread; the baseline the
  other executors must reproduce exactly.
* ``'thread'`` — a ``ThreadPoolExecutor`` sharing the in-process LRU
  grid/spec caches; cheap to start but GIL-bound on the Python parts of
  tree construction.
* ``'process'`` — a ``ProcessPoolExecutor`` fed **chunks** of jobs (so
  per-worker caches amortize across a chunk and pool workers persist
  across chunks).  Exhaustive-mode jobs return their per-topology
  :class:`~repro_torch.core.batcheval.BatchResult` grids through
  ``multiprocessing.shared_memory`` segments — the parent reattaches the
  arrays zero-copy (:func:`repro_torch.core.batcheval.batch_from_shm`) and
  runs the same reduction as the serial path; only tiny
  :class:`~repro_torch.core.batcheval.ShmBatchRef` descriptors cross the
  pickle channel.  Randomized-mode jobs (space above the exhaustive
  limit) return their small ``SearchResult`` via pickle as before.
  Segment lifecycle: workers create, the parent unlinks after reduction;
  a sweep-scoped name prefix lets :func:`cleanup_shm_segments` reclaim
  segments orphaned by a worker crash, and the reclamation runs on every
  sweep exit (success, error or ``BrokenProcessPool``).
* ``'auto'`` — ``'process'`` for sweeps of at least
  ``PROCESS_MIN_JOBS`` jobs when shared memory works on the platform,
  else ``'thread'``.

Degradations warn instead of failing: an unavailable process pool falls
back to threads, and a pool that *breaks* mid-sweep (OOM-killed worker)
finishes the remaining jobs serially — both emit a ``RuntimeWarning``.

Port-local copy of ``repro/core/search.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.  The process pool
differs in scheduling only, never in a result: its fork server preloads
this module (:func:`_mp_context`), chunks are reduced as they finish, a
pool has no more workers than chunks, and size-aware chunks are dealt to
the least-loaded chunk (:func:`_make_chunks`).
"""
from __future__ import annotations

import heapq
import inspect
import math
import os
import random
import secrets
import warnings
from concurrent.futures import (FIRST_COMPLETED, BrokenExecutor,
                                ProcessPoolExecutor, ThreadPoolExecutor,
                                wait)
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .batcheval import (OBJECTIVES, BatchResult, ParetoArchive, Topology,
                        batch_from_shm, batch_to_shm, enumerate_topologies,
                        evaluate_cached, evaluate_specs_batch,
                        evaluate_topology_grid, grid_size, pareto_merge,
                        pareto_merge3, shm_unlink)
from .hardware import Arch
from .ir import MappingResult, MappingSpec, evaluate_mapping
from .workload import CompoundOp

__all__ = ["SearchResult", "search", "search_many", "parallel_map",
           "candidate_specs", "pow2_tilings", "divisors",
           "fanout_candidates", "cleanup_shm_segments",
           "EXHAUSTIVE_LIMIT", "PROCESS_MIN_JOBS", "OVERLAP_CANDIDATES"]

# Exhaustive enumeration cap: above this many grid points per search the
# randomized fallback kicks in.  The paper-space grids are ~1e3-3e4
# points; re-budgeted (PR 4) so the divisor-tiling paper-table spaces —
# the largest is the non-pow2 provisioning GEMM on cloud at ~117k points
# — stay exhaustive.
EXHAUSTIVE_LIMIT = 131072

# Default compute–collective overlap candidate axis for overlap-searched
# runs (``search(..., overlap=OVERLAP_CANDIDATES)``).  0.0 keeps the
# serial point in the space (so the overlap-searched best can never lose
# to the serial best); 1.0 is the full double-buffered hiding the fused
# all-gather-GEMM kernel demonstrates; 0.5 is a conservative midpoint for
# schedules whose compute windows only partially cover the collective.
# A calibrated achievable overlap (``repro_torch.calibrate.overlap``) replaces
# the upper rungs when available.
OVERLAP_CANDIDATES = (0.0, 0.5, 1.0)

# search_many(executor='auto') switches from threads to the process pool
# at this many jobs: below it, pool fork/spawn overhead dominates the
# sweep; above it, bypassing the GIL wins.
PROCESS_MIN_JOBS = 8

# Randomized fallback: how many resamples one iteration spends to dodge
# an already-seen spec before conceding the iteration, and the bound on
# the online Pareto archive (ROADMAP: don't hold every valid sample).
DUPLICATE_RETRIES = 16
ARCHIVE_MAXLEN = 512


@dataclass
class SearchResult:
    best: MappingResult
    evaluated: int
    valid: int
    # (iteration, best objective score so far): latency/energy/edp score
    # for scalar objectives, latency (the hill-climb steer) for the front
    # objectives — NOT unconditionally latency.
    history: List[Tuple[int, float]] = field(default_factory=list)
    mode: str = "randomized"    # 'exhaustive' | 'randomized' | 'candidates'
    # objective='pareto': non-dominated (latency, energy_pj, spec) points,
    # ascending latency; objective='pareto3': (latency, energy_pj,
    # headroom, spec).  None for scalar objectives.
    front: Optional[List[Tuple]] = None
    # mode='candidates': index of the winning spec in the caller's
    # ``candidate_list`` (None for the enumerated modes).
    best_index: Optional[int] = None

    @property
    def latency(self) -> float:
        return self.best.latency

    @property
    def energy_pj(self) -> float:
        return self.best.energy_pj


def pow2_tilings(size: int, cap: int = 4096) -> List[int]:
    """Candidate temporal tile counts for a dimension: powers of two up to
    min(size, cap), always including 1 and the full size when small."""
    out = [1]
    t = 2
    while t <= min(size, cap):
        out.append(t)
        t *= 2
    if size <= cap and size not in out:
        out.append(size)
    return out


def divisors(n: int, cap: int = 4096) -> List[int]:
    """All divisors of ``n`` up to ``cap``, ascending (always >= [1])."""
    n = int(n)
    if n <= 1:
        return [1]
    out = set()
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            if d <= cap:
                out.add(d)
            q = n // d
            if q <= cap:
                out.add(q)
    return sorted(out)


def _with_divisors(base: List[int], size: int, cap: int) -> List[int]:
    """Union of a pow2 ladder with the divisors of ``size`` up to ``cap``."""
    return sorted(set(base) | set(divisors(size, cap=cap)))


def fanout_candidates(instances: int, dim_sizes: Sequence[int] = ()
                      ) -> List[int]:
    """Divisor-complete spatial-fanout candidates for a level with
    ``instances`` physical peers: the power-of-two ladder (so the set is
    always a superset of the old candidates), every divisor of the
    instance count, and every divisor of the partitioned workload dims
    that fits the level — e.g. N=768 on a 4-cluster mesh adds the 3-way
    unrolling that pow2 sets never consider."""
    out = set(pow2_tilings(instances)) | set(divisors(instances))
    for size in dim_sizes:
        out |= set(divisors(int(size), cap=instances))
    return sorted(out)


def _partition_dim_sizes(co: CompoundOp) -> List[int]:
    """The dim sizes the tree builders spatially partition: M/N for the
    GEMM-epilogue and attention families, every dim for the generic
    builder (it picks the most-shared dim at build time)."""
    sizes = [v for d, v in co.dim_sizes.items() if d in ("M", "N")]
    return sizes or list(co.dim_sizes.values())


def candidate_specs(co: CompoundOp, arch: Arch, *,
                    variants: Optional[Sequence[str]] = None,
                    allow_stats_gran: bool = False,
                    fanouts: str = "divisors",
                    divisor_tilings: bool = False,
                    overlap: Optional[Sequence[float]] = None
                    ) -> Dict[str, List]:
    """The discrete choice sets for each MappingSpec field.

    ``fanouts='divisors'`` (default) makes the sp_cluster/sp_core axes
    divisor-complete (:func:`fanout_candidates`); ``'pow2'`` restores the
    power-of-two-only sets.  ``divisor_tilings=True`` additionally unions
    the m/k/n temporal tile counts with the divisors of their dims (same
    caps), for workloads whose dims have non-pow2 factors.

    ``overlap`` is the compute–collective overlap candidate axis (values
    in [0, 1]); ``None`` (default) pins it to ``[0.0]`` — the pre-overlap
    serial charging, so existing searches stay bit-identical.  Pass
    :data:`OVERLAP_CANDIDATES` (or a calibrated achievable overlap from
    ``repro_torch.calibrate.overlap``) to let the search hide collective time
    under dependency-adjacent compute.
    """
    M = co.dim_sizes.get("M", 1)
    K = co.dim_sizes.get("K", 1)
    N = co.dim_sizes.get("N", 1)
    if variants is None:
        if co.name in ("attention", "flash_attention"):
            variants = ["ua", "pfa", "fa"]
        elif co.name in ("gemm_softmax", "gemm_layernorm"):
            variants = ["unfused", "fused_epilogue", "fused_std", "fused_dist"]
        else:
            variants = ["unfused", "fused_dist"]
    grans = ["tile", "stats"] if allow_stats_gran else ["tile"]
    m_tiles = pow2_tilings(M)
    k_tiles = pow2_tilings(K, cap=64)
    n_tiles = pow2_tilings(N, cap=256)
    if divisor_tilings:
        m_tiles = _with_divisors(m_tiles, M, 4096)
        k_tiles = _with_divisors(k_tiles, K, 64)
        n_tiles = _with_divisors(n_tiles, N, 256)
    if fanouts == "pow2":
        sp_cluster = pow2_tilings(arch.num_clusters)
        sp_core = pow2_tilings(arch.cores_per_cluster)
    elif fanouts == "divisors":
        # Spatial unrolling fanouts (Fig. 1 axis 2): divisor-complete
        # candidate sets — free grid axes of the batched engine, costed
        # through the tabulated per-P collective factors.
        part = _partition_dim_sizes(co)
        sp_cluster = fanout_candidates(arch.num_clusters, part)
        sp_core = fanout_candidates(arch.cores_per_cluster, part)
    else:
        raise ValueError(f"unknown fanouts mode {fanouts!r}")
    if overlap is None:
        overlaps = [0.0]
    else:
        overlaps = [float(o) for o in overlap]
        if not overlaps or any(o < 0.0 or o > 1.0 for o in overlaps):
            raise ValueError("overlap candidates must lie in [0, 1]")
    return {
        "variant": list(variants),
        "m_tiles": m_tiles,
        "k_tiles": k_tiles,
        "n_tiles": n_tiles,
        "sp_cluster": sp_cluster,
        "sp_core": sp_core,
        "schedule": ["sequential", "pipelined"],
        "overlap": overlaps,
        "collective_gran": grans,
        "loop_order_gb": [("M", "N"), ("N", "M")],
    }


def _sample(rng: random.Random, cands: Dict[str, List]) -> MappingSpec:
    return MappingSpec(
        variant=rng.choice(cands["variant"]),
        m_tiles=rng.choice(cands["m_tiles"]),
        k_tiles=rng.choice(cands["k_tiles"]),
        n_tiles=rng.choice(cands["n_tiles"]),
        sp_cluster=rng.choice(cands["sp_cluster"]),
        sp_core=rng.choice(cands["sp_core"]),
        schedule=rng.choice(cands["schedule"]),
        overlap=rng.choice(cands.get("overlap", [0.0])),
        collective_gran=rng.choice(cands["collective_gran"]),
        loop_order_gb=rng.choice(cands["loop_order_gb"]),
    )


def _mutate(rng: random.Random, spec: MappingSpec, cands: Dict[str, List]) -> MappingSpec:
    fieldname = rng.choice(list(cands.keys()))
    return replace(spec, **{fieldname: rng.choice(cands[fieldname])})


def _score_of(latency: float, energy_pj: float, valid: bool,
              objective: str) -> float:
    if not valid:
        return math.inf
    if objective == "latency":
        return latency
    if objective == "energy":
        return energy_pj
    return latency * energy_pj


# ------------------------------------------------------------------ search


def search(co: CompoundOp, arch: Arch, *,
           budget: int = 2000,
           seed: int = 0,
           objective: str = "latency",
           variants: Optional[Sequence[str]] = None,
           allow_stats_gran: bool = False,
           fanouts: str = "divisors",
           divisor_tilings: bool = False,
           overlap: Optional[Sequence[float]] = None,
           hillclimb_frac: float = 0.5,
           mode: str = "auto",
           exhaustive_limit: int = EXHAUSTIVE_LIMIT,
           candidate_list: Optional[Sequence[MappingSpec]] = None
           ) -> SearchResult:
    """Map-space search.  ``objective`` is 'latency', 'energy', 'edp'
    (energy-delay product), 'pareto' (latency/energy front) or 'pareto3'
    (latency/energy/capacity-headroom front; see ``SearchResult.front``).

    ``fanouts``/``divisor_tilings`` select the candidate axes (see
    :func:`candidate_specs`): divisor-complete spatial fanouts by default,
    ``fanouts='pow2'`` for the legacy power-of-two-only sets.

    ``mode``: 'exhaustive' evaluates the whole enumerable space through
    the batched engine; 'randomized' is the paper's sampling + hill-climb;
    'auto' (default) picks exhaustive whenever the space fits within
    ``exhaustive_limit`` points — which is both faster and provably
    no-worse than any sampled subset of the same space.

    ``candidate_list`` switches to **candidates mode**: instead of
    enumerating the generic axes, the explicit list of
    :class:`~repro_torch.core.ir.MappingSpec` candidates is evaluated through
    the batched engine (grouped by topology, original order preserved)
    and the best one wins.  This is the kernel-autotuning entry point:
    correlated candidate sets (e.g. VMEM-prefiltered (block_q, block_k)
    pairs) cannot be expressed as a product grid.  Selection: lowest
    objective score among the memory-fit-valid candidates; when the arch
    model rejects every candidate (a kernel pre-filter is the binding
    constraint then), lowest raw latency.  ``SearchResult.best_index``
    reports the winner's position in the list.  Scalar objectives only.
    """
    mode, cands, objective = _plan_search(co, arch, {
        "objective": objective, "variants": variants,
        "allow_stats_gran": allow_stats_gran, "fanouts": fanouts,
        "divisor_tilings": divisor_tilings, "overlap": overlap,
        "mode": mode, "exhaustive_limit": exhaustive_limit,
        "candidate_list": candidate_list})
    if mode == "candidates":
        return _search_candidates(co, arch, list(candidate_list), objective)
    if mode == "exhaustive":
        return _search_exhaustive(co, arch, cands, objective)
    if mode == "randomized":
        return _search_randomized(co, arch, cands, budget=budget, seed=seed,
                                  objective=objective,
                                  hillclimb_frac=hillclimb_frac)
    raise ValueError(f"unknown search mode {mode!r}")


def _plan_search(co: CompoundOp, arch: Arch, kw: Dict
                 ) -> Tuple[str, Dict[str, List], str]:
    """Resolve a search job's (mode, candidate axes, objective) exactly
    as :func:`search` would — same kwarg defaults (read from search()'s
    own signature, so they cannot drift), same auto rule — without
    running it.  Shared by ``search()`` and the process-pool sweep
    workers so both sides of the wire agree on the search plan."""
    def opt(name: str):
        return kw.get(name, _SEARCH_DEFAULTS[name])

    objective = opt("objective")
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if opt("candidate_list") is not None:
        if objective in ("pareto", "pareto3"):
            raise ValueError(
                "candidate_list mode supports scalar objectives only")
        return "candidates", {}, objective
    cands = candidate_specs(
        co, arch, variants=opt("variants"),
        allow_stats_gran=opt("allow_stats_gran"),
        fanouts=opt("fanouts"),
        divisor_tilings=opt("divisor_tilings"),
        overlap=opt("overlap"))
    mode = opt("mode")
    if mode == "auto":
        topos = enumerate_topologies(co, cands)
        total = len(topos) * grid_size(co, cands)
        mode = ("exhaustive" if total <= opt("exhaustive_limit")
                else "randomized")
    return mode, cands, objective


def _search_exhaustive(co: CompoundOp, arch: Arch, cands: Dict[str, List],
                       objective: str) -> SearchResult:
    grids = (evaluate_topology_grid(co, arch, topo, cands)
             for topo in enumerate_topologies(co, cands))
    return _reduce_grids(co, arch, grids, objective)


def _search_candidates(co: CompoundOp, arch: Arch,
                       specs: List[MappingSpec],
                       objective: str) -> SearchResult:
    """Candidates mode: evaluate an explicit spec list through the batched
    engine.  Specs are grouped by topology (variant/collective granularity
    /GB loop order) so each group is one SoA pass with the schedule as a
    parallel axis; scores land back at the specs' original positions, so
    selection order (ties included) matches evaluating the list in order.
    """
    import numpy as np

    if not specs:
        raise ValueError("candidate_list is empty")
    n = len(specs)
    lat = np.empty(n)
    en = np.empty(n)
    valid = np.zeros(n, dtype=bool)
    groups: Dict[Tuple, List[int]] = {}
    for i, s in enumerate(specs):
        groups.setdefault(
            (s.variant, s.collective_gran, tuple(s.loop_order_gb)),
            []).append(i)
    for (variant, gran, lo), idxs in groups.items():
        topo = Topology(variant=variant, collective_gran=gran,
                        loop_order_gb=lo)
        ovs = [specs[i].overlap for i in idxs]
        br = evaluate_specs_batch(
            co, arch, topo,
            [specs[i].m_tiles for i in idxs],
            [specs[i].k_tiles for i in idxs],
            [specs[i].n_tiles for i in idxs],
            [specs[i].sp_cluster for i in idxs],
            [specs[i].sp_core for i in idxs],
            [specs[i].schedule for i in idxs],
            # all-serial candidate lists keep the bit-identical
            # pre-overlap path
            ovs if any(o != 0.0 for o in ovs) else None)
        lat[idxs] = br.latency
        en[idxs] = br.energy_pj
        valid[idxs] = br.valid
    if valid.any():
        scores = np.where(
            valid,
            lat if objective == "latency"
            else en if objective == "energy" else lat * en,
            np.inf)
        i = int(np.argmin(scores))
        score = float(scores[i])
    else:
        # every candidate rejected by the arch model: the caller's own
        # pre-filters (e.g. kernel VMEM constraints) are the binding
        # constraint, so fall back to raw latency order
        i = int(np.argmin(lat))
        score = float(lat[i])
    best = evaluate_mapping(co, arch, specs[i])
    return SearchResult(best=best, evaluated=n, valid=int(valid.sum()),
                        history=[(n, score)], mode="candidates",
                        best_index=i)


def _reduce_grids(co: CompoundOp, arch: Arch, grids: Iterable[BatchResult],
                  objective: str) -> SearchResult:
    """Fold per-topology grids into a SearchResult.  This is the single
    reduction used by the serial/thread paths (grids evaluated in
    process) AND the process-pool parent (grids reattached from shared
    memory), which is what makes executor choice bit-invisible."""
    pareto = objective in ("pareto", "pareto3")
    best_spec: Optional[MappingSpec] = None
    best_score = math.inf
    best_latency = math.inf
    evaluated = valid = 0
    history: List[Tuple[int, float]] = []
    front_pts: List[Tuple] = []
    for br in grids:
        evaluated += br.size
        valid += int(br.valid.sum())
        if objective == "pareto3":
            front_pts.extend(
                (float(br.latency[i]), float(br.energy_pj[i]),
                 float(br.headroom[i]), br.spec_at(i))
                for i in br.pareto_front3())
            continue
        if objective == "pareto":
            # per-topology vectorized skyline; merged globally below
            front_pts.extend(
                (float(br.latency[i]), float(br.energy_pj[i]), br.spec_at(i))
                for i in br.pareto_front())
            continue
        i = br.best_index(objective)
        if i is None:
            continue
        s = float(br.scores(objective)[i])
        if s < best_score:
            best_score = s
            best_spec = br.spec_at(i)
            best_latency = float(br.latency[i])
            history.append((evaluated, s))
    front: Optional[List[Tuple]] = None
    if pareto:
        front = (pareto_merge3(front_pts) if objective == "pareto3"
                 else pareto_merge(front_pts))
        if front:
            best_latency = front[0][0]
            best_spec = front[0][-1]
            history.append((evaluated, best_latency))
    if best_spec is None:
        raise RuntimeError(f"no valid mapping found for {co.name} on {arch.name}")
    best = evaluate_mapping(co, arch, best_spec)
    return SearchResult(best=best, evaluated=evaluated, valid=valid,
                        history=history, mode="exhaustive", front=front)


def _search_randomized(co: CompoundOp, arch: Arch, cands: Dict[str, List], *,
                       budget: int, seed: int, objective: str,
                       hillclimb_frac: float) -> SearchResult:
    pareto = objective in ("pareto", "pareto3")
    # Front modes keep a bounded online non-dominated archive instead of
    # every valid sample (ROADMAP); latency steers the hill-climb.
    scalar_objective = "latency" if pareto else objective
    rng = random.Random(seed)
    best_spec: Optional[MappingSpec] = None
    best_score = math.inf
    evaluated = valid = 0
    history: List[Tuple[int, float]] = []
    archive = (ParetoArchive(dims=3 if objective == "pareto3" else 2,
                             maxlen=ARCHIVE_MAXLEN) if pareto else None)
    seen = set()

    explore = max(1, int(budget * (1.0 - hillclimb_frac)))
    for i in range(budget):
        # An already-seen spec would burn the iteration without learning
        # anything — resample (bounded) until an unseen one turns up.
        spec = None
        for _ in range(DUPLICATE_RETRIES):
            cand = (_sample(rng, cands) if best_spec is None or i < explore
                    else _mutate(rng, best_spec, cands))
            if cand not in seen:
                spec = cand
                break
        if spec is None:
            continue
        seen.add(spec)
        r = evaluate_cached(co, arch, spec)
        if r is None:
            continue
        latency, energy_pj, is_valid, headroom = r
        evaluated += 1
        if is_valid:
            valid += 1
            if objective == "pareto3":
                archive.add((latency, energy_pj, headroom, spec))
            elif objective == "pareto":
                archive.add((latency, energy_pj, spec))
        s = _score_of(latency, energy_pj, is_valid, scalar_objective)
        if s < best_score:
            best_spec, best_score = spec, s
            # convergence curve logs the objective score (== latency for
            # the latency-steered front modes), not latency regardless
            history.append((i, s))

    if best_spec is None:
        raise RuntimeError(f"no valid mapping found for {co.name} on {arch.name}")
    best = evaluate_mapping(co, arch, best_spec)
    return SearchResult(best=best, evaluated=evaluated, valid=valid,
                        history=history, mode="randomized",
                        front=archive.front() if pareto else None)


# ------------------------------------------------------------ sweep driver


def _norm_job(job) -> Tuple[CompoundOp, Arch, Dict]:
    if isinstance(job, dict):
        kw = dict(job)
        return kw.pop("co"), kw.pop("arch"), kw
    if len(job) == 2:
        co, arch = job
        return co, arch, {}
    co, arch, kw = job
    return co, arch, dict(kw)


def _run_search_job(job) -> SearchResult:
    co, arch, kw = _norm_job(job)
    return search(co, arch, **kw)


def _mp_context():
    """The start method of both process pools: ``forkserver`` where the
    platform has it, else ``spawn``; never ``fork`` of the caller.  A
    forked caller's worker inherits every lock another thread of the
    caller holds at that moment, among them the ``resource_tracker`` lock
    that attaching or unlinking a shared-memory segment takes, and can
    wait on it forever.  The workers' entry points (``_run_search_job``,
    ``_run_search_chunk``) are module-level, so a fresh interpreter
    imports them by name.

    The fork server preloads this module: it imports the package, and
    ``torch`` with it, once, when the first pool starts, and every worker
    is a fork of that single-threaded server with the import done.
    Without it each worker of each pool imported ``torch`` anew, which
    cost a 48-job sweep more than its searches.  The server imports the
    module through its own path, which older Python 3.12 releases take
    from ``PYTHONPATH`` and not from the caller's ``sys.path``; where it
    cannot, each worker imports the module itself, as without the
    preload.  A server already running keeps the preload it started
    with."""
    import multiprocessing
    if "forkserver" in multiprocessing.get_all_start_methods():
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        return ctx
    return multiprocessing.get_context("spawn")


def parallel_map(fn: Callable, items: Sequence, *,
                 max_workers: Optional[int] = None,
                 executor: str = "auto") -> List:
    """Order-preserving parallel map over independent work items.

    ``executor``: 'thread' (default under 'auto' — shares the in-process
    evaluation caches and NumPy releases the GIL in the hot loops),
    'process' (bypasses the GIL; items/results must pickle), or 'serial'.
    Falls back to serial execution when a pool cannot be created (e.g.
    sandboxed environments without working multiprocessing primitives),
    and — for the items not yet completed — when the pool *breaks*
    mid-sweep (a worker killed by the OOM killer or a signal raises
    ``BrokenProcessPool`` out of ``pool.map``); a RuntimeWarning is
    emitted so the degradation is visible.  Ordinary exceptions raised by
    ``fn`` itself always propagate.
    """
    items = list(items)
    if executor == "serial" or len(items) <= 1:
        return [fn(it) for it in items]
    try:
        pool = (ProcessPoolExecutor(max_workers=max_workers,
                                    mp_context=_mp_context())
                if executor == "process"
                else ThreadPoolExecutor(max_workers=max_workers))
    except (OSError, PermissionError, ImportError) as e:
        # Pool creation failed (e.g. sandbox without multiprocessing
        # primitives) — errors raised by fn itself still propagate below.
        warnings.warn(
            f"parallel_map: could not create a {executor!r} pool ({e!r}); "
            "running serially", RuntimeWarning, stacklevel=2)
        return [fn(it) for it in items]
    results: List = []
    try:
        with pool:
            if executor == "process":
                # Amortize per-item pickling for short tasks.
                chunk = max(1, len(items)
                            // (32 * (max_workers or os.cpu_count() or 4)))
                it = pool.map(fn, items, chunksize=chunk)
            else:
                it = pool.map(fn, items)
            for r in it:
                results.append(r)
    except BrokenExecutor as e:
        # A worker died mid-sweep (e.g. OOM-killed): salvage the completed
        # prefix and finish the remaining items serially instead of losing
        # the whole sweep.
        warnings.warn(
            f"parallel_map: worker pool broke after {len(results)}/"
            f"{len(items)} items ({e!r}); finishing remaining items "
            "serially", RuntimeWarning, stacklevel=2)
        results.extend(fn(it) for it in items[len(results):])
    return results


def _shm_usable() -> bool:
    """One-shot probe: can this platform create (and unlink) a
    ``multiprocessing.shared_memory`` segment with POSIX persist-until-
    unlink semantics?  Memoized — sandboxes without /dev/shm or the
    _posixshmem module probe once, not per sweep.  Non-POSIX platforms
    are excluded outright: Windows named shared memory is freed when the
    last handle closes, so the create-in-worker / close / attach-in-
    parent lifecycle would lose the segment before the parent attaches
    (jobs then take the pickle wire instead)."""
    global _SHM_USABLE
    if _SHM_USABLE is None:
        if os.name != "posix":
            _SHM_USABLE = False
            return _SHM_USABLE
        try:
            from multiprocessing import shared_memory
            seg = shared_memory.SharedMemory(create=True, size=1)
            seg.close()
            seg.unlink()
            _SHM_USABLE = True
        except Exception:
            _SHM_USABLE = False
    return _SHM_USABLE


_SHM_USABLE: Optional[bool] = None


def cleanup_shm_segments(prefix: str) -> List[str]:
    """Best-effort reclamation of shared-memory segments whose names
    start with ``prefix`` (a sweep-scoped token): unlinks and returns the
    names found.  This is the crash backstop of the process-pool sweep —
    a worker that dies between creating a segment and returning its
    :class:`~repro_torch.core.batcheval.ShmBatchRef` orphans the segment, and
    the parent cannot learn its name through the broken pool.  POSIX
    ``/dev/shm`` scan; a no-op on platforms without it."""
    removed: List[str] = []
    base = "/dev/shm"
    if not os.path.isdir(base):
        return removed
    try:
        names = os.listdir(base)
    except OSError:
        return removed
    for fn in names:
        if fn.startswith(prefix) and shm_unlink(fn):
            removed.append(fn)
    return removed


# Keyword arguments search() accepts and their default values — derived
# from the signature so the process-path kwarg validation and
# _plan_search's defaults can never drift from search() itself.
_SEARCH_DEFAULTS = {
    name: p.default for name, p in inspect.signature(search).parameters.items()
    if name not in ("co", "arch")}
_SEARCH_KWARGS = frozenset(_SEARCH_DEFAULTS)


def _run_search_chunk(payload: Tuple) -> List[Tuple]:
    """Process-pool worker: run a chunk of search jobs, one wire tuple
    per job.  Exhaustive-mode jobs evaluate their per-topology grids
    (through the worker's persistent LRU grid cache — chunking exists so
    repeated (co, arch) cells amortize it) and ship them as
    ``('grids', objective, [ShmBatchRef, ...])``; randomized-mode jobs
    (or all jobs when shared memory is unusable) run to completion and
    ship ``('result', SearchResult)`` through pickle."""
    prefix, use_shm, chunk = payload
    out: List[Tuple] = []
    for job in chunk:
        co, arch, kw = _norm_job(job)
        # The shm shortcut reads kwargs with .get() defaults, so an
        # unknown (typoed) kwarg must NOT be silently ignored here while
        # serial/thread raise TypeError from search(**kw): fall through
        # to search() so every executor rejects the job identically.
        if use_shm and set(kw) <= _SEARCH_KWARGS:
            mode, cands, objective = _plan_search(co, arch, kw)
            if mode == "exhaustive":
                refs = []
                try:
                    for topo in enumerate_topologies(co, cands):
                        br = evaluate_topology_grid(co, arch, topo, cands)
                        refs.append(batch_to_shm(br, prefix=prefix))
                except BaseException:
                    # the job dies with its segments, not with a leak
                    for ref in refs:
                        shm_unlink(ref.shm_name)
                    raise
                out.append(("grids", objective, refs))
                continue
            if mode == "randomized":
                # reuse the resolved plan instead of paying
                # candidate/topology enumeration again inside search()
                out.append(("result", _search_randomized(
                    co, arch, cands,
                    budget=kw.get("budget", _SEARCH_DEFAULTS["budget"]),
                    seed=kw.get("seed", _SEARCH_DEFAULTS["seed"]),
                    objective=objective,
                    hillclimb_frac=kw.get(
                        "hillclimb_frac",
                        _SEARCH_DEFAULTS["hillclimb_frac"]))))
                continue
            # an explicitly-passed unknown mode falls through: search()
            # raises the same ValueError the serial path would
        out.append(("result", search(co, arch, **kw)))
    return out


def _attach_refs(refs: Sequence, brs: List[BatchResult],
                 shms: List) -> None:
    """Attach every ref, appending in lockstep (in its own frame so no
    stray local keeps a view alive past the caller's cleanup)."""
    for ref in refs:
        br, shm = batch_from_shm(ref)
        brs.append(br)
        shms.append(shm)


def _finish_wire(co: CompoundOp, arch: Arch, wire: Tuple) -> SearchResult:
    """Parent-side completion of one worker wire tuple.  For ``'grids'``
    wires: reattach each BatchResult zero-copy, run the shared
    :func:`_reduce_grids` reduction (identical to the serial path), then
    unlink the segments — on success or failure."""
    if wire[0] == "result":
        return wire[1]
    _kind, objective, refs = wire
    shms: List = []
    brs: List[BatchResult] = []
    try:
        _attach_refs(refs, brs, shms)
        return _reduce_grids(co, arch, brs, objective)
    finally:
        brs.clear()                  # drop the views before close()
        for shm in shms:
            try:
                shm.close()
            except BufferError:      # a view outlived the reduction
                pass
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        for ref in refs[len(shms):]:     # attach failed partway
            shm_unlink(ref.shm_name)


def _job_size_estimate(co: CompoundOp, arch: Arch, kw: Dict) -> int:
    """Rough per-job cost proxy for size-aware chunk assignment: grid
    points x topologies for exhaustive-bound jobs, the sampling budget
    for randomized ones, the list length for candidates mode.  Only
    relative order matters; any failure degrades to 1 (the job still
    runs, it just gets no scheduling priority)."""
    try:
        cl = kw.get("candidate_list")
        if cl is not None:
            return len(cl)
        if not set(kw) <= _SEARCH_KWARGS:
            return 1
        mode, cands, _obj = _plan_search(co, arch, kw)
        if mode == "randomized":
            return int(kw.get("budget", _SEARCH_DEFAULTS["budget"]))
        return len(enumerate_topologies(co, cands)) * grid_size(co, cands)
    except Exception:
        return 1


def _make_chunks(jobs: List[Tuple[CompoundOp, Arch, Dict]], chunksize: int,
                 chunking: str) -> List[List[Tuple[int, Tuple]]]:
    """Split ``jobs`` into chunks of ``(original_index, job)`` pairs.

    ``chunking='size'`` (default) estimates each job's space size and
    deals the jobs longest first, each to the chunk with the least
    estimated work so far (ties to the lower chunk), so a single
    ~117k-point exhaustive job opens the first chunk and starts
    immediately instead of serializing behind a chunk of tiny ones
    (ROADMAP: job costs vary by ~100x when randomized cells sit next to
    tiny exhaustive cells), and no tiny job joins it while a lighter
    chunk is left: ``repro.core.search``'s round-robin deal put three tiny
    jobs behind the huge one, which made the size-aware sweep slower than
    contiguous chunks where every chunk had a worker of its own.  Jobs of
    equal size are dealt round-robin, as there.
    ``chunking='contiguous'`` keeps the pre-PR-5 contiguous slices.
    Either way results are reassembled in job order and each job's
    evaluation is untouched, so the executor bit-identity contract holds.
    """
    n_chunks = max(1, math.ceil(len(jobs) / chunksize))
    indexed = list(enumerate(jobs))
    if chunking == "contiguous":
        return [indexed[i:i + chunksize]
                for i in range(0, len(indexed), chunksize)]
    if chunking != "size":
        raise ValueError(f"unknown chunking mode {chunking!r}")
    sizes = [_job_size_estimate(co, arch, kw) for co, arch, kw in jobs]
    chunks: List[List[Tuple[int, Tuple]]] = [[] for _ in range(n_chunks)]
    loads = [(0, c) for c in range(n_chunks)]      # (estimated work, chunk)
    for i in sorted(range(len(jobs)), key=lambda i: (-sizes[i], i)):
        load, c = heapq.heappop(loads)
        chunks[c].append(indexed[i])
        heapq.heappush(loads, (load + sizes[i], c))
    return [c for c in chunks if c]


def _search_many_process(jobs: List[Tuple[CompoundOp, Arch, Dict]], *,
                         max_workers: Optional[int],
                         chunksize: Optional[int],
                         chunking: str = "size") -> List[SearchResult]:
    """The process-pool sweep path: chunked job scheduling over a
    ``ProcessPoolExecutor`` with shared-memory grid transport.  Falls
    back — warning, never failing — to threads when the pool cannot be
    created and to serial execution of the remaining jobs when the pool
    breaks mid-sweep; every exit path reclaims the sweep's segments."""
    use_shm = _shm_usable()
    # Short sweep-scoped prefix: batch_to_shm appends '_' + 8 hex chars
    # and macOS caps shm names at 31 chars including the leading slash.
    prefix = f"cm{os.getpid():x}x{secrets.token_hex(2)}"
    workers = max_workers or os.cpu_count() or 2
    if chunksize is None:
        # ~4 chunks per worker: coarse enough to amortize per-chunk
        # dispatch and per-worker cache warmup, fine enough to balance.
        chunksize = max(1, math.ceil(len(jobs) / (workers * 4)))
    chunks = _make_chunks(jobs, chunksize, chunking)
    try:
        # no more workers than chunks: a worker with no chunk costs a
        # fork and takes a core from the reductions here
        pool = ProcessPoolExecutor(max_workers=min(workers, len(chunks)),
                                   mp_context=_mp_context())
    except (OSError, PermissionError, ImportError) as e:
        warnings.warn(
            f"search_many: process pool unavailable ({e!r}); falling back "
            "to threads", RuntimeWarning, stacklevel=3)
        return parallel_map(_run_search_job, jobs, max_workers=max_workers,
                            executor="thread")
    results: List[Optional[SearchResult]] = [None] * len(jobs)
    done = 0
    broken: Optional[BaseException] = None
    try:
        with pool:
            # Bounded submission window (~2 chunks in flight per worker,
            # refilled as results drain): submitting everything upfront
            # would let completed-but-unconsumed grids pile up in
            # /dev/shm — worst case the whole sweep's grid bytes against
            # a RAM-capped tmpfs.  Chunks are consumed as they finish,
            # not in submission order: the huge job that size-aware
            # chunking deals into the first chunk then holds back no
            # other chunk's reduction (each job's reduction is its own,
            # so the results are the same in either order).
            window = max(2 * workers, 1)
            pending: List[Tuple[List, object]] = []
            submitted = 0

            def refill() -> None:
                nonlocal submitted
                while submitted < len(chunks) and len(pending) < window:
                    c = chunks[submitted]
                    pending.append(
                        (c, pool.submit(_run_search_chunk,
                                        (prefix, use_shm,
                                         [job for _i, job in c]))))
                    submitted += 1

            refill()
            while pending:
                finished, _ = wait([f for _c, f in pending],
                                   return_when=FIRST_COMPLETED)
                chunk, fut = pending.pop(next(
                    i for i, (_c, f) in enumerate(pending) if f in finished))
                try:
                    wires = fut.result()
                except BrokenExecutor as e:
                    broken = e
                    for _c, f in pending:
                        f.cancel()
                    break
                refill()        # keep workers busy during the reduction
                for (idx, (co, arch, _kw)), wire in zip(chunk, wires):
                    results[idx] = _finish_wire(co, arch, wire)
                    done += 1
        if broken is not None:
            warnings.warn(
                f"search_many: worker pool broke after {done}/"
                f"{len(jobs)} jobs ({broken!r}); finishing remaining jobs "
                "serially", RuntimeWarning, stacklevel=3)
            for i, job in enumerate(jobs):
                if results[i] is None:
                    results[i] = _run_search_job(job)
    finally:
        # Reclaims segments orphaned by a crashed worker (their refs
        # never arrived) or dropped mid-delivery; finds nothing on the
        # clean path, where _finish_wire unlinked each segment already.
        cleanup_shm_segments(prefix)
    return results


def search_many(jobs: Sequence, *,
                max_workers: Optional[int] = None,
                executor: str = "auto",
                chunksize: Optional[int] = None,
                chunking: str = "size") -> List[SearchResult]:
    """Parallel sweep driver: run many independent searches concurrently.

    Each job is ``(co, arch)``, ``(co, arch, kwargs)`` or a dict with
    ``co``/``arch`` keys plus search kwargs.  Results come back in job
    order and are bit-identical across executors (see the module
    docstring for the full executor contract).

    ``executor='process'`` runs jobs in chunks (``chunksize`` jobs per
    task, default ~4 chunks per worker) on a process pool, shipping
    exhaustive-mode grids back through shared memory; ``'thread'`` and
    ``'serial'`` behave as before; ``'auto'`` picks ``'process'`` for
    sweeps of at least ``PROCESS_MIN_JOBS`` jobs when the platform
    supports shared memory, else ``'thread'``.  Used by
    ``benchmarks/paper_tables.py`` and friends to fan out
    (workload, arch, variant) cells.

    ``chunking`` selects how jobs map to process-pool chunks:
    ``'size'`` (default) estimates each job's space size and assigns
    longest first to the least-loaded chunk so one huge exhaustive job
    cannot serialize behind a chunk of tiny ones; ``'contiguous'``
    slices jobs in order.  Chunk assignment never changes any result — only
    scheduling (results are reassembled in job order either way).
    """
    if chunking not in ("size", "contiguous"):
        raise ValueError(f"unknown chunking mode {chunking!r}")
    jobs = [_norm_job(j) for j in jobs]
    if executor == "auto":
        executor = ("process"
                    if len(jobs) >= PROCESS_MIN_JOBS and _shm_usable()
                    else "thread")
    if executor == "process" and len(jobs) > 1:
        return _search_many_process(jobs, max_workers=max_workers,
                                    chunksize=chunksize, chunking=chunking)
    return parallel_map(_run_search_job, jobs, max_workers=max_workers,
                        executor=executor)
