"""COMET-driven tile selection for the port's Hopper kernels (the
kernel-level use of the paper's cost model).

Port of ``repro/kernels/autotune.py``.  For each kernel this builds the
matching compound-op workload, takes the card as one node
(:func:`~repro_torch.core.hardware.h100`; for the fused GEMM epilogues,
one thread-block cluster, :func:`~repro_torch.core.hardware.h100_cluster`),
and ranks the candidate tilings
with the **shared search engine**: ``search(candidate_list=...)`` routes
the candidates through the batched evaluator (core/batcheval.py), the same
memory-fit validation and Eq. 1-7 latency model the map-space search uses.
A candidate maps onto MappingSpec tile counts (block -> ceil(dim / block)
temporal tiles), and both Eq. 5-7 schedules are evaluated per candidate in
the same pass.

The candidates are the tilings the port's kernels take at that shape, not
a ladder of block sizes: a plan may choose only what a kernel runs.

* FlashAttention: ``flash_attention.tiling`` in bf16 has one tiling a
  head dim (128 q rows a work item, sharing each 128-key K/V tile, in a
  ring as deep as shared memory holds), so its list holds that one.
* The fused GEMM epilogues: every tiling of ``gemm_epilogue.tilings(N,
  dtype)`` (the cluster that shares a row block, the rows of a block, the
  columns of a CTA's slice, the column passes).  A cluster of CL CTAs is
  modelled as ``h100_cluster`` of CL SMs, DSMEM its cluster NoC, over the
  rows one cluster processes in a launch (the row blocks spread over the
  floor(132 / CL) clusters a wave holds); the row statistics' All-Reduce
  over the cluster is charged at ``collective_gran="stats"``.  One job per
  cluster size (and rows a cluster, where two instances differ there);
  the least modelled latency across the jobs wins.
* The SSD chunk scan: the chunks the kernel takes, at most its 64
  (``ssd.CHUNK``): 16, 32 and 64, each a workload of its own.

Each rule stays where it is (``flash_attention.tiling``,
``gemm_epilogue.tilings``, ``ssd.tiling``); a shape a kernel refuses has no
candidate, and its entry point returns the default below.  The fused
GEMM wrappers launch the plan's tiling (``gemm_epilogue.planned_tiling``)
and the SSD chunk reaches its kernel through the model
(``models/ssm.py``); FlashAttention's one bf16 tile leaves its plan
nothing to choose, so its wrapper reads none.

Every entry point resolves through the :class:`repro_torch.core.plan.
PlanCache`: the first call per (shape, arch, engine version) solves and
persists a plan (:mod:`repro_torch.core.planstore`: SQLite WAL, degrading
to a JSON dir or memory only under store faults), so every later call, in
this process or any other pointed at the same ``$REPRO_PLAN_CACHE``, is a
lookup with no search.  The serving engine pre-populates the cache at
startup (``ServeEngine.warm_plans``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.hardware import Arch, h100, h100_cluster
from ..core.ir import MappingSpec
from ..core.plan import get_plan_cache
from ..core.workload import (CompoundOp, flash_attention, gemm_softmax,
                             ssd_chunk)
from . import flash_attention as fa
from . import gemm_epilogue as ge
from . import ssd

__all__ = ["attention_blocks", "gemm_epilogue_blocks",
           "gemm_epilogue_tiling", "ssd_chunk_len", "PAPER_KERNEL_SHAPES",
           "plan_jobs", "attention_plan_job", "gemm_epilogue_plan_job",
           "ssd_plan_jobs", "SSD_CHUNKS", "CLUSTER_MESH"]

SCHEDULES = ("sequential", "pipelined")

# Compute-collective overlap axis for kernel candidates.  On the one-node
# kernel arch collectives cost zero, so the axis is inert (ties break to
# overlap=0.0, the serial point), as in the JAX package; on a cluster
# (``h100_cluster``) it prices hiding the DSMEM All-Reduce.
OVERLAPS = (0.0, 1.0)

# The mesh each cluster size of the fused GEMM epilogues is modelled on
# (``h100_cluster``)
CLUSTER_MESH = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4), 16: (4, 4)}

# The SSD chunks the kernel takes (``ssd._check``: at most ``ssd.CHUNK``)
SSD_CHUNKS = (16, 32, 64)

# The kernel shapes of the JAX package's paper tables and kernel sweeps,
# the set a warm plan store must answer without solving.
PAPER_KERNEL_SHAPES: Dict[str, List[Tuple[int, ...]]] = {
    "attention_blocks": [(1024, 1024, 64), (4096, 4096, 128),
                         (1, 32768, 128), (32768, 32768, 128)],
    "gemm_epilogue_blocks": [(512, 4096, 128), (4096, 4096, 4096),
                             (4096, 16384, 4096)],
    "ssd_chunk_len": [(4096, 64, 128)],
}

_KERNEL_ARCH: Optional[Arch] = None
_CLUSTER_ARCHS: Dict[int, Arch] = {}

# Per-shape memo of *job descriptions* (compound op + candidate list): the
# question, never the answer.  Every call still resolves through the
# PlanCache; this only avoids rebuilding identical candidate sets (and
# lets the plan layer's fingerprint memos hit by identity).
_JOB_MEMO: Dict[Tuple, object] = {}
_JOB_MEMO_MAX = 1024


def _memo_job(key: Tuple, build):
    hit = _JOB_MEMO.get(key)
    if hit is None and key not in _JOB_MEMO:
        if len(_JOB_MEMO) >= _JOB_MEMO_MAX:
            _JOB_MEMO.clear()
        hit = _JOB_MEMO[key] = build()
    return hit


def _kernel_arch() -> Arch:
    """The card as one node (:func:`h100`).  Memoized by hand: this module
    keeps no functools result caches; selections live in the PlanCache
    alone."""
    global _KERNEL_ARCH
    if _KERNEL_ARCH is None:
        _KERNEL_ARCH = h100()
    return _KERNEL_ARCH


def _cluster_arch(cl: int) -> Arch:
    """One thread-block cluster of ``cl`` SMs (:func:`h100_cluster` on
    ``CLUSTER_MESH[cl]``), memoized by hand as :func:`_kernel_arch`."""
    arch = _CLUSTER_ARCHS.get(cl)
    if arch is None:
        arch = _CLUSTER_ARCHS[cl] = h100_cluster(CLUSTER_MESH[cl])
    return arch


def _candidate_specs(variant: str, tiles: Sequence[Dict],
                     **fixed) -> Tuple[MappingSpec, ...]:
    """Candidate MappingSpecs in (schedule, overlap)-major order, tilings
    minor; ``fixed`` fields are the same in every spec.  A tuple:
    immutable sequences are what the plan layer's fingerprint memo may
    cache by identity."""
    return tuple(MappingSpec(variant=variant, schedule=s, overlap=ov,
                             **fixed, **t)
                 for s in SCHEDULES for ov in OVERLAPS for t in tiles)


def _pair_of(plan, pairs: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Winning pair of a candidates-mode plan: the stored ``best_index``
    walks the (schedule, overlap)-major candidate list with the pairs
    minor, so modulo the pair count recovers the pair whichever
    schedule/overlap rung won."""
    return pairs[plan.best_index % len(pairs)]


# ------------------------------------------------------------ attention


def _attention_pairs(sq: int, skv: int, d: int) -> List[Tuple[int, int]]:
    """(block_q, block_k) of the bf16 kernel: the q rows a work item holds
    (two heads of 64 rows, or one of 128) and the keys of a K/V tile;
    none where the kernel refuses the shape."""
    try:
        t = fa.tiling(1, 2, 1, sq, skv, d, torch.bfloat16)
    except ValueError:
        return []
    return [(t.q_rows * t.consumers, t.keys)]


def attention_plan_job(sq: int, skv: int, d: int
                       ) -> Optional[Tuple[CompoundOp, Arch, Dict,
                                           List[Tuple[int, int]]]]:
    """The plan job behind :func:`attention_blocks`: ``(co, arch,
    search_kw, pairs)``, or None when the kernel takes no tiling there.
    The job triple is what warmup feeds to ``PlanCache.warmup``, so its
    cache keys match the lookups exactly."""
    def build():
        pairs = _attention_pairs(sq, skv, d)
        if not pairs:
            return None
        M = max(sq, max(bq for bq, _ in pairs))
        N = max(skv, max(bk for _, bk in pairs))
        co = flash_attention(M, d, N, d)
        tiles = [{"m_tiles": math.ceil(M / bq), "n_tiles": math.ceil(N / bk)}
                 for bq, bk in pairs]
        kw = {"candidate_list": _candidate_specs("fa", tiles)}
        return co, _kernel_arch(), kw, pairs

    return _memo_job(("attn", sq, skv, d), build)


def attention_blocks(sq: int, skv: int, d: int) -> Tuple[int, int]:
    """(block_q, block_k) for the FlashAttention kernel via a PlanCache-
    resolved candidates-mode search on the flash-attention compound op;
    the kernel's bf16 tile (128, 128) where it takes no tiling."""
    job = attention_plan_job(sq, skv, d)
    if job is None:
        return (128, 128)
    co, arch, kw, pairs = job
    plan = get_plan_cache().resolve(co, arch, **kw)
    return _pair_of(plan, pairs)


# -------------------------------------------------------- gemm epilogues


def gemm_epilogue_plan_job(m: int, n: int, k: int,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> List[Tuple[CompoundOp, Arch, Dict,
                                           Tuple[ge.Tiling, ...]]]:
    """The plan jobs behind :func:`gemm_epilogue_tiling`: ``(co, arch,
    search_kw, tilings)`` for each cluster size of ``gemm_epilogue.tilings(n,
    dtype)`` (none where the kernel refuses N), the job triple as
    :func:`attention_plan_job`'s.

    A job's compound op is ``gemm_softmax`` over the rows one cluster
    processes, ceil(ceil(m / rows) / floor(132 / CL)) x rows, at the
    dtype's bytes; its arch one cluster of CL SMs (``h100_cluster``); its
    candidates that cluster's tilings as ``fused_dist`` specs with
    ``m_tiles`` row blocks, ``sp_cluster=CL`` and ``collective_gran=
    "stats"`` (the kernel all-reduces each block's per-row partials, once
    a statistic round, never the C tile).  Tilings of one cluster whose
    row blocks give a cluster different rows are jobs of their own."""
    def build():
        e = torch.empty((), dtype=dtype).element_size()
        groups: Dict[Tuple[int, int], List[ge.Tiling]] = {}
        for t in ge.tilings(n, dtype):
            rows_cl = -(-(-(-m // t.rows)) // (fa.SMS // t.cluster)) \
                * t.rows
            groups.setdefault((t.cluster, rows_cl), []).append(t)
        jobs = []
        for (cl, rows_cl), group in sorted(groups.items()):
            tiles = [{"m_tiles": rows_cl // t.rows} for t in group]
            kw = {"candidate_list": _candidate_specs(
                "fused_dist", tiles, sp_cluster=cl,
                collective_gran="stats")}
            jobs.append((gemm_softmax(rows_cl, n, k, dtype_bytes=e),
                         _cluster_arch(cl), kw, tuple(group)))
        return jobs

    return _memo_job(("gemm", m, n, k, dtype), build)


def gemm_epilogue_tiling(m: int, n: int, k: int,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Optional[ge.Tiling]:
    """The fused GEMM-Softmax/-LayerNorm/-RMSNorm kernel's tiling at (m, n,
    k) in ``dtype``: each job of :func:`gemm_epilogue_plan_job` resolves
    through the PlanCache (a candidates-mode search: a tiling that fits
    the cluster's memory first, then the least latency), and across the
    jobs the same order picks the winner, a fitting plan before one that
    overflows, then the least modelled latency (the first job on a tie).
    None where the kernel takes no tiling."""
    cache = get_plan_cache()
    best = None
    for co, arch, kw, ts in gemm_epilogue_plan_job(m, n, k, dtype):
        plan = cache.resolve(co, arch, **kw)
        key = (plan.headroom < 0, plan.latency_s)
        if best is None or key < best[0]:
            best = (key, _pair_of(plan, ts))
    return None if best is None else best[1]


def gemm_epilogue_blocks(m: int, n: int, k: int) -> Tuple[int, int]:
    """(block_m, block_n) for the fused GEMM-Softmax/-LayerNorm/-RMSNorm
    kernel: the rows and slice columns of :func:`gemm_epilogue_tiling`'s
    bf16 tiling; (128, 256) where the kernel takes no tiling."""
    t = gemm_epilogue_tiling(m, n, k)
    return (128, 256) if t is None else (t.rows, t.columns)


# ------------------------------------------------------------------ ssd


def _ssd_chunk_cands(s: int, p: int, n: int) -> List[int]:
    """The chunks of :data:`SSD_CHUNKS` the kernel takes for a scan of S
    rows at head dim P and state dim N (none if it refuses P or N); a
    chunk longer than S only where it is the smallest (the wrapper clips
    the chunk to S)."""
    try:
        ssd.tiling(1, 1, max(s, 1), p, n, torch.bfloat16)
    except ValueError:
        return []
    return [c for c in SSD_CHUNKS if c <= max(s, SSD_CHUNKS[0])]


def ssd_plan_jobs(s: int, p: int, n: int
                  ) -> List[Tuple[CompoundOp, Arch, Dict, int]]:
    """One plan job per candidate chunk (the chunk changes the compound
    op's dimensions themselves, so this is a sweep of per-chunk workloads
    rather than a tiling grid)."""
    def build():
        return [(ssd_chunk(S=s, H=1, P=p, Dst=n, C=c), _kernel_arch(),
                 {"candidate_list": (MappingSpec(variant="fused_dist",
                                                 m_tiles=1),)}, c)
                for c in _ssd_chunk_cands(s, p, n)]

    return _memo_job(("ssd", s, p, n), build)


def ssd_chunk_len(s: int, p: int, n: int) -> int:
    """Chunk for the SSD kernel via the COMET ssd_chunk compound op: the
    candidate whose modelled scan, ceil(S / chunk) x the chunk's plan
    latency, is shortest; the kernel's 64 where it takes none.

    Larger chunks amortize the state GEMMs but grow the (c, c) intra-chunk
    matrix quadratically; the shared cost model finds the knee.  The
    candidate workloads fan through ``PlanCache.warmup`` as one batched
    sweep; per-chunk plans persist, so warm processes answer from the
    store."""
    jobs = ssd_plan_jobs(s, p, n)
    if not jobs:
        return ssd.CHUNK
    cache = get_plan_cache()
    cache.warmup([(co, arch, kw) for co, arch, kw, _c in jobs])
    best = None
    for co, arch, kw, c in jobs:
        plan = cache.resolve(co, arch, **kw)
        lat = math.ceil(max(s, 1) / c) * plan.latency_s
        if best is None or lat < best[0]:
            best = (lat, c)
    return best[1]


# --------------------------------------------------------------- warmup


def plan_jobs(shapes: Optional[Dict[str, Sequence[Tuple[int, ...]]]] = None
              ) -> List[Tuple[CompoundOp, Arch, Dict]]:
    """All plan jobs for a kernel-shape table (default:
    :data:`PAPER_KERNEL_SHAPES`): feed to ``PlanCache.warmup`` to pre-solve
    every selection those shapes will ask for."""
    shapes = shapes if shapes is not None else PAPER_KERNEL_SHAPES
    jobs: List[Tuple[CompoundOp, Arch, Dict]] = []
    for sq, skv, d in shapes.get("attention_blocks", ()):
        job = attention_plan_job(sq, skv, d)
        if job is not None:
            jobs.append(job[:3])
    for m, n, k in shapes.get("gemm_epilogue_blocks", ()):
        jobs.extend(job[:3] for job in gemm_epilogue_plan_job(m, n, k))
    for s, p, n in shapes.get("ssd_chunk_len", ()):
        jobs.extend(job[:3] for job in ssd_plan_jobs(s, p, n))
    return jobs
