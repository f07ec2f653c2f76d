"""COMET-driven tile selection for the port's Hopper kernels (the
kernel-level use of the paper's cost model).

Port of ``repro/kernels/autotune.py``.  For each kernel this builds the
matching compound-op workload, takes the card as one node
(:func:`~repro_torch.core.hardware.h100`), and ranks the candidate tilings
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
* The fused GEMM epilogues: ``gemm_epilogue.tiling(N, bf16)`` is one
  tiling an N (rows of a block, the columns of a CTA's slice, the
  cluster that shares the block); one candidate.
* The SSD chunk scan: the chunks the kernel takes, at most its 64
  (``ssd.CHUNK``): 16, 32 and 64, each a workload of its own.

Each rule stays where it is (``flash_attention.tiling``,
``gemm_epilogue.tiling``, ``ssd.tiling``); a shape a kernel refuses has no
candidate, and its entry point returns the default below.  The wrappers
do not read these plans: only the SSD chunk reaches a kernel, through the
model (``models/ssm.py``).

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

from ..core.hardware import Arch, h100
from ..core.ir import MappingSpec
from ..core.plan import get_plan_cache
from ..core.workload import (CompoundOp, flash_attention, gemm_softmax,
                             ssd_chunk)
from . import flash_attention as fa
from . import gemm_epilogue as ge
from . import ssd

__all__ = ["attention_blocks", "gemm_epilogue_blocks", "ssd_chunk_len",
           "PAPER_KERNEL_SHAPES", "plan_jobs", "attention_plan_job",
           "gemm_epilogue_plan_job", "ssd_plan_jobs", "SSD_CHUNKS"]

SCHEDULES = ("sequential", "pipelined")

# Compute-collective overlap axis for kernel candidates.  On the one-node
# kernel arch collectives cost zero, so the axis is inert (ties break to
# overlap=0.0, the serial point), as in the JAX package.
OVERLAPS = (0.0, 1.0)

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


def _candidate_specs(variant: str, tiles: Sequence[Dict[str, int]]
                     ) -> Tuple[MappingSpec, ...]:
    """Candidate MappingSpecs in (schedule, overlap)-major order, tilings
    minor.  A tuple: immutable sequences are what the plan layer's
    fingerprint memo may cache by identity."""
    return tuple(MappingSpec(variant=variant, schedule=s, overlap=ov, **t)
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


def _gemm_pairs(n: int) -> List[Tuple[int, int, int]]:
    """(block_m, block_n, cluster) of the bf16 kernel: the rows of C a
    block holds, the columns of a CTA's slice and the CTAs that share the
    row block; none where the kernel refuses N."""
    try:
        t = ge.tiling(n, torch.bfloat16)
    except ValueError:
        return []
    return [(t.rows, t.columns, t.cluster)]


def gemm_epilogue_plan_job(m: int, n: int, k: int
                           ) -> Optional[Tuple[CompoundOp, Arch, Dict,
                                               List[Tuple[int, int]]]]:
    """The plan job behind :func:`gemm_epilogue_blocks` (see
    :func:`attention_plan_job`); its pairs are (block_m, block_n)."""
    def build():
        tiles3 = _gemm_pairs(n)
        if not tiles3:
            return None
        co = gemm_softmax(m, n, k)
        tiles = [{"m_tiles": math.ceil(m / bm), "sp_cluster": cl}
                 for bm, _bn, cl in tiles3]
        kw = {"candidate_list": _candidate_specs("fused_dist", tiles)}
        return co, _kernel_arch(), kw, [(bm, bn) for bm, bn, _ in tiles3]

    return _memo_job(("gemm", m, n, k), build)


def gemm_epilogue_blocks(m: int, n: int, k: int) -> Tuple[int, int]:
    """(block_m, block_n) for the fused GEMM-Softmax/-LayerNorm/-RMSNorm
    kernel via a PlanCache-resolved candidates-mode search on
    gemm_softmax; (128, 256) where the kernel takes no tiling."""
    job = gemm_epilogue_plan_job(m, n, k)
    if job is None:
        return (128, 256)
    co, arch, kw, pairs = job
    plan = get_plan_cache().resolve(co, arch, **kw)
    return _pair_of(plan, pairs)


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
        job = gemm_epilogue_plan_job(m, n, k)
        if job is not None:
            jobs.append(job[:3])
    for s, p, n in shapes.get("ssd_chunk_len", ()):
        jobs.extend(job[:3] for job in ssd_plan_jobs(s, p, n))
    return jobs
