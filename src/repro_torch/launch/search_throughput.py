"""Map-space evaluation throughput and the port's integration gates.

The port's counterpart of the reference package's search-throughput bench
(its ``search_throughput.py``): the same nine sections, the same names,
gate constants and JSON schema (``comet/search_throughput/v9``), over the
port's own copies of everything it drives.

* ``spaces`` — mappings/sec of the **per-spec tree path** (``build_tree``
  -> ``validate_tree`` -> recursive ``CostModel.evaluate`` per sampled
  spec) against the **batched engine** (``core/batcheval.py``), on the
  paper's gemm_softmax and attention spaces, on the legacy axes (spatial
  fanouts pinned to the arch maximum) and the full divisor-complete grid,
  plus a non-pow2 space where the divisor fanout axes widen the grid.  The
  batched engine must be ``SPEEDUP_FLOOR`` x faster.
* ``exhaustive_vs_randomized`` — on every (workload, arch) pair of
  ``paper_tables``: exhaustive <= randomized, divisor-complete <=
  pow2-only, and both Pareto fronts contain the latency optimum.
* ``provisioning`` — the 3-D latency/energy/headroom fronts on the non-pow2
  showcase GEMMs.
* ``executors`` — the 48-pair sweep through ``search_many`` with
  ``executor='serial' | 'thread' | 'process'``: process >= thread
  jobs/sec, every best mapping bit-identical, no shared-memory segment
  left over.  The port's pools start with ``forkserver``/``spawn``
  (``core/search.py::_mp_context``), the server importing the workers'
  module once; a sweep that fell back from processes to threads (the
  ``RuntimeWarning`` of ``search_many``) fails the section.
* ``autotune`` — cold solve, warm lookup (``WARM_SPEEDUP_FLOOR`` x faster)
  and disk lookup of the three kernel plan entries on a fresh plan store.
  The port plans on ``h100()``, so the values are the port's own.
* ``chunking`` — size-aware against contiguous ``search_many`` chunks on a
  cost-skewed sweep: the huge job in the first chunk, results
  bit-identical, jobs/sec >= ``CHUNKING_TOLERANCE`` x contiguous.
* ``analysis`` — the kernel and sharded contract arms at the smoke shapes
  and the lint, clean; ``analysis.train``: the train arm on a fake (2, 4)
  world, and ``reconcile_cell`` over that arm's recorded glm4-9b run (the
  port compiles no HLO, so a recorded run takes the golden fixture's
  place): the All-Reduce bulk must ``match`` with no
  ``reconcile-mismatch``.
* ``calibration`` — synthetic recovery, ``costmodel_compare``'s
  collective comparison, and ``python -m repro_torch.calibrate --backend
  gloo`` run twice against a temporary store: the gate met, the second
  run reused with no fit, the file byte for byte the same, nothing else
  in the store.
* ``overlap`` — the 48-pair sweep with the overlap axis off, ``[0.0]``
  (bit-identical) and full (never worse), the strict-improvement
  showcases, and ``repro_torch.launch.overlap_bench`` in a subprocess on
  ``--device``: on the card it launches the CUDA streamed GEMM
  (``csrc/streamed_gemm.cu``), with ``HIDDEN_FRACTION_FLOOR`` applied
  where its group has two CUDA ranks or more (one rank is degenerate and
  recorded as such); on the CPU its plain version runs on gloo.

No section skips and passes: a failure inside a section fails it.  The
timing floors are host-side search throughput, not device speed.

    PYTHONPATH=src python -m repro_torch.launch.search_throughput \\
        [--device cuda|cpu] [--out bench_out/search_throughput_torch.json]

``--device`` is ``cuda`` unless it says ``cpu`` (``resolve_device``: no
Hopper card, no run).  Prints ``name,us_per_call,derived`` CSV rows,
writes the JSON (with ``device``: the card's name and power limit as
``nvidia-smi`` gives them, or ``cpu``) and exits 0 if every gate holds,
else 1.  It never writes the reference bench's ``BENCH_search.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.core import batcheval
from repro_torch.core.batcheval import enumerate_topologies, \
    evaluate_topology_grid
from repro_torch.core.hardware import cloud, edge
from repro_torch.core.ir import evaluate_mapping
from repro_torch.core.search import (_sample, candidate_specs, search,
                                     search_many)
from repro_torch.core.workload import attention, flash_attention, \
    gemm_softmax

SCHEMA = "comet/search_throughput/v9"
DEFAULT_OUT = os.path.join("bench_out", "search_throughput_torch.json")
# the reference bench's own record, which this bench never writes
REFERENCE_RECORD = "BENCH_search.json"
SRC = str(Path(__file__).resolve().parents[2])

SPEEDUP_FLOOR = 20.0
TREE_SAMPLE = 300          # specs timed through the per-spec path
MIN_TREE_SECONDS = 0.25    # keep timing noise down on fast machines
REL_EPS = 1e-12            # tolerance for the <= latency gates

# a search_many warning that says a process sweep ran on threads or
# serially: a "process" time measured so is no process time
FALLBACK_PREFIXES = ("search_many:", "parallel_map:")


def _tree_throughput(co, arch, cands, repeats: int = 3) -> Dict:
    """mappings/sec of the per-spec build->validate->evaluate path (best
    of ``repeats`` timed passes)."""
    best = None
    for _ in range(repeats):
        rng = random.Random(0)
        done = 0
        t0 = time.perf_counter()
        while done < TREE_SAMPLE or time.perf_counter() - t0 < MIN_TREE_SECONDS:
            spec = _sample(rng, cands)
            try:
                evaluate_mapping(co, arch, spec)
            except (ValueError, KeyError):
                continue
            done += 1
        dt = time.perf_counter() - t0
        if best is None or done / dt > best["mappings_per_sec"]:
            best = {"mappings": done, "seconds": dt,
                    "mappings_per_sec": done / dt}
    return best


def _batch_throughput(co, arch, cands, repeats: int = 3) -> Dict:
    """mappings/sec of the batched engine over the full enumerable space.
    Cold (caches cleared before each pass) is reported as the best of
    ``repeats`` passes to damp scheduler noise; a warm (cached) pass is
    reported separately."""
    topos = enumerate_topologies(co, cands)

    def one_pass() -> Dict:
        t0 = time.perf_counter()
        n = 0
        best = float("inf")
        for topo in topos:
            br = evaluate_topology_grid(co, arch, topo, cands)
            n += br.size
            i = br.best_index("latency")
            if i is not None:
                best = min(best, float(br.latency[i]))
        dt = time.perf_counter() - t0
        return {"mappings": n, "seconds": dt, "mappings_per_sec": n / dt,
                "best_latency_s": best}

    cold = None
    for _ in range(repeats):
        batcheval.cache_clear()
        p = one_pass()
        if cold is None or p["seconds"] < cold["seconds"]:
            cold = p
    warm = one_pass()
    return {"cold": cold, "warm": warm, "topologies": len(topos)}


def measure_space(name: str, co, arch, axes: str = "full") -> Dict:
    """``axes='legacy'`` pins the spatial fanouts to the arch maximum
    (sp_cluster = sp_core = 0): its mappings/sec is the no-regression
    reference; ``'full'`` measures the divisor-complete grid."""
    cands = candidate_specs(co, arch)
    if axes == "legacy":
        cands = dict(cands, sp_cluster=[0], sp_core=[0])
    tree = _tree_throughput(co, arch, cands)
    batch = _batch_throughput(co, arch, cands)
    speedup = batch["cold"]["mappings_per_sec"] / tree["mappings_per_sec"]
    print(f"search_throughput_{name}_{axes},"
          f"{1e6 / batch['cold']['mappings_per_sec']:.2f},"
          f"tree={tree['mappings_per_sec']:.0f}/s;"
          f"batch={batch['cold']['mappings_per_sec']:.0f}/s;"
          f"speedup={speedup:.1f}x;"
          f"space={batch['cold']['mappings']}specs")
    return {"workload": name, "arch": arch.name, "axes": axes, "tree": tree,
            "batch": batch, "speedup": speedup}


def spaces() -> List[Dict]:
    """The five spaces of ``run_all``."""
    from repro_torch.launch.paper_tables import PROVISIONING_GEMMS

    return [
        measure_space("gemm_softmax", gemm_softmax(512, 1024, 128), edge(),
                      axes="legacy"),
        measure_space("attention", attention(1024, 256, 1024, 256), edge(),
                      axes="legacy"),
        measure_space("gemm_softmax", gemm_softmax(512, 1024, 128), edge(),
                      axes="full"),
        measure_space("attention", attention(1024, 256, 1024, 256), edge(),
                      axes="full"),
        # divisor-complete showcase: non-pow2 dims widen the fanout axes
        measure_space("gemm_softmax_np2",
                      gemm_softmax(*PROVISIONING_GEMMS[0]), edge(),
                      axes="full"),
    ]


def _paper_pairs() -> List:
    from repro_torch.core.workload import gemm_layernorm
    from repro_torch.launch.paper_tables import (ATTN_CLOUD, ATTN_EDGE,
                                                 GEMMS_CLOUD, GEMMS_EDGE)

    rows = []
    for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud())):
        for M, N, K in shapes:
            for fn in (gemm_softmax, gemm_layernorm):
                rows.append((fn.__name__, fn(M, N, K), arch))
    for shapes, arch in ((ATTN_EDGE, edge()), (ATTN_CLOUD, cloud())):
        for M, K, N, L in shapes:
            rows.append(("attention", attention(M, K, N, L), arch))
            rows.append(("flash_attention", flash_attention(M, K, N, L), arch))
    return rows


def search_invariants() -> List[Dict]:
    """Every (workload, arch) pair of paper_tables: exhaustive search must
    return latency <= the randomized search result, the Pareto fronts (2-D
    and 3-D) must hold the scalar-latency optimum, and the
    divisor-complete axes must never lose to the pow2-only axes they
    contain.  The 5-searches-per-pair matrix fans out through
    ``search_many`` in pair-major order."""
    from repro_torch.launch.paper_tables import BUDGET, SEARCH_KW

    pairs = _paper_pairs()
    per_pair = [
        dict(SEARCH_KW, mode="exhaustive"),
        {"mode": "exhaustive", "fanouts": "pow2"},
        {"mode": "randomized", "budget": BUDGET, "seed": 1},
        dict(SEARCH_KW, mode="exhaustive", objective="pareto"),
        dict(SEARCH_KW, mode="exhaustive", objective="pareto3"),
    ]
    jobs = [(co, arch, kw)
            for _name, co, arch in pairs
            for kw in per_pair]
    results = iter(search_many(jobs))
    out = []
    for name, co, arch in pairs:
        ex, ex_pow2, rd, pf, pf3 = (next(results) for _ in range(5))
        out.append({
            "workload": name,
            "dims": dict(co.dim_sizes),
            "arch": arch.name,
            "exhaustive_latency_s": ex.latency,
            "pow2_latency_s": ex_pow2.latency,
            "randomized_latency_s": rd.latency,
            "pareto_front_size": len(pf.front),
            "pareto_best_latency_s": pf.front[0][0],
            "pareto3_front_size": len(pf3.front),
            "pareto3_best_latency_s": pf3.front[0][0],
            "pareto3_max_headroom": max(p[2] for p in pf3.front),
            "ok": (ex.latency <= rd.latency * (1 + REL_EPS)
                   and ex.latency <= ex_pow2.latency * (1 + REL_EPS)
                   and pf.front[0][0] <= ex.latency * (1 + REL_EPS)
                   and pf3.front[0][0] <= ex.latency * (1 + REL_EPS)),
        })
    bad = [r for r in out if not r["ok"]]
    print(f"search_invariants,0,pairs={len(out)};regressions={len(bad)}")
    return out


def provisioning_study() -> Dict:
    """3-D latency/energy/capacity-headroom fronts on the non-pow2
    showcase shapes of ``paper_tables.PROVISIONING_GEMMS``: front sizes,
    the headroom span and the divisor-vs-pow2 gate on each (shape,
    arch)."""
    from repro_torch.launch.paper_tables import PROVISIONING_GEMMS, SEARCH_KW

    rows = []
    for i, shape in enumerate(PROVISIONING_GEMMS):
        name = f"gemm_softmax_np2_{i}"
        for arch in (edge(), cloud()):
            co = gemm_softmax(*shape)
            ex = search(co, arch, mode="exhaustive", **SEARCH_KW)
            ex_pow2 = search(co, arch, mode="exhaustive", fanouts="pow2")
            pf3 = search(co, arch, mode="exhaustive", objective="pareto3",
                         **SEARCH_KW)
            hr = [p[2] for p in pf3.front]
            row = {
                "workload": name,
                "dims": dict(co.dim_sizes),
                "arch": arch.name,
                "exhaustive_latency_s": ex.latency,
                "pow2_latency_s": ex_pow2.latency,
                "front3_size": len(pf3.front),
                "best_latency_s": pf3.front[0][0],
                "headroom_min": min(hr),
                "headroom_max": max(hr),
                "ok": (ex.latency <= ex_pow2.latency * (1 + REL_EPS)
                       and pf3.front[0][0] <= ex.latency * (1 + REL_EPS)),
            }
            rows.append(row)
            print(f"provisioning_{name}_{arch.name},"
                  f"{row['best_latency_s']*1e6:.2f},"
                  f"front3={row['front3_size']};"
                  f"headroom={row['headroom_min']:.3f}"
                  f"..{row['headroom_max']:.3f};"
                  f"div_vs_pow2={row['exhaustive_latency_s']/row['pow2_latency_s']:.3f}")
    ok = all(r["ok"] for r in rows)
    print(f"provisioning_ok,0,{ok};rows={len(rows)}")
    return {"pairs": rows, "ok": ok}


def _same_result(a, b) -> bool:
    return (a.latency == b.latency and a.energy_pj == b.energy_pj
            and a.best.spec == b.best.spec and a.evaluated == b.evaluated)


def _swept(fallbacks: List[str], fn: Callable[[], List]):
    """(results, seconds) of ``fn()``; the messages of every warning by
    which ``search_many`` said it left its executor go to ``fallbacks``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        t0 = time.perf_counter()
        rs = fn()
        dt = time.perf_counter() - t0
    fallbacks.extend(str(w.message) for w in caught
                     if str(w.message).startswith(FALLBACK_PREFIXES))
    return rs, dt


def _shm_names() -> Optional[set]:
    shm_dir = "/dev/shm"
    return set(os.listdir(shm_dir)) if os.path.isdir(shm_dir) else None


def _leaked(before: Optional[set]) -> List[str]:
    """Shared-memory segments of a sweep (``batch_to_shm``'s ``cm``
    prefix) made since ``before``."""
    if before is None:
        return []
    return sorted(n for n in _shm_names() - before if n.startswith("cm"))


def executor_sweep(repeats: int = 2) -> Dict:
    """The full 48-pair paper-table sweep (``divisor_tilings=True``)
    through each ``search_many`` executor.

    * ``process`` jobs/sec must be >= ``thread`` jobs/sec (``serial`` is
      reported for context).
    * The best mapping of every pair must be **bit-identical** across
      serial/thread/process (spec, latency, energy, evaluated count).
    * No shared-memory segment may survive the sweep.
    * The process sweeps must run on processes: a fallback to threads
      (``search_many``'s ``RuntimeWarning``) fails the section.
    """
    from repro_torch.launch.paper_tables import SEARCH_KW

    jobs = [(co, arch, dict(SEARCH_KW)) for _n, co, arch in _paper_pairs()]
    before = _shm_names()
    times: Dict[str, float] = {}
    results: Dict[str, List] = {}
    fallbacks: List[str] = []
    for ex in ("serial", "thread", "process"):
        for _ in range(repeats):
            batcheval.cache_clear()
            rs, dt = _swept(fallbacks,
                            lambda ex=ex: search_many(jobs, executor=ex))
            if ex not in times or dt < times[ex]:
                times[ex] = dt
                results[ex] = rs
    leaked = _leaked(before)
    mismatched = [i for i, (rs, rt, rp) in enumerate(zip(
        results["serial"], results["thread"], results["process"]))
        if not (_same_result(rs, rt) and _same_result(rs, rp))]
    jps = {ex: len(jobs) / t for ex, t in times.items()}
    ok = (jps["process"] >= jps["thread"] and not mismatched and not leaked
          and not fallbacks)
    for ex in ("serial", "thread", "process"):
        print(f"executor_sweep_{ex},{times[ex]*1e6/len(jobs):.0f},"
              f"jobs_per_sec={jps[ex]:.1f}")
    print(f"executor_sweep_ok,0,{ok};process_vs_thread="
          f"{jps['process']/jps['thread']:.2f}x;"
          f"bit_identical={not mismatched};leaked={len(leaked)};"
          f"fallbacks={len(fallbacks)}")
    return {
        "pairs": len(jobs),
        "seconds": times,
        "jobs_per_sec": jps,
        "process_vs_thread": jps["process"] / jps["thread"],
        "bit_identical": not mismatched,
        "mismatched_jobs": mismatched,
        "leaked_segments": leaked,
        "fallbacks": fallbacks,
        "ok": ok,
    }


WARM_SPEEDUP_FLOOR = 100.0     # plan-cache warm lookup vs cold solve
# Timing gates on shared runners need slack; a real regression (the huge
# job serializing behind a chunk of tiny ones) costs ~40%+.
CHUNKING_TOLERANCE = 0.95


def autotune_bench() -> Dict:
    """Cold-solve vs warm-lookup latency per kernel entry point through
    the PlanCache, on a fresh temporary store.  Warm must be >=
    ``WARM_SPEEDUP_FLOOR`` x faster; with the in-memory layer dropped (a
    simulated second process) the call must answer from disk."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import autotune

    calls = {
        "attention_blocks":
            lambda: autotune.attention_blocks(4096, 4096, 128),
        "gemm_epilogue_blocks":
            lambda: autotune.gemm_epilogue_blocks(4096, 4096, 4096),
        "ssd_chunk_len":
            lambda: autotune.ssd_chunk_len(4096, 64, 128),
    }
    entries = {}
    old = os.environ.get("REPRO_PLAN_CACHE")
    with tempfile.TemporaryDirectory(prefix="repro-plans-bench-") as tmp:
        os.environ["REPRO_PLAN_CACHE"] = tmp
        try:
            for name, fn in calls.items():
                t0 = time.perf_counter()
                value = fn()
                cold = time.perf_counter() - t0
                warm = min(_timed(fn) for _ in range(5))
                # drop the in-memory layer so the next call goes to the
                # store: a simulated second process over a warm disk
                with plan_mod._CACHES_LOCK:
                    plan_mod._CACHES.clear()
                disk = _timed(fn)
                speedup = cold / max(warm, 1e-9)
                entries[name] = {
                    "value": list(value) if isinstance(value, tuple)
                    else value,
                    "cold_solve_s": cold,
                    "warm_lookup_s": warm,
                    "disk_lookup_s": disk,
                    "warm_speedup": speedup,
                    "ok": speedup >= WARM_SPEEDUP_FLOOR,
                }
                print(f"autotune_{name},{warm * 1e6:.1f},"
                      f"cold={cold * 1e3:.1f}ms;warm={warm * 1e6:.1f}us;"
                      f"speedup={speedup:.0f}x;value={entries[name]['value']}")
        finally:
            if old is None:
                os.environ.pop("REPRO_PLAN_CACHE", None)
            else:
                os.environ["REPRO_PLAN_CACHE"] = old
    ok = all(e["ok"] for e in entries.values())
    print(f"autotune_ok,0,{ok};floor={WARM_SPEEDUP_FLOOR:.0f}x")
    return {"entries": entries, "warm_speedup_floor": WARM_SPEEDUP_FLOOR,
            "ok": ok}


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def chunking_jobs() -> List:
    """Every tiny edge/cloud paper GEMM cell first, the ~117k-point
    non-pow2 provisioning GEMM on cloud **last** (the contiguous worst
    case)."""
    from repro_torch.core.workload import gemm_layernorm
    from repro_torch.launch.paper_tables import (GEMMS_CLOUD, GEMMS_EDGE,
                                                 PROVISIONING_GEMMS,
                                                 SEARCH_KW)

    tiny = [(fn(M, N, K), arch, dict(SEARCH_KW))
            for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud()))
            for M, N, K in shapes
            for fn in (gemm_softmax, gemm_layernorm)]
    huge = (gemm_softmax(*PROVISIONING_GEMMS[1]), cloud(), dict(SEARCH_KW))
    return tiny + [huge]


CHUNKSIZE = 4


def chunk_placement(jobs: List) -> Dict:
    """Where ``_make_chunks`` deals the last (huge) job of ``jobs``: in
    the first size-aware chunk, and in the last contiguous one."""
    from repro_torch.core.search import _make_chunks, _norm_job

    norm = [_norm_job(j) for j in jobs]
    by_size = _make_chunks(norm, CHUNKSIZE, "size")
    by_slice = _make_chunks(norm, CHUNKSIZE, "contiguous")
    huge_idx = len(jobs) - 1
    return {"huge_first": any(i == huge_idx for i, _j in by_size[0]),
            "huge_last_contig": any(i == huge_idx for i, _j in by_slice[-1]),
            "size_chunks": [[i for i, _j in c] for c in by_size],
            "contiguous_chunks": [[i for i, _j in c] for c in by_slice]}


def chunking_bench(repeats: int = 10) -> Dict:
    """Size-aware vs contiguous ``search_many`` chunk assignment on the
    cost-skewed sweep of :func:`chunking_jobs`.  Gates: the size-aware
    scheduler places the huge job in the first chunk (deterministic),
    results are bit-identical across modes, size-aware jobs/sec is not
    below ``CHUNKING_TOLERANCE`` x contiguous, and both ran on
    processes.  Each sweep starts a pool of its own, about half the
    sweep's time, and where every chunk has a worker of its own the two
    modes differ by little more than that start's noise; so the modes are
    timed in turns and each keeps its best of ``repeats``."""
    jobs = chunking_jobs()
    place = chunk_placement(jobs)
    huge_first = place["huge_first"]
    huge_last_contig = place["huge_last_contig"]

    times: Dict[str, float] = {}
    results: Dict[str, List] = {}
    fallbacks: List[str] = []
    for _ in range(repeats):
        for mode in ("contiguous", "size"):
            batcheval.cache_clear()
            rs, dt = _swept(fallbacks, lambda mode=mode: search_many(
                jobs, executor="process", chunksize=CHUNKSIZE,
                chunking=mode))
            if mode not in times or dt < times[mode]:
                times[mode] = dt
                results[mode] = rs
    identical = all(_same_result(a, b) for a, b in
                    zip(results["size"], results["contiguous"]))
    jps = {m: len(jobs) / t for m, t in times.items()}
    ratio = jps["size"] / jps["contiguous"]
    ok = (huge_first and huge_last_contig and identical
          and ratio >= CHUNKING_TOLERANCE and not fallbacks)
    for m in ("contiguous", "size"):
        print(f"chunking_{m},{times[m] * 1e6 / len(jobs):.0f},"
              f"jobs_per_sec={jps[m]:.2f}")
    print(f"chunking_ok,0,{ok};size_vs_contiguous={ratio:.2f}x;"
          f"huge_first={huge_first};bit_identical={identical};"
          f"fallbacks={len(fallbacks)}")
    return {
        "jobs": len(jobs),
        "chunksize": CHUNKSIZE,
        "seconds": times,
        "jobs_per_sec": jps,
        "size_vs_contiguous": ratio,
        "tolerance": CHUNKING_TOLERANCE,
        "huge_job_in_first_chunk": huge_first,
        "huge_job_in_last_contiguous_chunk": huge_last_contig,
        "bit_identical": identical,
        "fallbacks": fallbacks,
        "ok": ok,
    }


# one small shape a kernel family (the analysis CLI's --smoke)
SMOKE_SHAPES = {"gemm_epilogue_blocks": [(512, 4096, 128)],
                "attention_blocks": [(1024, 1024, 64)],
                "ssd_chunk_len": [(4096, 64, 128)]}
# the train arm's fake world and batch, and the run reconciled on it
TRAIN_WORLD = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 16
RECONCILE_ARCH = "glm4-9b"


def analysis_gates(schedule_fn=None) -> Dict:
    """Smoke-shape kernel and sharded contracts + the lint, timed, and the
    ``train`` section (:func:`train_gates`, whose declaration
    ``schedule_fn`` replaces).  Any failure fails the gate."""
    from repro_torch.analysis.contracts import (kernel_contract_checks,
                                                sharded_contract_checks)
    from repro_torch.analysis.lint import lint_repo

    t0 = time.perf_counter()
    checks = kernel_contract_checks(SMOKE_SHAPES)
    checks += sharded_contract_checks()
    contracts_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    findings = lint_repo()
    lint_s = time.perf_counter() - t0
    failures = [c.to_dict() for c in checks if not c.ok]
    train = train_gates(schedule_fn)
    print(f"analysis_contracts,{contracts_s * 1e6:.0f},checks={len(checks)};"
          f"failures={len(failures)}")
    print(f"analysis_lint,{lint_s * 1e6:.0f},findings={len(findings)}")
    return {
        "contract_checks": len(checks),
        "contract_failures": failures,
        "contracts_s": contracts_s,
        "lint_findings": [f.to_dict() for f in findings],
        "lint_s": lint_s,
        "train": train,
        "ok": not failures and not findings and train["ok"],
    }


def train_gates(schedule_fn=None) -> Dict:
    """The ``analysis.train`` section, timed.

    * ``contracts_ok`` — the train arm (dense glm4 + qwen3 MoE on a fake
      world's (2, 4) mesh) matches the declaration exactly, including the
      MoE no-all-to-all invariant.
    * ``reconcile_ok`` — ``reconcile_cell`` over the arm's recorded
      glm4-9b run and its declaration, each ``grads/*`` entry sized as
      issued (ROADMAP C.6, ``reconcile.size_grads_as_issued``; the
      record lists the labels so sized): the All-Reduce bulk must
      ``match`` and no finding may be a ``reconcile-mismatch``.

    ``schedule_fn`` replaces ``train_collective_schedule`` on both."""
    from repro_torch.analysis.contracts import (default_mesh,
                                                train_contract_checks,
                                                train_trace)
    from repro_torch.analysis.counts import fake_world
    from repro_torch.analysis.reconcile import (reconcile_cell,
                                                size_grads_as_issued)
    from repro_torch.parallel.collective_planner import \
        train_collective_schedule

    schedule_fn = schedule_fn or train_collective_schedule
    with fake_world(TRAIN_WORLD):
        mesh = default_mesh(TRAIN_WORLD)
        t0 = time.perf_counter()
        checks = train_contract_checks(mesh, schedule_fn=schedule_fn,
                                       batch=TRAIN_BATCH, seq=TRAIN_SEQ)
        contracts_s = time.perf_counter() - t0
        contract_failures = [c.to_dict() for c in checks if not c.ok]

        t0 = time.perf_counter()
        cfg, trace = train_trace(RECONCILE_ARCH, mesh, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ)
        sched, c6 = size_grads_as_issued(
            schedule_fn(cfg, mesh, TRAIN_BATCH, TRAIN_SEQ), trace)
        report = reconcile_cell(trace, schedule=sched)
        reconcile_s = time.perf_counter() - t0
    recon = dict(report.to_dict(), arch=RECONCILE_ARCH,
                 mesh="x".join(str(int(s)) for s in mesh.shape),
                 c6_sized=c6)
    ar = report.per_type.get("all-reduce")
    recon_ok = (ar is not None and ar.status == "match"
                and not any(f["kind"] == "reconcile-mismatch"
                            for f in report.findings))
    print(f"analysis_train,{contracts_s * 1e6:.0f},checks={len(checks)};"
          f"failures={len(contract_failures)};reconcile_ok={recon_ok}")
    return {
        "contract_checks": len(checks),
        "contract_failures": contract_failures,
        "contracts_s": contracts_s,
        "reconcile": recon,
        "reconcile_s": reconcile_s,
        "contracts_ok": not contract_failures,
        "reconcile_ok": recon_ok,
        "ok": not contract_failures and recon_ok,
    }


# calibration gates (repro_torch.calibrate)
RECOVERY_TOL_CLEAN = 0.01    # noise-free synthetic: params within 1%
RECOVERY_TOL_JITTER = 0.10   # 3%-jittered synthetic: params within 10%
COLLECTIVE_MEDIAN_GATE = 0.10  # pred-vs-meas median |rel err|, synthetic
CPU_GATE_MEDIAN = 0.6        # real-CPU sweep: fitted model vs own sweep
# gloo ranks of the e2e run (spawned by the CLI), and its time limit
CALIB_RANKS = 4
SUBPROCESS_TIMEOUT = 600


def _env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    return env


def _calibrate_cmd(store: str) -> List[str]:
    return [sys.executable, "-m", "repro_torch.calibrate", "--backend",
            "gloo", "--ranks", str(CALIB_RANKS), "--store", store,
            f"--gate-median={CPU_GATE_MEDIAN}", "--json"]


def _calibrate_e2e() -> Dict:
    """The CLI twice against a temporary store.  Raises where a run
    leaves no summary or no file."""
    with tempfile.TemporaryDirectory(prefix="repro-calib-bench-") as tmp:
        cmd = _calibrate_cmd(tmp)
        store_file = os.path.join(tmp, "calibrated_noc.json")
        runs = []
        for _ in range(2):
            r = subprocess.run(cmd, env=_env(), capture_output=True,
                               text=True, timeout=SUBPROCESS_TIMEOUT)
            try:
                summary = json.loads(r.stdout)
                with open(store_file, "rb") as fh:
                    runs.append((r.returncode, summary, fh.read()))
            except (OSError, ValueError) as e:
                raise RuntimeError(
                    f"{' '.join(cmd)} exited {r.returncode} ({e!r}): "
                    f"{r.stdout[-2000:]} {r.stderr[-2000:]}") from e
        stray = sorted(set(os.listdir(tmp)) - {"calibrated_noc.json"})
    (rc1, s1, bytes1), (rc2, s2, bytes2) = runs
    return {
        "ranks": CALIB_RANKS,
        "returncodes": [rc1, rc2],
        "first": {k: s1[k] for k in
                  ("reused", "fits_solved", "n_points",
                   "median_rel_err", "max_rel_err", "gate_ok")},
        "second": {k: s2[k] for k in ("reused", "fits_solved", "gate_ok")},
        "gate_median": CPU_GATE_MEDIAN,
        "bit_identical": bytes1 == bytes2,
        "stray_files": stray,
        "params": s1["params"],
        "ok": (rc1 == 0 and rc2 == 0
               and s1["gate_ok"] and not s1["reused"]
               and s1["fits_solved"] == 1
               and s2["reused"] and s2["fits_solved"] == 0
               and bytes1 == bytes2 and not stray),
    }


def calibration_gates() -> Dict:
    """The measured-collective calibration loop, gated end to end.

    * ``recovery`` — the fitter inverts a synthetic sweep generated from
      known ``NoCParams``: noise-free within ``RECOVERY_TOL_CLEAN``,
      bounded 3% jitter within ``RECOVERY_TOL_JITTER``.
    * ``collective`` — costmodel_compare's predicted-vs-measured section:
      median |rel err| <= ``COLLECTIVE_MEDIAN_GATE``.
    * ``cpu`` — ``python -m repro_torch.calibrate --backend gloo`` over
      ``CALIB_RANKS`` CPU ranks, in a subprocess, against a temporary
      store: exit 0 with the gate (``CPU_GATE_MEDIAN``) met; a second run
      reports ``reused: true`` / ``fits_solved: 0``, the store byte for
      byte the same and holding nothing but the one file.  A run that
      leaves no summary or no file fails the section.
    """
    from dataclasses import replace as _replace

    from repro_torch.calibrate import (fit_noc_params, run_sweep,
                                       synthetic_measure_fn)
    from repro_torch.core.hardware import tpu_v5e
    from repro_torch.launch.costmodel_compare import collective_compare

    true = _replace(tpu_v5e().cluster_noc, mesh=(1, 8))

    def worst_param_err(jitter: float, seed: int) -> float:
        sweep = run_sweep(synthetic_measure_fn(true, jitter=jitter,
                                               seed=seed), [2, 4, 8])
        fit = fit_noc_params(sweep.points, true)
        p = fit.params
        return max(abs(p.channel_bandwidth - true.channel_bandwidth)
                   / true.channel_bandwidth,
                   abs(p.t_router - true.t_router) / true.t_router,
                   abs(p.t_enq - true.t_enq) / true.t_enq)

    t0 = time.perf_counter()
    clean_err = worst_param_err(0.0, 0)
    jitter_err = worst_param_err(0.03, 3)
    recovery = {
        "clean_worst_rel_err": clean_err,
        "clean_tol": RECOVERY_TOL_CLEAN,
        "jitter_worst_rel_err": jitter_err,
        "jitter_tol": RECOVERY_TOL_JITTER,
        "ok": (clean_err <= RECOVERY_TOL_CLEAN
               and jitter_err <= RECOVERY_TOL_JITTER),
        "seconds": time.perf_counter() - t0,
    }
    print(f"calibration_recovery,0,clean={clean_err:.2e};"
          f"jitter={jitter_err:.3f};ok={recovery['ok']}")

    coll = collective_compare()
    coll["gate"] = COLLECTIVE_MEDIAN_GATE
    coll["ok"] = (not coll["degenerate"]
                  and coll["median_rel_err"] <= COLLECTIVE_MEDIAN_GATE)

    t0 = time.perf_counter()
    try:
        cpu = _calibrate_e2e()
    except (OSError, RuntimeError, ValueError, KeyError,
            subprocess.TimeoutExpired) as e:
        cpu = {"error": repr(e), "ok": False}
    cpu["seconds"] = time.perf_counter() - t0
    if "error" in cpu:
        print(f"calibration_cpu,0,error={cpu['error'][:200]};ok=False")
    else:
        print(f"calibration_cpu,0,median={cpu['first']['median_rel_err']:.3f}"
              f"(gate<={CPU_GATE_MEDIAN});reuse_bit_identical="
              f"{cpu['bit_identical']};stray={len(cpu['stray_files'])};"
              f"ok={cpu['ok']}")

    ok = recovery["ok"] and coll["ok"] and cpu["ok"]
    print(f"calibration_ok,0,{ok}")
    return {"recovery": recovery, "collective": coll, "cpu": cpu, "ok": ok}


# overlap gates (compute-collective overlap axis)
OVERLAP_STRICT_EPS = 1e-6          # margin for the strict-improvement gates
OVERLAP_RECOVERY_TOL_CLEAN = 0.01  # fit_overlap on a noise-free sweep
OVERLAP_RECOVERY_TOL_JITTER = 0.10  # ... on a 5%-jittered sweep
KERNEL_AGREEMENT_TOL = 1e-3        # streamed GEMM buffers=2 vs buffers=1
# the measured hidden fraction's floor: applied where the overlap bench's
# group has two CUDA ranks or more (one rank gathers nothing)
HIDDEN_FRACTION_FLOOR = 0.25


def _hbm_rich_cloud():
    """Cloud with the DRAM stream off the critical path (bandwidth x64).

    On the stock cloud balance every winning paper-pair mapping is
    DRAM-floor-bound and Eq. 2 already hides the whole window under the
    memory stream, so the overlap axis cannot move the optimum (the
    ``pairs`` sub-gate pins exactly that).  The strict-improvement
    showcase therefore runs where the on-chip window binds."""
    import dataclasses

    base = cloud()
    return dataclasses.replace(
        base, name="cloud_hbm",
        dram=dataclasses.replace(base.dram,
                                 bandwidth=base.dram.bandwidth * 64))


def overlap_pairs() -> Dict:
    """The 48-pair sweep: overlap axis off, ``[0.0]`` (bit-identical) and
    ``OVERLAP_CANDIDATES`` (never worse)."""
    from repro_torch.core.search import OVERLAP_CANDIDATES
    from repro_torch.launch.paper_tables import SEARCH_KW

    t0 = time.perf_counter()
    pairs = _paper_pairs()
    base = search_many([(co, a, dict(SEARCH_KW)) for _n, co, a in pairs])
    zero = search_many([(co, a, dict(SEARCH_KW, overlap=[0.0]))
                        for _n, co, a in pairs])
    full = search_many(
        [(co, a, dict(SEARCH_KW, overlap=list(OVERLAP_CANDIDATES)))
         for _n, co, a in pairs])
    not_identical = [i for i, (b, z) in enumerate(zip(base, zero))
                     if not (b.latency == z.latency
                             and b.energy_pj == z.energy_pj
                             and b.best.spec == z.best.spec)]
    worse = [i for i, (b, f) in enumerate(zip(base, full))
             if f.latency > b.latency * (1 + REL_EPS)]
    improved = sum(1 for b, f in zip(base, full)
                   if f.latency < b.latency * (1 - OVERLAP_STRICT_EPS))
    sec = {
        "pairs": len(pairs),
        "serial_identity_bitwise": not not_identical,
        "not_identical_pairs": not_identical,
        "worse_pairs": worse,
        "strictly_improved_pairs": improved,
        "seconds": time.perf_counter() - t0,
        "ok": not not_identical and not worse,
    }
    print(f"overlap_pairs,0,bitwise={sec['serial_identity_bitwise']};"
          f"worse={len(worse)};improved={improved}/{len(pairs)}")
    return sec


def overlap_gemm_softmax_cloud() -> Dict:
    """The strict-improvement showcase on the window-bound HBM-rich
    cloud: the distSM mapping strictly cheaper per mapping on both
    schedules, and a sequential-issue candidates-mode search strictly
    better with the axis on."""
    import dataclasses as _dc

    from repro_torch.core.ir import MappingSpec

    t0 = time.perf_counter()
    fat = _hbm_rich_cloud()
    co = gemm_softmax(512, 4096, 128)
    per_mapping = {}
    for sched in ("sequential", "pipelined"):
        r0 = evaluate_mapping(co, fat, MappingSpec(
            variant="fused_dist", m_tiles=8, k_tiles=2, schedule=sched))
        r1 = evaluate_mapping(co, fat, MappingSpec(
            variant="fused_dist", m_tiles=8, k_tiles=2, schedule=sched,
            overlap=1.0))
        per_mapping[sched] = {
            "serial_s": r0.latency, "overlap_s": r1.latency,
            "improvement": 1.0 - r1.latency / r0.latency,
        }
    seq_cl = [MappingSpec(variant="fused_dist", m_tiles=m, k_tiles=k,
                          schedule="sequential")
              for m in (1, 2, 4, 8, 16) for k in (1, 2, 4)]
    s_seq = search(co, fat, candidate_list=seq_cl)
    f_seq = search(co, fat, candidate_list=seq_cl + [
        _dc.replace(sp, overlap=1.0) for sp in seq_cl])
    sec = {
        "arch": fat.name,
        "per_mapping": per_mapping,
        "search_serial_s": s_seq.latency,
        "search_overlap_s": f_seq.latency,
        "search_improvement": 1.0 - f_seq.latency / s_seq.latency,
        "winner_overlap": f_seq.best.spec.overlap,
        "seconds": time.perf_counter() - t0,
        "ok": (all(v["improvement"] > OVERLAP_STRICT_EPS
                   for v in per_mapping.values())
               and f_seq.latency < s_seq.latency * (1 - OVERLAP_STRICT_EPS)
               and f_seq.best.spec.overlap > 0.0),
    }
    print(f"overlap_gemm_softmax_cloud,0,"
          f"seq={per_mapping['sequential']['improvement']*100:.1f}%;"
          f"pipe={per_mapping['pipelined']['improvement']*100:.1f}%;"
          f"search={sec['search_improvement']*100:.1f}%;"
          f"ok={sec['ok']}")
    return sec


def overlap_moe_a2a() -> Dict:
    """The MoE dispatch crossover (cloud preset): under overlap the best
    strategy flips replicated-EP -> a2a-EP and the best per-layer
    collective time strictly improves."""
    from repro_torch.launch.moe_dispatch import run_all as moe_run

    t0 = time.perf_counter()
    moe = moe_run(["cloud"], overlap=1.0)["cloud"]
    flips = {name: (r["best_serial"], r["best_overlap_adjusted"])
             for name, r in moe.items()}
    ok = all(
        r["best_overlap_adjusted"] == "a2a"
        and (r["overlap_adjusted"]["a2a"]
             < min(r["serial"].values()) * (1 - OVERLAP_STRICT_EPS))
        for r in moe.values())
    print(f"overlap_moe_a2a,0,flips={flips};ok={ok}")
    return {"cases": moe, "flips": flips,
            "seconds": time.perf_counter() - t0, "ok": ok}


def _overlap_bench_cmd(device: str, out: str) -> List[str]:
    return [sys.executable, "-m", "repro_torch.launch.overlap_bench",
            "--device", device, "--json", out]


def _fused_kernel(device: str) -> Dict:
    """``overlap_bench`` in a subprocess on ``device``: its exit status,
    the two buffer modes' agreement, the streamed GEMM's launches on the
    card (== its calls, > 0), the hidden fraction (floor where the group
    has two CUDA ranks or more) and the synthetic recovery."""
    with tempfile.TemporaryDirectory(prefix="repro-overlap-bench-") as tmp:
        path = os.path.join(tmp, "overlap.json")
        cmd = _overlap_bench_cmd(device, path)
        r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                           timeout=SUBPROCESS_TIMEOUT)
        if not os.path.exists(path):
            raise RuntimeError(f"{' '.join(cmd)} exited {r.returncode} "
                               f"with no record: {r.stdout[-2000:]} "
                               f"{r.stderr[-2000:]}")
        with open(path) as fh:
            res = json.load(fh)
    hidden = res["fused_gather_gemm"]
    syn = res["synthetic_recovery"]
    agreement = max(rec["buffer_agreement_err"]
                    for rec in res["double_buffer"])
    on_card = device != "cpu"
    floor_applies = (on_card and not hidden["degenerate"]
                     and hidden["participants"] >= 2
                     and hidden["backend"] == "nccl")
    frac = hidden["hidden_fraction"]
    launches = res["launches"].get("streamed_gemm", 0)
    calls = res["calls"].get("streamed_gemm", 0)
    return {
        "bench": res,
        "device": res["device"],
        "returncode": r.returncode,
        "launches": launches,
        "calls": calls,
        "hidden_fraction": frac,
        "hidden_degenerate": hidden["degenerate"],
        "hidden_fraction_floor": HIDDEN_FRACTION_FLOOR,
        "floor_applied": floor_applies,
        "buffer_agreement_err": agreement,
        "synthetic_clean_err": syn["clean_err"],
        "synthetic_jittered_err": syn["jittered_err"],
        "ok": (r.returncode == 0 and res["ok"]
               and agreement <= KERNEL_AGREEMENT_TOL
               and (launches == calls > 0 if on_card else launches == 0)
               and (frac >= HIDDEN_FRACTION_FLOOR if floor_applies
                    else True)
               and syn["clean_err"] <= OVERLAP_RECOVERY_TOL_CLEAN
               and syn["jittered_err"] <= OVERLAP_RECOVERY_TOL_JITTER),
    }


def overlap_gates(device: str = "cuda") -> Dict:
    """The ``overlap`` section: :func:`overlap_pairs`,
    :func:`overlap_gemm_softmax_cloud`, :func:`overlap_moe_a2a`, and the
    streamed GEMM through ``overlap_bench`` on ``device``
    (:func:`_fused_kernel`).  The ``fit_overlap`` synthetic recovery gates
    apply everywhere.  A bench that fails to run fails the section."""
    pair_sec = overlap_pairs()
    gemm_sec = overlap_gemm_softmax_cloud()
    moe_sec = overlap_moe_a2a()

    t0 = time.perf_counter()
    try:
        kern = _fused_kernel(device)
    except (OSError, RuntimeError, ValueError, KeyError,
            subprocess.TimeoutExpired) as e:
        kern = {"error": repr(e), "ok": False}
    kern["seconds"] = time.perf_counter() - t0
    if "error" in kern:
        print(f"overlap_fused_kernel,0,error={kern['error'][:200]};ok=False")
    else:
        frac = kern["hidden_fraction"]
        print(f"overlap_fused_kernel,0,hidden="
              f"{'degenerate' if frac is None else f'{frac:.3f}'}"
              f"(floor={HIDDEN_FRACTION_FLOOR} applied="
              f"{kern['floor_applied']});launches={kern['launches']};"
              f"agreement={kern['buffer_agreement_err']:.1e};"
              f"synthetic_clean={kern['synthetic_clean_err']:.2e};"
              f"jittered={kern['synthetic_jittered_err']:.3f};"
              f"ok={kern['ok']}")

    ok = pair_sec["ok"] and gemm_sec["ok"] and moe_sec["ok"] and kern["ok"]
    print(f"overlap_ok,0,{ok}")
    return {"pairs": pair_sec, "gemm_softmax_cloud": gemm_sec,
            "moe_a2a": moe_sec, "fused_kernel": kern, "ok": ok}


def device_record(dev) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (the first card's), or ``"cpu"``."""
    if dev.type == "cpu":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def host_record() -> Dict:
    """The host's CPU (``/proc/cpuinfo``'s model name where it has one),
    architecture and core count: the timing floors are host
    throughput."""
    import platform

    model = "unknown"
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu_model": model, "machine": platform.machine(),
            "cpus": os.cpu_count()}


def run_all(out_path: str = DEFAULT_OUT, device: str = "cuda") -> Dict:
    """Every section in the reference's order; the record goes to
    ``out_path``."""
    if os.path.basename(out_path) == REFERENCE_RECORD:
        raise ValueError(f"{REFERENCE_RECORD} is the reference bench's "
                         f"record; write the port's elsewhere")
    dev = resolve_device(device)
    seconds: Dict[str, float] = {}

    def timed(name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    result = {
        "schema": SCHEMA,
        "device": device_record(dev),
        "host": host_record(),
        "speedup_floor": SPEEDUP_FLOOR,
        "spaces": timed("spaces", spaces),
        "exhaustive_vs_randomized": timed("exhaustive_vs_randomized",
                                          search_invariants),
        "provisioning": timed("provisioning", provisioning_study),
        "executors": timed("executors", executor_sweep),
        "autotune": timed("autotune", autotune_bench),
        "chunking": timed("chunking", chunking_bench),
        "analysis": timed("analysis", analysis_gates),
        "calibration": timed("calibration", calibration_gates),
        "overlap": timed("overlap", overlap_gates, dev.type),
    }
    result["section_seconds"] = seconds
    result["ok"] = (all(s["speedup"] >= SPEEDUP_FLOOR
                        for s in result["spaces"])
                    and all(p["ok"]
                            for p in result["exhaustive_vs_randomized"])
                    and all(result[k]["ok"] for k in (
                        "provisioning", "executors", "autotune", "chunking",
                        "analysis", "calibration", "overlap")))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"search_throughput_ok,0,{result['ok']};wrote={out_path}")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.search_throughput",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a Hopper card) or "
                         "cpu: where the overlap section's streamed GEMM "
                         "runs")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"the JSON record (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    res = run_all(args.out, args.device)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
