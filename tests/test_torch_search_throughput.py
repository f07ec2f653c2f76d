"""The port's search-throughput bench, sections 2-6, against the JAX
package's bench (``benchmarks/search_throughput.py``) on the same inputs.

The port's core is a numpy copy of ``repro.core`` (bit-equal latency and
energy), so every best latency, energy, evaluated count, front size and
best spec of a section must equal the original's (``==``).  Both sides
search serially here (``search_many`` patched to ``executor='serial'``):
the JAX bench's process pools fork (ROADMAP C.2), so its
``executor_sweep`` and ``chunking_bench`` are never called; their serial
results and the chunk placement are compared instead.  The port's own
pools (forkserver) run in one subprocess under a time limit, which holds
serial, thread and process bit for bit on a few pairs.  Timing floors are
recorded by the bench and asserted on the card only (chip_smoke phase
38).
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

import benchmarks.search_throughput as jst
from benchmarks import paper_tables as jpaper
from repro.core import search as jsearch
from repro.core.hardware import cloud as jcloud
from repro.core.hardware import edge as jedge
from repro.core.workload import attention as jattention
from repro.core.workload import gemm_layernorm as jgemm_layernorm
from repro.core.workload import gemm_softmax as jgemm_softmax
from repro_torch.core import hardware as thw
from repro_torch.core import search as tsearch
from repro_torch.core import workload as twl
from repro_torch.kernels import autotune
from repro_torch.launch import search_throughput as st

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def serial(monkeypatch):
    """Both benches' ``search_many`` on the serial executor."""
    monkeypatch.setattr(jst, "search_many", functools.partial(
        jsearch.search_many, executor="serial"))
    monkeypatch.setattr(st, "search_many", functools.partial(
        tsearch.search_many, executor="serial"))


def _spec(spec):
    return dataclasses.asdict(spec)


def _same(jr, tr):
    """A JAX ``SearchResult`` and the port's: latency, energy, evaluated
    count and best spec equal."""
    return (jr.latency == tr.latency and jr.energy_pj == tr.energy_pj
            and jr.evaluated == tr.evaluated
            and _spec(jr.best.spec) == _spec(tr.best.spec))


# the five spaces of run_all, in both packages: (name, JAX op, port op,
# arch name, axes)
SPACES = [
    ("gemm_softmax", jgemm_softmax(512, 1024, 128),
     twl.gemm_softmax(512, 1024, 128), "edge", "legacy"),
    ("attention", jattention(1024, 256, 1024, 256),
     twl.attention(1024, 256, 1024, 256), "edge", "legacy"),
    ("gemm_softmax", jgemm_softmax(512, 1024, 128),
     twl.gemm_softmax(512, 1024, 128), "edge", "full"),
    ("attention", jattention(1024, 256, 1024, 256),
     twl.attention(1024, 256, 1024, 256), "edge", "full"),
    ("gemm_softmax_np2", jgemm_softmax(*jpaper.PROVISIONING_GEMMS[0]),
     twl.gemm_softmax(*jpaper.PROVISIONING_GEMMS[0]), "edge", "full"),
]


@pytest.mark.parametrize("case", SPACES, ids=[f"{s[0]}_{s[4]}"
                                              for s in SPACES])
def test_space_batch_pass_matches_jax(case):
    """Section 2: the batched engine's pass over each space evaluates the
    same mappings and topologies and finds the same best latency."""
    _name, jco, tco, arch, axes = case
    jarch, tarch = getattr(jst, arch)(), getattr(thw, arch)()
    jc, tc = jsearch.candidate_specs(jco, jarch), \
        tsearch.candidate_specs(tco, tarch)
    if axes == "legacy":
        jc = dict(jc, sp_cluster=[0], sp_core=[0])
        tc = dict(tc, sp_cluster=[0], sp_core=[0])
    assert tc == jc
    jb = jst._batch_throughput(jco, jarch, jc, repeats=1)
    tb = st._batch_throughput(tco, tarch, tc, repeats=1)
    assert tb["topologies"] == jb["topologies"]
    for k in ("cold", "warm"):
        assert tb[k]["mappings"] == jb[k]["mappings"]
        assert tb[k]["best_latency_s"] == jb[k]["best_latency_s"]


def test_spaces_are_run_alls_five(monkeypatch):
    """``spaces()`` measures the reference's five (workload, axes) pairs
    on edge."""
    calls = []

    def fake(name, co, arch, axes="full"):
        calls.append((name, axes, arch.name, dict(co.dim_sizes)))
        return {"speedup": 1.0}

    monkeypatch.setattr(st, "measure_space", fake)
    st.spaces()
    assert [(n, a) for n, a, _arch, _d in calls] \
        == [(s[0], s[4]) for s in SPACES]
    assert {arch for _n, _a, arch, _d in calls} == {"edge"}
    assert [d for *_x, d in calls] == [dict(s[1].dim_sizes) for s in SPACES]


def test_measure_space_record():
    """One space through ``measure_space`` as ``run_all`` does: the cold
    batch pass's mappings and best latency are the JAX bench's, the
    speedup is the cold batch rate over the tree rate."""
    _n, jco, tco, _a, _x = SPACES[0]
    rec = st.measure_space("gemm_softmax", tco, thw.edge(), axes="legacy")
    jc = dict(jsearch.candidate_specs(jco, jedge()), sp_cluster=[0],
              sp_core=[0])
    jb = jst._batch_throughput(jco, jedge(), jc, repeats=1)
    assert rec["batch"]["cold"]["mappings"] == jb["cold"]["mappings"]
    assert rec["batch"]["cold"]["best_latency_s"] \
        == jb["cold"]["best_latency_s"]
    assert rec["speedup"] == pytest.approx(
        rec["batch"]["cold"]["mappings_per_sec"]
        / rec["tree"]["mappings_per_sec"])
    assert rec["tree"]["mappings"] >= st.TREE_SAMPLE


def test_paper_pairs_match_jax():
    jp, tp = jst._paper_pairs(), st._paper_pairs()
    assert len(tp) == len(jp) == 48
    for (jn, jco, ja), (tn, tco, ta) in zip(jp, tp):
        assert (tn, ta.name, dict(tco.dim_sizes)) \
            == (jn, ja.name, dict(jco.dim_sizes))


def test_search_invariants_match_jax(serial):
    """Section 3a: every pair's exhaustive, pow2, randomized and front
    numbers equal the JAX bench's, and every invariant holds."""
    j, t = jst.search_invariants(), st.search_invariants()
    assert t == j
    assert len(t) == 48 and all(r["ok"] for r in t)


def test_provisioning_matches_jax():
    """Section 3b: the 3-D fronts on the non-pow2 GEMMs equal the JAX
    bench's."""
    j, t = jst.provisioning_study(), st.provisioning_study()
    assert t == j
    assert t["ok"] and len(t["pairs"]) == 4


def test_executor_jobs_serial_results_match_jax():
    """Section 4's 48 jobs, serially in both packages: the same best
    mapping of every pair (the port's pools must reproduce these)."""
    jjobs = [(co, a, dict(jpaper.SEARCH_KW)) for _n, co, a
             in jst._paper_pairs()]
    tjobs = [(co, a, dict(jpaper.SEARCH_KW)) for _n, co, a
             in st._paper_pairs()]
    jr = jsearch.search_many(jjobs, executor="serial")
    tr = tsearch.search_many(tjobs, executor="serial")
    assert all(_same(a, b) for a, b in zip(jr, tr))


_POOLS = """
import json, sys, warnings
sys.path.insert(0, {src!r})
import multiprocessing.forkserver as fs
from repro_torch.core import batcheval
from repro_torch.core.search import search_many
from repro_torch.launch import search_throughput as st
from repro_torch.launch.paper_tables import SEARCH_KW
if __name__ == "__main__":
    jobs = [(co, a, dict(SEARCH_KW)) for _n, co, a in st._paper_pairs()[::8]]
    out = {{}}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", "(search_many|parallel_map):",
                                RuntimeWarning)
        for ex in ("serial", "thread", "process"):
            batcheval.cache_clear()
            out[ex] = [[r.latency, r.energy_pj, r.evaluated, repr(r.best.spec)]
                       for r in search_many(jobs, executor=ex)]
    out["preload"] = fs._forkserver._preload_modules
    print(json.dumps(out))
"""


def test_serial_thread_and_process_are_bit_identical():
    """Section 4 on the port's pools, in a subprocess under a time limit:
    six pairs through serial, thread and process (forkserver, its server
    preloading the workers' module) give the same floats and specs, with
    no fallback warning."""
    res = subprocess.run(
        [sys.executable, "-c", _POOLS.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["serial"]) == 6
    assert out["serial"] == out["thread"] == out["process"]
    assert out["preload"] == ["repro_torch.core.search"]


def test_autotune_bench_values_are_the_ports_plans(tmp_path, monkeypatch):
    """Section 5: each entry's value is what the port's autotune answers
    on a fresh store (the port plans on ``h100()``), the cold call solved
    and the warm and disk calls looked up; the floor is recorded, not
    asserted here."""
    res = st.autotune_bench()
    assert res["warm_speedup_floor"] == st.WARM_SPEEDUP_FLOOR == 100.0
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    want = {"attention_blocks": list(autotune.attention_blocks(4096, 4096,
                                                               128)),
            "gemm_epilogue_blocks": list(autotune.gemm_epilogue_blocks(
                4096, 4096, 4096)),
            "ssd_chunk_len": autotune.ssd_chunk_len(4096, 64, 128)}
    assert {k: e["value"] for k, e in res["entries"].items()} == want
    for e in res["entries"].values():
        assert e["cold_solve_s"] > 0 and e["warm_lookup_s"] > 0 \
            and e["disk_lookup_s"] > 0
        assert e["ok"] == (e["warm_speedup"] >= st.WARM_SPEEDUP_FLOOR)


def _jax_chunking_jobs():
    """The JAX chunking bench's job list, as ``chunking_bench`` builds
    it."""
    tiny = [(fn(M, N, K), arch, dict(jpaper.SEARCH_KW))
            for shapes, arch in ((jpaper.GEMMS_EDGE, jedge()),
                                 (jpaper.GEMMS_CLOUD, jcloud()))
            for M, N, K in shapes
            for fn in (jgemm_softmax, jgemm_layernorm)]
    huge = (jgemm_softmax(*jpaper.PROVISIONING_GEMMS[1]), jcloud(),
            dict(jpaper.SEARCH_KW))
    return tiny + [huge]


def test_chunking_placement_and_results_match_jax():
    """Section 6: the contiguous chunks are the JAX package's; size-aware,
    the huge job opens the first chunk as there, but alone: the port deals
    longest first to the least-loaded chunk, where the JAX package's
    round-robin puts three tiny jobs behind it.  Each job's serial result
    equals the original's."""
    jjobs, tjobs = _jax_chunking_jobs(), st.chunking_jobs()
    assert len(tjobs) == len(jjobs) == 25
    norm = [jsearch._norm_job(j) for j in jjobs]
    place = st.chunk_placement(tjobs)
    jchunks = {mode: [[i for i, _j in c] for c in
                      jsearch._make_chunks(norm, st.CHUNKSIZE, mode)]
               for mode in ("size", "contiguous")}
    assert place["contiguous_chunks"] == jchunks["contiguous"]
    assert place["huge_first"] and place["huge_last_contig"]
    assert place["size_chunks"][0] == [24]
    assert jchunks["size"][0][0] == 24 and len(jchunks["size"][0]) == 4
    assert len(place["size_chunks"]) == len(jchunks["size"]) == 7
    assert sorted(i for c in place["size_chunks"] for i in c) \
        == list(range(25))
    jr = jsearch.search_many(jjobs, executor="serial")
    tr = tsearch.search_many(tjobs, executor="serial")
    assert all(_same(a, b) for a, b in zip(jr, tr))


def test_make_chunks_deals_to_the_least_loaded_chunk():
    """The port's size-aware deal on exact sizes (candidates mode counts
    its list): longest first, each job to the chunk with the least work
    so far, ties to the lower chunk; jobs of one size round-robin, as
    the JAX package deals them."""
    import repro.core.workload as jwl
    from repro.core.ir import MappingSpec as JSpec
    from repro_torch.core.ir import MappingSpec as TSpec

    def placed(search, wl, arch, spec, ns):
        co = wl.gemm_softmax(256, 1024, 64)
        js = [(co, arch(), {"candidate_list": [
            spec(variant="fused_dist", m_tiles=1 + i) for i in range(n)]})
            for n in ns]
        return [[i for i, _j in c] for c in search._make_chunks(
            [search._norm_job(j) for j in js], 2, "size")]

    port = functools.partial(placed, tsearch, twl, thw.edge, TSpec)
    jax_ = functools.partial(placed, jsearch, jwl, jedge, JSpec)
    ns = [2, 5, 1, 9, 3, 4, 7]
    assert port(ns) == [[3], [6, 2], [1, 0], [5, 4]]
    assert jax_(ns) == [[3, 4], [6, 0], [1, 2], [5]]
    assert port([3] * 7) == jax_([3] * 7) == [[0, 4], [1, 5], [2, 6], [3]]


def test_gate_constants_are_the_references():
    for name in ("SPEEDUP_FLOOR", "TREE_SAMPLE", "MIN_TREE_SECONDS",
                 "REL_EPS", "WARM_SPEEDUP_FLOOR", "CHUNKING_TOLERANCE",
                 "RECOVERY_TOL_CLEAN", "RECOVERY_TOL_JITTER",
                 "COLLECTIVE_MEDIAN_GATE", "CPU_GATE_MEDIAN",
                 "OVERLAP_STRICT_EPS", "OVERLAP_RECOVERY_TOL_CLEAN",
                 "OVERLAP_RECOVERY_TOL_JITTER", "KERNEL_AGREEMENT_TOL"):
        assert getattr(st, name) == getattr(jst, name), name
    assert st.HIDDEN_FRACTION_FLOOR == jst.TPU_HIDDEN_FRACTION_FLOOR == 0.25
    assert st.SMOKE_SHAPES == {
        "gemm_epilogue_blocks": [(512, 4096, 128)],
        "attention_blocks": [(1024, 1024, 64)],
        "ssd_chunk_len": [(4096, 64, 128)]}
