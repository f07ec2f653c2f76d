"""The port's search-throughput bench, sections 7-9, its CLI and
``launch/run.py``'s chain, on the CPU.

- The CLI (``main(["--device", "cpu", "--out", ...])``) runs in a
  subprocess under a time limit, since its executor and chunking sections
  start process pools (forkserver), its calibration section spawns gloo
  ranks and its overlap section runs the overlap bench.  The sweeps are cut
  to a few pairs and the overlap bench to small shapes there; every
  section is present, the exit status is ``0 if ok else 1``, what does not
  depend on time holds, and the repository's ``BENCH_search.json`` is
  byte for byte what it was.
- The cost-model parts of sections 8 and 9 equal the JAX bench's
  (``benchmarks/search_throughput.py``) on the same inputs: the JAX
  bench's subprocess steps are made to fail (its sections then skip them
  and pass), and the rest compared, fits to 1e-12 relative.
- Planted faults fail their section, never skip it: a declaration that
  drops an entry (analysis), a calibration run that exits 1
  (calibration), an overlap bench that exits 1 (overlap), a process pool
  that cannot be made (executors, chunking).
- Timing floors are recorded, not asserted here: the card's run asserts
  them (chip_smoke phase 38).
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import benchmarks.search_throughput as jst
from benchmarks.overlap_bench import synthetic_recovery as jsynthetic
from repro.core import search as jsearch
from repro_torch.core import search as tsearch
from repro_torch.launch import overlap_bench as ob
from repro_torch.launch import run as bench_chain
from repro_torch.launch import search_throughput as st
from repro_torch.parallel.collective_planner import train_collective_schedule

ROOT = Path(__file__).resolve().parents[1]
BENCH_RECORD = ROOT / "BENCH_search.json"

# the overlap bench at small shapes (the CLI's fused-kernel step)
_SMALL_OVERLAP = """
import json, sys
import torch
from repro_torch.launch import overlap_bench as ob
out = ob.run_all(sys.argv[1],
                 shapes=[(64, 256, 128, 4, torch.float32),
                         (64, 256, 128, 2, torch.bfloat16)],
                 allgather_shape=(64, 256, 128, torch.float32),
                 hidden_shape=(64, 256, 128), iters=2)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
sys.exit(0 if out["ok"] else 1)
"""

_CLI = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.launch import search_throughput as st
if __name__ == "__main__":
    pairs, jobs = st._paper_pairs, st.chunking_jobs
    st._paper_pairs = lambda: pairs()[::12]
    st.chunking_jobs = lambda: jobs()[::4]     # the huge job stays last
    st._overlap_bench_cmd = lambda device, out: [
        sys.executable, "-c", {overlap!r}, device, out]
    sys.exit(st.main(["--device", "cpu", "--out", {out!r}]))
"""


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rel * np.maximum(np.abs(a),
                                                         np.abs(b))))


def test_cli_on_the_cpu(tmp_path):
    """``main`` on the CPU: schema v9 and every section, exit ``0 if ok
    else 1``, and the reference's ``BENCH_search.json`` untouched."""
    before = BENCH_RECORD.read_bytes()
    out = tmp_path / "st.json"
    code = _CLI.format(src=str(ROOT / "src"), overlap=_SMALL_OVERLAP,
                       out=str(out))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert BENCH_RECORD.read_bytes() == before
    assert out.exists(), res.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert res.returncode == (0 if rec["ok"] else 1), res.stderr[-3000:]
    assert rec["schema"] == "comet/search_throughput/v9"
    assert rec["device"] == "cpu" and rec["host"]["cpus"] >= 1
    sections = ("spaces", "exhaustive_vs_randomized", "provisioning",
                "executors", "autotune", "chunking", "analysis",
                "calibration", "overlap")
    assert set(sections) <= set(rec)
    assert list(rec["section_seconds"]) == list(sections)
    assert rec["ok"] == (
        all(s["speedup"] >= st.SPEEDUP_FLOOR for s in rec["spaces"])
        and all(p["ok"] for p in rec["exhaustive_vs_randomized"])
        and all(rec[k]["ok"] for k in sections[2:]))

    assert len(rec["spaces"]) == 5
    assert len(rec["exhaustive_vs_randomized"]) == 4
    assert all(p["ok"] for p in rec["exhaustive_vs_randomized"])
    assert rec["provisioning"]["ok"]
    ex = rec["executors"]
    assert ex["pairs"] == 4 and ex["bit_identical"]
    assert ex["leaked_segments"] == [] and ex["fallbacks"] == []
    assert set(ex["jobs_per_sec"]) == {"serial", "thread", "process"}
    ch = rec["chunking"]
    assert ch["jobs"] == 7 and ch["huge_job_in_first_chunk"] \
        and ch["huge_job_in_last_contiguous_chunk"] and ch["bit_identical"]
    assert ch["fallbacks"] == []
    assert set(rec["autotune"]["entries"]) == {
        "attention_blocks", "gemm_epilogue_blocks", "ssd_chunk_len"}

    an = rec["analysis"]
    assert an["ok"], an
    assert an["contract_failures"] == [] and an["lint_findings"] == []
    tr = an["train"]
    assert tr["contracts_ok"] and tr["reconcile_ok"]
    assert tr["reconcile"]["per_type"]["all-reduce"]["status"] == "match"
    assert tr["reconcile"]["mesh"] == "2x4"
    assert "grads/layers.attn.wq" in tr["reconcile"]["c6_sized"]

    cal = rec["calibration"]
    assert cal["recovery"]["ok"] and cal["collective"]["ok"]
    cpu = cal["cpu"]
    assert "error" not in cpu, cpu
    assert cpu["ranks"] == st.CALIB_RANKS
    assert not cpu["first"]["reused"] and cpu["first"]["fits_solved"] == 1
    assert cpu["second"]["reused"] and cpu["second"]["fits_solved"] == 0
    assert cpu["bit_identical"] and cpu["stray_files"] == []
    assert cpu["ok"] == (cpu["first"]["gate_ok"]
                         and cpu["returncodes"] == [0, 0])

    ov = rec["overlap"]
    assert ov["pairs"]["ok"] and ov["gemm_softmax_cloud"]["ok"] \
        and ov["moe_a2a"]["ok"]
    kern = ov["fused_kernel"]
    assert kern["ok"], kern
    assert kern["device"] == "cpu" and kern["launches"] == 0
    assert kern["hidden_degenerate"] and not kern["floor_applied"]
    assert kern["calls"] == 2 + 2 * 2 + 0     # allgather 2, 2 shapes x 2


def _drop_first_explicit(cfg, mesh, batch, seq, **kw):
    sched = train_collective_schedule(cfg, mesh, batch, seq, **kw)
    i = next(i for i, d in enumerate(sched)
             if d.origin == "explicit" and d.participants > 1)
    return sched[:i] + sched[i + 1:]


def test_dropped_declared_entry_fails_analysis():
    res = st.analysis_gates(schedule_fn=_drop_first_explicit)
    assert res["contract_failures"] == [] and res["lint_findings"] == []
    assert not res["train"]["contracts_ok"]
    assert res["train"]["contract_failures"]
    assert not res["ok"]


@pytest.fixture
def no_subprocess(monkeypatch):
    """The JAX bench's subprocess steps fail (they then skip and pass)."""
    def refuse(*a, **k):
        raise OSError("no subprocess here")
    monkeypatch.setattr(subprocess, "run", refuse)


def test_calibration_parts_match_jax_and_exit_1_fails(monkeypatch,
                                                      no_subprocess):
    """Section 8: the synthetic recovery errors equal the JAX bench's to
    1e-12 relative and the collective comparison is its dict; a
    calibration run that exits 1 fails the section."""
    j = jst.calibration_gates()
    assert "skipped" in j["cpu"] and j["cpu"]["ok"]   # what is not ported
    monkeypatch.undo()
    monkeypatch.setattr(st, "_calibrate_cmd", lambda store: [
        sys.executable, "-c", "import sys; sys.exit(1)"])
    t = st.calibration_gates()
    for k in ("clean_worst_rel_err", "jitter_worst_rel_err"):
        assert _close(t["recovery"][k], j["recovery"][k]), k
    assert t["recovery"]["ok"] and j["recovery"]["ok"]
    assert t["collective"] == j["collective"]
    assert "exited 1" in t["cpu"]["error"] and "skipped" not in t["cpu"]
    assert "ranks" not in t["cpu"]
    assert not t["cpu"]["ok"] and not t["ok"]


def test_overlap_parts_match_jax(monkeypatch, no_subprocess):
    """Section 9's cost-model parts: the 48-pair sweep three ways, the
    HBM-rich showcase and the MoE flip equal the JAX bench's (serial
    searches on both sides)."""
    monkeypatch.setattr(jst, "search_many", functools.partial(
        jsearch.search_many, executor="serial"))
    monkeypatch.setattr(st, "search_many", functools.partial(
        tsearch.search_many, executor="serial"))
    j = jst.overlap_gates()
    assert "skipped" in j["fused_kernel"]
    t = {"pairs": st.overlap_pairs(),
         "gemm_softmax_cloud": st.overlap_gemm_softmax_cloud(),
         "moe_a2a": st.overlap_moe_a2a()}
    for k, sec in t.items():
        a = {x: v for x, v in sec.items() if x != "seconds"}
        b = {x: v for x, v in j[k].items() if x != "seconds"}
        assert a == b, k
        assert sec["ok"]
    assert t["pairs"]["pairs"] == 48


def test_synthetic_overlap_recovery_matches_jax():
    j, t = jsynthetic(), ob.synthetic_recovery()
    assert set(t) == set(j)
    for k in j:
        assert _close(t[k], j[k]), k
    assert t["clean_err"] <= st.OVERLAP_RECOVERY_TOL_CLEAN
    assert t["jittered_err"] <= st.OVERLAP_RECOVERY_TOL_JITTER


def test_failed_overlap_bench_fails_overlap(monkeypatch):
    pairs = st._paper_pairs
    monkeypatch.setattr(st, "_paper_pairs", lambda: pairs()[:2])
    monkeypatch.setattr(st, "_overlap_bench_cmd", lambda device, out: [
        sys.executable, "-c", "import sys; sys.exit(1)"])
    res = st.overlap_gates("cpu")
    assert res["pairs"]["ok"] and res["moe_a2a"]["ok"]
    assert "exited 1" in res["fused_kernel"]["error"]
    assert not res["fused_kernel"]["ok"] and not res["ok"]


class _NoPool:
    def __init__(self, **kw):
        raise OSError("no process pool here")


def test_pool_that_cannot_start_fails_executors_and_chunking(monkeypatch):
    """``search_many`` falls back to threads with a warning; a process
    time measured on threads fails both sections."""
    monkeypatch.setattr(tsearch, "ProcessPoolExecutor", _NoPool)
    pairs, jobs = st._paper_pairs, st.chunking_jobs
    monkeypatch.setattr(st, "_paper_pairs", lambda: pairs()[:3])
    monkeypatch.setattr(st, "chunking_jobs", lambda: jobs()[::4])
    ex = st.executor_sweep(repeats=1)
    assert ex["bit_identical"] and ex["fallbacks"]
    assert all("falling back to threads" in m for m in ex["fallbacks"])
    assert not ex["ok"]
    ch = st.chunking_bench(repeats=1)
    assert ch["bit_identical"] and ch["fallbacks"] and not ch["ok"]


def test_run_chain_calls_the_five_front_ends_in_order(monkeypatch, capsys):
    from repro_torch.launch import (costmodel_compare, kernel_bench,
                                    moe_dispatch, paper_tables, roofline)
    seen = []
    for mod in (paper_tables, costmodel_compare, moe_dispatch, roofline):
        name = mod.__name__.rsplit(".", 1)[1]
        monkeypatch.setattr(mod, "run_all",
                            lambda _n=name: seen.append((_n, None)) or _n)
    monkeypatch.setattr(kernel_bench, "run_all",
                        lambda device=None: seen.append(
                            ("kernel_bench", device)) or "kernel_bench")
    out = bench_chain.main(["--device", "cpu"])
    assert seen == [("paper_tables", None), ("costmodel_compare", None),
                    ("kernel_bench", "cpu"), ("moe_dispatch", None),
                    ("roofline", None)]
    assert out == {n: n for n, _d in seen}
    heads = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("# ====")]
    src = (ROOT / "benchmarks" / "run.py").read_text()
    for h in heads:
        assert (h in src) == ("CUDA" not in h), h
    assert len(heads) == 5 and "CUDA kernels" in heads[2]


def test_roofline_says_it_read_no_artifacts(tmp_path, capsys):
    from repro_torch.launch import roofline
    assert roofline.run_all(str(tmp_path)) == {"n": 0, "bottlenecks": {}}
    assert "from 0 dry-run artifacts" in capsys.readouterr().out


def test_the_reference_record_is_never_written(tmp_path):
    with pytest.raises(ValueError, match="BENCH_search.json"):
        st.run_all(str(tmp_path / "BENCH_search.json"), "cpu")
    assert not (tmp_path / "BENCH_search.json").exists()


def test_main_runs_on_the_card_by_default(tmp_path):
    """``--device`` defaults to ``cuda``: with no Hopper card it raises
    before any section runs and writes nothing."""
    out = tmp_path / "st.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        st.main(["--out", str(out)])
    assert not out.exists()
    assert st.DEFAULT_OUT == "bench_out/search_throughput_torch.json"
