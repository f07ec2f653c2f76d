"""The port's static contracts (``repro_torch.analysis.contracts``): the
kernel, sharded and train arms pass on fake worlds of 8 ranks, (2, 4) and
(4, 2), and of 4, (2, 2) with equal axes; a planted broken tracer and a
planted wrong declaration are flagged; the CLI exits 0 on ``--smoke`` and
nonzero on drift; ``gemm_flops`` and the declared softmax schedule equal
the JAX package's on the same compound ops."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis.contracts import gemm_flops as jgemm_flops
from repro.core import workload as jw
from repro.parallel.collective_planner import \
    softmax_collective_schedule as jschedule
from repro_torch.analysis import contracts as C
from repro_torch.analysis.counts import fake_mode, fake_world, trace_counts
from repro_torch.core import workload as tw
from repro_torch.parallel.collective_planner import \
    softmax_collective_schedule as tschedule

ROOT = Path(__file__).resolve().parents[1]
SMOKE = {"gemm_epilogue_blocks": [(512, 4096, 128)],
         "attention_blocks": [(1024, 1024, 64)],
         "ssd_chunk_len": [(4096, 64, 128)]}


@pytest.fixture(autouse=True)
def no_world_left():
    yield
    assert not dist.is_initialized()


def _bad(checks):
    return "\n".join(c.describe() for c in checks if not c.ok)


def test_kernel_arm_holds_on_every_paper_shape():
    from repro_torch.kernels.autotune import PAPER_KERNEL_SHAPES
    checks = C.kernel_contract_checks()
    flops = [c for c in checks if c.kind == "gemm_flops"]
    assert len(flops) == 2 * len(PAPER_KERNEL_SHAPES[
        "gemm_epilogue_blocks"]) + len(PAPER_KERNEL_SHAPES[
            "attention_blocks"]) + len(PAPER_KERNEL_SHAPES["ssd_chunk_len"])
    assert not _bad(checks), _bad(checks)
    assert all(c.rel_err <= C.DEFAULT_TOL for c in flops)
    assert {c.detail["family"] for c in checks} == {
        "gemm_softmax", "gemm_layernorm", "flash_attention", "ssd"}
    # the SSD check names the product the kernel issues twice (C.18)
    ssd = [c for c in flops if c.detail["family"] == "ssd"]
    assert ssd and all("C.18" in c.detail["note"] for c in ssd)
    # the fused GEMMs: the launch's four tiling numbers are the plan's, and
    # the plan's DSMEM All-Reduce runs over the launch's cluster
    n_gemm = 2 * len(PAPER_KERNEL_SHAPES["gemm_epilogue_blocks"])
    tilings = [c for c in checks if c.kind == "plan_tiling"
               and c.detail["family"].startswith("gemm_")]
    assert len(tilings) == n_gemm and all(
        len(c.detail["launched"]) == 4 for c in tilings)
    dsmem = [c for c in checks if c.kind == "dsmem_allreduce"]
    assert len(dsmem) == n_gemm
    for c in dsmem:
        assert c.detail["participants"] == [c.detail["blocks"][0]]
        assert c.traced == 2 * c.detail["blocks"][1] * 4 \
            * c.detail["blocks"][0] and c.detail["note"] == C.DSMEM_NOTE


@pytest.mark.parametrize("world,shape", [(8, (2, 4)), (8, (4, 2)),
                                         (4, (2, 2))])
def test_sharded_and_train_arms_pass_on_a_fake_world(world, shape):
    from repro_torch.launch.mesh import make_auto_mesh
    with fake_world(world):
        mesh = make_auto_mesh(shape, ("data", "model"), "cpu")
        report = C.run_contracts(SMOKE, arms=C.ARMS, mesh=mesh)
    assert report.ok, report.describe_failures()
    names = [c.name for c in report.checks]
    dp, m = shape
    assert any(f"sharded_softmax_xent[dist,mesh={dp}x{m}]" in n
               for n in names)
    for arch in C.TRAIN_CONTRACT_CONFIGS:
        mine = [c for c in report.checks if c.name.startswith(
            f"train[{arch},mesh={dp}x{m}")]
        kinds = {c.kind for c in mine}
        assert {"collective_count", "collective_wire_bytes",
                "reconcile_findings", "analysis_findings"} <= kinds
    if shape == (2, 2):
        # equal axes: the model-axis stats and the data-axis scalars share
        # one (AllReduce, 2) bucket, aggregated before the comparison
        assert any("AllReduce@P2" in n for n in names)


def test_train_arm_names_c6_in_the_reconciliation():
    checks = C.train_contract_checks(configs=("glm4-9b",))  # world of 8
    rec = [c for c in checks if c.kind == "reconcile_findings"][0]
    findings = rec.detail["reconcile"]["findings"]
    assert findings and all(f["explained"] for f in findings)
    notes = " ".join(f["note"] for f in findings)
    assert "C.6" in notes and "zero1/params" in notes


def test_broken_tracer_is_flagged():
    """A GEMM epilogue that launches twice (double work) must fail its
    FLOP contract with an actionable report; the sibling still passes."""
    from repro_torch.kernels.gemm_softmax import gemm_softmax

    def broken(co, blocks):
        M, K, N = co.dim_sizes["M"], co.dim_sizes["K"], co.dim_sizes["N"]
        with fake_mode():
            a = torch.empty((M, K), dtype=torch.bfloat16, device="cuda")
            b = torch.empty((K, N), dtype=torch.bfloat16, device="cuda")
            return trace_counts(lambda: (gemm_softmax(a, b),
                                         gemm_softmax(a, b)))
    checks = C.kernel_contract_checks(
        shapes={"gemm_epilogue_blocks": [(512, 4096, 128)]},
        tracers={"gemm_softmax": broken})
    bad = [c for c in checks if not c.ok]
    assert bad and bad[0].kind == "gemm_flops"
    assert bad[0].name.startswith("gemm_softmax")
    assert bad[0].traced == pytest.approx(2 * bad[0].predicted)
    msg = bad[0].describe()
    assert "MISMATCH" in msg and "op_sig=" in msg and "predicted=" in msg
    assert all(c.ok for c in checks if c.name.startswith("gemm_layernorm"))


def test_a_launch_off_the_plans_tiling_is_flagged():
    """A wrapper that launches another tiling than the plan's fails the
    plan_tiling check, which compares all four numbers."""
    from repro_torch.kernels import gemm_epilogue as ge
    from repro_torch.kernels.autotune import gemm_epilogue_tiling
    from repro_torch.kernels.gemm_softmax import gemm_softmax
    plan = gemm_epilogue_tiling(512, 4096, 128)
    # same rows and columns as the plan's, another cluster or pass count
    other = next(t for t in ge.tilings(4096, torch.bfloat16) if t != plan)

    def off_plan(co, blocks):
        M, K, N = co.dim_sizes["M"], co.dim_sizes["K"], co.dim_sizes["N"]
        with fake_mode():
            a = torch.empty((M, K), dtype=torch.bfloat16, device="cuda")
            b = torch.empty((K, N), dtype=torch.bfloat16, device="cuda")
            return trace_counts(lambda: gemm_softmax(a, b, tiling=other))
    checks = C.kernel_contract_checks(
        shapes={"gemm_epilogue_blocks": [(512, 4096, 128)]},
        tracers={"gemm_softmax": off_plan})
    bad = [c for c in checks if not c.ok]
    assert all(c.name.startswith("gemm_softmax") for c in bad)
    tiling = [c for c in bad if c.kind == "plan_tiling"]
    assert len(tiling) == 1
    assert tiling[0].detail["launched"] == list(other)
    assert tiling[0].detail["blocks"] == list(plan)


def test_dsmem_participants_off_the_cluster_are_flagged(monkeypatch):
    """The DSMEM check fails when the plan's All-Reduce runs over other
    participants than the launch's cluster."""
    import dataclasses
    real = C._plan_allreduces

    def halved(co, arch, spec):
        return [dataclasses.replace(n, participants=n.participants // 2)
                for n in real(co, arch, spec)]
    monkeypatch.setattr(C, "_plan_allreduces", halved)
    checks = C.kernel_contract_checks(
        shapes={"gemm_epilogue_blocks": [(512, 4096, 128)]})
    bad = [c for c in checks if not c.ok]
    assert {c.kind for c in bad} == {"dsmem_allreduce"} and len(bad) == 2


def test_wrong_schedule_is_flagged():
    from repro_torch.parallel.collective_planner import \
        train_collective_schedule

    def drifted(cfg, mesh, batch, seq, **kw):
        out = []
        for d in train_collective_schedule(cfg, mesh, batch, seq, **kw):
            if d.label == "xent/stats":
                d = type(d)(d.label, d.col_type, d.dv_bytes, d.participants,
                            d.count - 1, d.origin)
            out.append(d)
        return out
    checks = C.train_contract_checks(configs=("glm4-9b",),
                                     schedule_fn=drifted)
    bad = [c for c in checks if not c.ok]
    assert bad and all(c.kind in ("collective_count",
                                  "collective_wire_bytes") for c in bad)
    assert any("xent/stats" in c.detail["declared_labels"] for c in bad)


def _cli(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def test_cli_smoke_exits_zero_with_every_check():
    r = _cli("from repro_torch.analysis.__main__ import main\n"
             "raise SystemExit(main(['--smoke']))\n")
    assert r.returncode == 0, r.stderr[-3000:]
    data = json.loads(r.stdout)
    assert data["schema"] == "repro_torch/static-analysis/v1"
    assert data["ok"] and data["contracts"]["ok"] and data["lint"]["ok"]
    assert data["contracts"]["arms"] == ["kernel", "sharded", "train"]
    names = [c["name"] for c in data["contracts"]["checks"]]
    assert any("sharded_softmax_xent[dist,mesh=2x4]" in n for n in names)
    assert any(n.startswith("train[qwen3-moe-30b-a3b,mesh=2x4") for n in
               names)
    assert data["contracts"]["checked"] == len(names) == \
        data["contracts"]["passed"]


def test_cli_exits_nonzero_on_drift():
    r = _cli("import repro_torch.parallel.collective_planner as cp\n"
             "orig = cp.softmax_collective_schedule\n"
             "cp.softmax_collective_schedule = lambda *a, **k: [\n"
             "    (t, dv, P, n + 1) for t, dv, P, n in orig(*a, **k)]\n"
             "from repro_torch.analysis.__main__ import main\n"
             "raise SystemExit(main(['--smoke', '--contracts=sharded']))\n")
    assert r.returncode == 1, r.stderr[-3000:]
    data = json.loads(r.stdout)
    assert not data["ok"] and data["contracts"]["failed"] > 0
    assert "MISMATCH" in r.stderr


@pytest.mark.parametrize("make", [
    lambda w: w.flash_attention(1024, 64, 1024, 64),
    lambda w: w.flash_attention(128, 128, 32768, 128),
    lambda w: w.gemm_softmax(512, 4096, 128),
    lambda w: w.gemm_softmax(4096, 16384, 4096),
    lambda w: w.ssd_chunk(S=4096, H=1, P=64, Dst=128, C=64),
    lambda w: w.ssd_chunk(S=1000, H=2, P=32, Dst=16, C=32),
])
def test_gemm_flops_match_jax(make):
    assert C.gemm_flops(make(tw)) == jgemm_flops(make(jw))


@pytest.mark.parametrize("args", [("dist", 128, 4096, 8, 2),
                                  ("gather", 128, 4096, 8, 1),
                                  ("dist", 64, 512, 1, 4),
                                  ("gather", 32, 1024, 2, 2)])
def test_softmax_schedule_matches_jax(args):
    strategy, rows, cols, p, dp = args
    assert tschedule(strategy, rows, cols, p, dp_participants=dp) == \
        jschedule(strategy, rows, cols, p, dp_participants=dp)
