"""The port's dry run (``repro_torch.launch.dryrun``): a smoke config's
train step on a fake (2, 2) world records exactly the collectives that
the real gloo run records on the same config and mesh
(``tests/torch_mesh_ranks.py``'s ``dryrun`` suite), on every rank, and its
state's bytes are the real state's; train, prefill and decode cells each
produce an artifact with its FLOPs, memory, collectives, reconciliation
and roofline, with ``fsdp`` (ZeRO-3) too, whose train state is smaller
than the same cell's without it; importing the module makes no
world."""
import json
import subprocess
import sys

import pytest
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import load, print_table, row

WORLD = 4
KEYS = {"params", "active_params", "structural_flops_per_device",
        "structural_flops_global", "memory", "collectives", "reconcile",
        "roofline", "model_flops_global", "model_flops_per_device",
        "useful_flop_ratio", "contracts", "step_counts", "trace_s"}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, (WORLD,), "dryrun")[WORLD]


@pytest.fixture(autouse=True)
def no_world_left():
    yield
    assert not dist.is_initialized()


def _cell(arch, rank=0):
    cfg = ranks.case_config(arch).with_(softmax_strategy="dist")
    return dryrun.run_cell(
        arch, "train_4k", "single", config=cfg, mesh_shape=(2, 2), rank=rank,
        opt_flags={"global_batch": ranks.STEP_BATCH,
                   "seq_len": ranks.STEP_SEQ, "planner_loss": True})


@pytest.mark.parametrize("arch", ranks.DRYRUN_CASES)
def test_fake_world_records_the_gloo_runs_collectives(gloo, arch):
    real = ranks.load(gloo, f"dryrun_{arch}", WORLD)
    for rank in (0, WORLD - 1):     # the first rank and the last
        rec = _cell(arch, rank)
        meta = real[rank][1]
        assert rec["records"] == meta["records"][0], rank
        assert rec["recompute_records"] == meta["recompute"][0], rank
        assert rec["memory"]["state_bytes"] == meta["state_bytes"], rank
        assert rec["contracts"]["ok"], rec["contracts"]
        assert KEYS <= set(rec)


CELLS = [("train_4k", {"global_batch": 4, "seq_len": 16,
                       "planner_loss": True}),
         ("prefill_32k", {"global_batch": 2, "seq_len": 32}),
         ("decode_32k", {"global_batch": 2, "seq_len": 64})]


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
@pytest.mark.parametrize("shape,opt", CELLS)
def test_every_kind_of_cell_produces_an_artifact(tmp_path, arch, shape,
                                                 opt):
    cfg = ranks.case_config(arch)
    rec = dryrun.run_cell(arch, shape, "single", config=cfg,
                          mesh_shape=(1, 2), opt_flags=opt)
    assert KEYS <= set(rec)
    assert rec["kind"] == shape.split("_")[0]
    assert rec["devices"] == 2 and rec["structural_flops_per_device"] > 0
    assert rec["structural_flops_global"] == \
        2 * rec["structural_flops_per_device"]
    assert rec["memory"]["state_bytes"] > 0
    assert rec["memory"]["peak_by_category"]["Total"] > 0
    assert rec["roofline"]["bound_s"] > 0 and rec["contracts"]["ok"]
    assert "trace_findings" not in rec
    if rec["kind"] != "train":
        assert rec["collectives"]    # tensor-parallel serving on (1, 2)
    (tmp_path / "cell.json").write_text(json.dumps(dict(rec, tag="")))
    x = row(load("", str(tmp_path))[0])
    assert x["t_compute"] == rec["roofline"]["t_compute_s"]
    print_table(load("", str(tmp_path)), markdown=True)


def test_cli_writes_a_cell_and_refuses_fsdp(tmp_path):
    """The CLI writes a cell; ``fsdp=true`` (ZeRO-3), which the port once
    refused, writes a train, a prefill and a decode cell, its params at
    their ``zero1_shardings`` slices: the train state is smaller than the
    same cell's without it, and the train cell's reconciliation leaves no
    finding unexplained."""
    out = tmp_path / "decode.json"
    env_code = ("from repro_torch.launch.dryrun import main\n"
                "raise SystemExit(main(['--arch', 'glm4-9b', '--shape', "
                "'decode_32k', '--mesh', 'host', '--opt', "
                "'n_layers=1,global_batch=2,seq_len=128,fsdp=true', "
                "'--out', %r]))\n" % str(out))
    r = subprocess.run([sys.executable, "-c", env_code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["devices"] == 1 and rec["use_kernels"]
    assert any(x[0].startswith("params/") for x in rec["records"])
    cfg = ranks.case_config("glm4-9b")
    state = {}
    for shape, opt in CELLS:
        for fsdp in (True, False):
            # 4 rows: a cache's batch dim of the smoke depth, 2, would
            # read as its layer dim (cache_shardings' rule)
            cell = dryrun.run_cell("glm4-9b", shape, "single",
                                   config=cfg.with_(fsdp=fsdp),
                                   mesh_shape=(2, 2),
                                   opt_flags=dict(opt, global_batch=4))
            assert KEYS <= set(cell) and cell["kind"] == shape.split("_")[0]
            state[shape, fsdp] = cell["memory"]["state_bytes"]
            labels = {x[0].split("/")[0] for x in cell["records"]}
            assert ("params" in labels) == fsdp
            if shape == "train_4k":
                assert all(f["explained"]
                           for f in cell["reconcile"]["findings"]), fsdp
    assert state["train_4k", True] < state["train_4k", False]
    for shape in ("prefill_32k", "decode_32k"):
        assert state[shape, True] < state[shape, False]
