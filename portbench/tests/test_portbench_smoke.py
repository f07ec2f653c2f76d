"""Each driver runs its cell at the CPU's size in a process of its own and
prints one result line with the keys the contract asks for; with
``--trace 1`` its per-layer metrics.  The process exits 0 only if no
module of JAX or of the JAX package was loaded (``smoke.main``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

SMOKE = Path(__file__).resolve().parent / "smoke.py"
REPO = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("workload,trace,metrics", [
    ("glm4-9b.serve-code", 0, {"serve_tok_s", "ttft_p95_ms", "setup_s"}),
    ("glm4-9b.serve-code", 1, {"plan_warmup_s", "engine_host_ms.serve",
                               "prefill_ms.serve", "decode_step_ms.serve",
                               "mfu.serve"}),
    ("hymba-1.5b.train-4k", 0, {"train_tok_s", "setup_s"}),
    ("hymba-1.5b.train-4k", 1, {"plan_warmup_s", "step_ms.train",
                                "mfu.train"}),
    ("glm4-9b.train-fsdp-4chip", 0, {"train_tok_s", "setup_s"}),
    ("glm4-9b.train-fsdp-4chip", 1, {"plan_warmup_s", "step_ms.train",
                                     "collective_ms.train", "mfu.train"})])
def test_cell_prints_one_correct_line(workload, trace, metrics):
    run = subprocess.run(
        [sys.executable, str(SMOKE), "--workload", workload, "--trace",
         str(trace)], capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # the CPU reads no device trace: its per-layer metrics are the rest
    assert set(line["metrics"]) == metrics
    for name, check in line["checks"].items():
        assert f"check {name} " in run.stderr
