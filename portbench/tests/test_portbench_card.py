"""The cells on the card: each cell's run, short, ends correct, and its
control (the reference in float8 in the program's place) reads above one
of the cell's limits.  Run on the card with
``python -m pytest portbench/tests -m cuda``; skipped without one."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [("glm4-9b.serve-code", 1), ("hymba-1.5b.train-4k", 1),
         ("glm4-9b.train-fsdp-4chip", 4)]


def _cards(n):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA device(s)")


def _run(workload, seed, control):
    out = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", "5", "--trace", "0",
         "--control", str(control)], capture_output=True, text=True,
        timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload,chips", CELLS)
def test_cell_is_correct_and_its_control_is_not(workload, chips):
    _cards(chips)
    line = _run(workload, 987654321987, 1)
    assert line["correct"] is True, line["checks"]
    control = line["readings"]["control"]
    limits = {k: v["limit"] for k, v in line["checks"].items()}
    if isinstance(control, dict):
        # the numbers compared (the loss's gap is read, not compared)
        assert any(v > limits[k] for k, v in control.items()
                   if k in limits), (control, limits)
    else:
        assert control > limits["logit_gap"], control
