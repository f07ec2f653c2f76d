"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven at the CPU's
size, once for each fault a cell can have (``faults.py``; on a mesh each
rank's process plants it through the run's hook)."""
import functools

import pytest

import smoke
import faults  # noqa: E402  (smoke puts the benchmark's folder on the path)


@pytest.mark.parametrize("workload,fault", [
    ("glm4-9b.serve-code", "alter_tokens"),
    ("hymba-1.5b.train-4k", "state_unchanged"),
    ("hymba-1.5b.train-4k", "half_batch"),
    ("glm4-9b.train-fsdp-4chip", "state_unchanged"),
    ("glm4-9b.train-fsdp-4chip", "no_exchange")])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    ctx = smoke.context(workload)
    if ctx.traffic["driver"] == "train_mesh":
        ctx.hook = f"faults:{fault}"
    else:
        getattr(faults, fault)(functools.partial(monkeypatch.setattr))
    out = smoke.run(ctx)
    failed = [n for n, v, lim in out["checks"] if not v <= lim]
    assert failed, out["checks"]
