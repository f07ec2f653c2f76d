"""``torch_measure_fn`` over gloo ranks on the CPU, for
tests/test_torch_calibrate.py; a helper script, not a test file.

    python tests/torch_calibrate_ranks.py WORLD OUT_DIR [fail]

starts WORLD ranks with ``spawn``; they meet through a ``FileStore`` in
OUT_DIR.  Each rank runs the same tiny sweep (``CONFIG``) through
``run_sweep(torch_measure_fn(), WORLD)``, then the checks that must raise
on every rank before any collective (a ``participants`` mismatch, a type
no backend executes) and one more collective after them, and a sweep
whose clock makes rank r's every call last (r + 1) ms.  It writes
``r{rank}.json`` (the points, the buffers' element counts, the errors,
the fake-clock sweep) and ``r{rank}.npz`` (each buffer's last output);
the test holds them to the DV convention and to the collectives' sums
and blocks.  With ``fail``, the last rank's clock raises inside its
second timed window instead, while its peers go on into the collective:
the run must end at once, with that rank's ``CollectiveFailure``, and
not wait out the group's timeout.  Nothing here imports JAX.
"""
import datetime
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.calibrate.harness import (SweepConfig, run_sweep,  # noqa: E402
                                           torch_measure_fn)

#: how long a rank waits in one collective before gloo gives up
RANK_TIMEOUT_S = 60

CONFIG = {"min_bytes": 256, "max_bytes": 16384, "n_sizes": 3, "warmup": 1,
          "iters": 2}


def _fake_clock(rank):
    """A clock under which every timed window of rank r lasts (r + 1) ms:
    the calls alternate between the window's start and end."""
    state = {"calls": 0}

    def clock():
        state["calls"] += 1
        return 0.0 if state["calls"] % 2 else (rank + 1) * 1e-3
    return clock


def _failing_clock(out_dir):
    """A clock that raises at its third call: the start of the second
    timed window, after that call's barrier.  It writes the wall time of
    the failure to ``failed_at`` in ``out_dir`` first."""
    state = {"calls": 0}

    def clock():
        state["calls"] += 1
        if state["calls"] == 3:
            Path(out_dir, "failed_at").write_text(repr(time.time()))
            raise OSError("clock failed")
        return 0.0
    return clock


def _rank(rank, world, out_dir, fail=False):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    if fail:
        clock = _failing_clock(out_dir) if rank == world - 1 else time.perf_counter
        run_sweep(torch_measure_fn(clock=clock), world,
                  config=SweepConfig(**CONFIG))
        raise AssertionError("the sweep went on past a failed collective")
    try:
        cfg = SweepConfig(**CONFIG)
        measure = torch_measure_fn()
        sweep = run_sweep(measure, world, config=cfg)
        errors = []
        for args in (("AllReduce", 4096, world + 1),
                     ("Gather", 4096, world)):
            try:
                measure(*args)
            except ValueError as e:
                errors.append(str(e))
        # a whole sweep at the wrong size: every point dropped, no hang
        bad = run_sweep(measure, world + 1, config=cfg)
        after = measure("AllReduce", 4096, world)
        fake = run_sweep(torch_measure_fn(clock=_fake_clock(rank)), world,
                         config=cfg)
        meta = {
            "points": [p.to_json() for p in sweep.points],
            "dropped": sweep.dropped,
            "buffers": {f"{ct}_{n_in}": [inp.numel(), out.numel()]
                        for (ct, n_in), (inp, out) in measure.buffers.items()},
            "errors": errors,
            "bad_dropped": bad.dropped, "bad_points": len(bad.points),
            "after": after,
            "fake_seconds": [p.seconds for p in fake.points],
        }
        arrays = {f"{ct}_{n_in}": out.numpy()
                  for (ct, n_in), (_, out) in measure.buffers.items()}
        Path(out_dir, f"r{rank}.json").write_text(json.dumps(meta))
        np.savez(Path(out_dir, f"r{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, out = int(sys.argv[1]), sys.argv[2]
    mp.start_processes(_rank, args=(world, out, sys.argv[3:] == ["fail"]),
                       nprocs=world, start_method="spawn")
