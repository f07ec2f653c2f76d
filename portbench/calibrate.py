"""Read a cell's compared numbers over many seeds in one process, with
the control's and the planted faults' beside them: the readings the
limits in ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--seconds 1]

Each seed runs the cell as ``run.py`` does (set-up, a short window, the
check), the program's set-up warm after the first; one JSON line a seed.
It is not a benchmark run: it is run by hand on the chip when a limit is
set.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--hook", default="",
                    help="module:function planting a fault in the program "
                         "(faults.py) before each run")
    ap.add_argument("--dtype", default="",
                    help="run the program in this dtype instead of the "
                         "configuration's (a witness, not the cell)")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch
    bench = harness.load_benchmark()
    cell, config, traffic = harness.find_cell(bench, args.workload)
    if args.dtype:
        config = dict(config, dtype=args.dtype)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    drv = harness.driver(traffic["driver"])
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        t0 = time.perf_counter()
        if args.hook and traffic["driver"] != "train_mesh" \
                and seed == seeds[0]:
            import importlib
            mod, fn = args.hook.split(":")
            getattr(importlib.import_module(mod), fn)()
        ctx = harness.Context(
            bench=bench, cell=cell, config=config, traffic=traffic,
            seed=seed, seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0),
            limits=harness.load_limits(args.workload),
            control=seed in control, hook=args.hook)
        out = drv.run(ctx)
        print(json.dumps({"seed": seed, "readings": out["readings"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
