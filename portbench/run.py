"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names its configuration and traffic mix; the mix names its
driver (``drivers/<driver>.py``).  With ``--trace 0`` the result's
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones, read from the harness's spans and a profiled stretch after the
window.  The last line of standard output is the result; the numbers that
decide ``correct`` are the last lines of standard error and the result's
last key.  The run fails, and prints no result, without as many CUDA
devices as the cell asks for, or if a module of JAX or of the JAX package
was loaded, here or in a process the driver started.

``--control 1`` (never the benchmark's own runs) also reads the numbers
of the reference in a lower precision and of the planted faults, for
setting the limits.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(bench, ctx, out, chips: int, device_kind: str) -> dict:
    if ctx.trace:
        metrics = harness.read_per_layer(bench, out["record"])
    else:
        names = [m for m in harness.cell_metrics(bench, ctx.cell["name"],
                                                 "end_to_end")]
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in names}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": device_kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": all(v <= lim for _, v, lim in out["checks"]),
           "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": device}
    trace = out["record"].trace
    if ctx.trace and trace is not None:
        device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
        res["breakdown"] = trace.breakdown()
    if ctx.control:
        res["readings"] = out["readings"]
    return res


def main(argv=None) -> int:
    args = parse(argv)
    harness.prepare_environment()
    bench = harness.load_benchmark()
    cell, config, traffic = harness.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = harness.Context(
        bench=bench, cell=cell, config=config, traffic=traffic,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0),
        limits=harness.load_limits(args.workload),
        control=bool(args.control))
    out = harness.driver(traffic["driver"]).run(ctx)
    found = harness.forbidden_loaded(out)
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    res = result(bench, ctx, out, cell["chips"],
                 out.get("device_kind") or torch.cuda.get_device_name(0))
    print("timing " + " ".join(f"{k} {v!r}" for k, v in out["timing"].items()),
          file=sys.stderr)
    harness.emit(res, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
