"""Cells of the benchmark at a size a CPU test can hold: the cell's own
driver, traffic and checks on a configuration cut to two layers and a
small width, in float32, where the program and the reference agree to
round-off."""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import harness  # noqa: E402

SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 128, "vocab_size": 512, "dtype": "float32"}
CONFIGS = {"glm4-9b": {"n_layers": 4},
           "hymba-1.5b": {"n_heads": 4, "n_kv_heads": 2, "window": 16,
                          "ssm_state": 16, "ssm_headdim": 16}}
TRAFFIC = {"serve": {"slots": 2, "submission": 4, "prompt_min": 8,
                     "prompt_max": 32, "prompt_len": 32, "new_tokens": 4,
                     "cache_len": 48, "warmup_requests": 3,
                     "warmup_new_tokens": 1, "check_requests": 3},
           "train": {"batch": 2, "seq": 64},
           "train_mesh": {"batch": 8, "seq": 64}}


def context(workload: str, seed: int = 1234567891234, control=False,
            trace=False):
    """The cell ``workload`` cut to the CPU's size, on the CPU."""
    import torch
    harness.prepare_environment()
    bench = harness.load_benchmark()
    cell, config, traffic = harness.find_cell(bench, workload)
    config = {**config, **SMALL, **CONFIGS[cell["config"]]}
    traffic = {**traffic, **TRAFFIC[traffic["driver"]]}
    return harness.Context(
        bench=bench, cell=cell, config=config, traffic=traffic, seed=seed,
        seconds=0.01, trace=trace, device=torch.device("cpu"),
        limits=harness.load_limits(workload), control=control)


def run(ctx):
    return harness.driver(ctx.traffic["driver"]).run(ctx)


def main(argv=None) -> int:
    """Run a cell at the CPU's size and print its result line as
    ``run.py`` does; exit 3 if a module of JAX or of the JAX package was
    loaded here or in a process the driver started."""
    import argparse
    import run as runner
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--hook", default="",
                    help="module:function called first in each process a "
                         "mesh driver starts")
    args = ap.parse_args(argv)
    ctx = context(args.workload, trace=bool(args.trace))
    ctx.hook = args.hook
    out = run(ctx)
    found = harness.forbidden_loaded(out)
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(runner.result(ctx.bench, ctx, out, 1, "cpu"), out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
