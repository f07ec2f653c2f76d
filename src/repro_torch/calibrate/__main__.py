"""CLI: ``python -m repro_torch.calibrate [--backend nccl|gloo|synthetic]``.

Runs one calibration pass (sweep -> fit -> gate -> persist) and prints a
summary.  The port's counterpart of ``python -m repro.calibrate``:

* ``--backend nccl`` (the default) times real NCCL collectives over the
  cards: one rank per visible card, started here with ``spawn``; or the
  world group when ``torch.distributed`` is initialised already, or is
  to be from ``torchrun``'s environment.  Without a CUDA device it
  raises; it never drops to gloo.  On one card the group has one rank,
  every point is excluded from the fit, the fit is degenerate, nothing
  is persisted and the exit status is 2, as the JAX CLI's on one device;
* ``--backend gloo --ranks N`` (default 8) times gloo collectives over N
  CPU ranks, the counterpart of the JAX CLI's forced 8-device CPU mesh;
* ``--backend synthetic`` generates timings from the reference preset's
  own NoC constants (optionally jittered), touching no process group.

On a group of ranks, rank 0 decides once whether a persisted calibration
is reused, every rank runs the same sweep in lock step
(``harness.torch_measure_fn``), and rank 0 alone fits, gates and
persists; one process prints the summary.

The persisted ``calibrated_noc.json`` lands in the plan-store root
(``$REPRO_PLAN_CACHE`` / ``~/.cache/repro-plans``, or ``--store``).
Re-running with matching provenance reuses it: ``fits_solved: 0``, file
untouched, bit-identical store.  Exit status: 0 on a passing gate,
1 when the fitted model misses its own sweep by more than
``--gate-median``, 2 when the sweep degrades to a degenerate fit, and 3,
with no summary, when a rank of the nccl or gloo group failed (a
collective that raised past its checks ends the run rather than leave
the ranks out of lock step).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

from repro_torch.core.hardware import PRESETS

from .driver import calibrate_group, calibrate_once, spawn_group
from .harness import (CollectiveFailure, SweepConfig, _replace_mesh,
                      synthetic_measure_fn)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="Measure collectives, fit NoCParams, persist with "
                    "provenance")
    ap.add_argument("--backend", choices=("nccl", "gloo", "synthetic"),
                    default="nccl",
                    help="nccl: time NCCL collectives over the cards (one "
                         "rank a card); gloo: over --ranks CPU ranks; "
                         "synthetic: analytic generator from the reference "
                         "preset (no process group)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="gloo backend: CPU ranks to start")
    ap.add_argument("--arch", choices=sorted(PRESETS), default="tpu_v5e",
                    help="preset whose cluster NoC seeds the fit's "
                         "reference (channel width, enqueue split)")
    ap.add_argument("--store", default=None,
                    help="store root (default: plan-store resolution)")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep even when a matching calibration exists")
    ap.add_argument("--min-bytes", type=int, default=None)
    ap.add_argument("--max-bytes", type=int, default=None)
    ap.add_argument("--sizes", type=int, default=None,
                    help="log-spaced sizes per collective type")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="synthetic backend: multiplicative noise bound")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate-median", type=float, default=0.6,
                    help="max median |relative error| of the fitted model "
                         "on its own sweep")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as one JSON document")
    return ap


def _config(args) -> Optional[SweepConfig]:
    kw = {k: v for k, v in (("min_bytes", args.min_bytes),
                            ("max_bytes", args.max_bytes),
                            ("n_sizes", args.sizes),
                            ("iters", args.iters),
                            ("warmup", args.warmup)) if v is not None}
    return SweepConfig(**kw) if kw else None


def _group_summary(args) -> Optional[Dict]:
    """The nccl / gloo backends: calibrate over the world group if this
    process is in one (or ``torchrun`` set one up), else over ranks
    spawned here.  ``None`` on a rank other than 0 of an existing
    group."""
    import torch
    import torch.distributed as dist

    if args.backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("--backend nccl needs a CUDA device; on the CPU "
                           "use --backend gloo or --backend synthetic")
    if not dist.is_initialized() and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        dist.init_process_group(args.backend)
        if args.backend == "nccl":
            torch.cuda.set_device(dist.get_rank()
                                  % torch.cuda.device_count())
    kwargs = {"reference": PRESETS[args.arch]().cluster_noc,
              "store": args.store, "force": args.force,
              "config": _config(args), "gate_median": args.gate_median}
    if dist.is_initialized():
        return calibrate_group(backend=args.backend, **kwargs)
    world = (torch.cuda.device_count() if args.backend == "nccl"
             else args.ranks)
    return spawn_group(world, args.backend, **kwargs)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.backend == "synthetic":
        reference = _replace_mesh(PRESETS[args.arch]().cluster_noc, (1, 8))
        summary = calibrate_once(
            synthetic_measure_fn(reference, jitter=args.jitter,
                                 seed=args.seed),
            reference, [2, 4, 8], backend="synthetic",
            torch_version="synthetic", store=args.store, force=args.force,
            config=_config(args), gate_median=args.gate_median)
    else:
        from torch.multiprocessing import (ProcessExitedException,
                                           ProcessRaisedException)
        try:
            summary = _group_summary(args)
        except (CollectiveFailure, ProcessExitedException,
                ProcessRaisedException) as e:
            print(f"calibration run failed on a rank: {e}", file=sys.stderr)
            return 3
        if summary is None:
            return 0

    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        p = summary["params"]
        print(f"backend={summary['backend']} reused={summary['reused']} "
              f"fits_solved={summary['fits_solved']}")
        print(f"points={summary['n_points']} "
              f"dropped={summary.get('n_dropped', 0)} "
              f"degenerate={summary['degenerate']}")
        print(f"fitted: channel_bandwidth={p['channel_bandwidth']:.4g} B/s  "
              f"t_router={p['t_router']:.4g} s  t_enq={p['t_enq']:.4g} s")
        print(f"rel err: median={summary['median_rel_err']:.3f} "
              f"max={summary['max_rel_err']:.3f} "
              f"(gate median<={summary['gate_median']}) "
              f"-> {'OK' if summary['gate_ok'] else 'FAIL'}")
        print(f"store: {summary['path']}")

    if summary["degenerate"]:
        return 2
    return 0 if summary["gate_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
