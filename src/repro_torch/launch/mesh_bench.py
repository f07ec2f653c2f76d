"""The mesh train step on several ranks, its collectives timed.

    PYTHONPATH=src python -m repro_torch.launch.mesh_bench \\
        [--device cpu] [--smoke] [--json PATH]

starts one rank for each card of the host (4 on the CPU) with ``spawn``;
they meet over ``tcp://localhost:<a free port>`` (NCCL on the card, one
card a rank; gloo on the CPU).  Each rank trains :data:`STEPS` steps
through ``launch/train.train_loop(mesh=...)`` (the planner loss; glm4-9b
at full width and :data:`LAYERS` of its layers, bf16, kernels on, batch
:data:`BATCH` x :data:`SEQ`; ``--smoke``: the f32 smoke config at
:data:`SMOKE_SEQ`) on each mesh of :data:`CASES`, the 4-rank meshes of the
pod and ``seq_shard`` CPU suites (``tests/torch_mesh_ranks.py``) and the
(1, 4) tensor-parallel step they are held against:

- ``pod`` on ``(pod, data, model)`` meshes of (2, 2, 1) and (2, 1, 2): the
  batch over ``(pod, data)``, the gradients All-Reduced over both at
  once;
- ``tp`` and ``seq_shard`` on (1, 4): the same step with and without the
  residual's sequence split over ``model``;
- ``zero1`` and ``fsdp`` on (4, 1): the data-parallel step with ZeRO-1
  moments, and ZeRO-3 (``fsdp``): each layer's weights gathered over the
  data axis inside its remat body, their gradients Reduce-Scattered.

Every collective of steps 1 on is timed (``record_collectives(timed=True)``:
CUDA events around the backend call on the card, the host clock on the
CPU, where a time says nothing of a device).  A span starts when this
rank's stream reaches the call and ends when the collective is done, so it
holds the wait for the last rank to arrive as well as the transfer.  For
each (label, type, bytes, participants) the record gives its count a step
and its ms a step, the least and the most over the ranks: the least is the
rank that arrived last, which waits least, so it is the closest to the
transfer alone; the most holds the skew.  A step's collective ms are given
the same two ways: the sum of the least, and the most of the ranks' sums,
an upper bound.  Each case also gives the most device memory a rank
allocated (``torch.cuda.max_memory_allocated``, least and most over the
ranks; None on the CPU).  Bars, failing the run (exit 1): every rank's losses
equal; each case's step-0 loss within ``LOSS_RTOL`` of the ``tp`` case's
(one batch, one initialisation: the meshes change only the order of the
sums) and finite.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["CASES", "run_rank", "run_all", "main"]

# (name, mesh shape, axis names, config knob)
CASES = (("pod", (2, 2, 1), ("pod", "data", "model"), {}),
         ("pod", (2, 1, 2), ("pod", "data", "model"), {}),
         ("tp", (1, 4), ("data", "model"), {}),
         ("seq_shard", (1, 4), ("data", "model"), {"seq_shard": True}),
         ("zero1", (4, 1), ("data", "model"), {}),
         ("fsdp", (4, 1), ("data", "model"), {"fsdp": True}))
ARCH, LAYERS, BATCH, SEQ, STEPS = "glm4-9b", 4, 4, 1024, 3
SMOKE_SEQ = 16
# bf16 params: the meshes sum the same bf16 products in other orders
LOSS_RTOL = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_case(shape, axes, knob, smoke: bool, device) -> Dict:
    """:data:`STEPS` steps of one case on this rank: the losses, each
    step's ms and this rank's ms a step of each collective of steps 1 on
    (one-rank groups' copies left out)."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.train.optimizer import OptConfig
    cfg = (get_smoke_config(ARCH).with_(dtype="float32") if smoke
           else get_config(ARCH).with_(use_kernels=True, n_layers=LAYERS))
    cfg = cfg.with_(**knob)
    mesh = make_auto_mesh(shape, axes, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with record_collectives(timed=True) as rec:
        out = train_loop(Model(cfg), steps=STEPS, batch=BATCH,
                         seq=SMOKE_SEQ if smoke else SEQ, mesh=mesh,
                         opt_cfg=OptConfig(total_steps=STEPS, warmup_steps=1),
                         use_planner_loss=True, log_every=STEPS,
                         device=device)
    spans = rec.times()
    if len(spans) % STEPS:
        raise RuntimeError(f"{len(spans)} collectives in {STEPS} steps: the "
                           "steps issue different collectives")
    n = STEPS - 1
    counts, per = Counter(), defaultdict(float)
    for r, ms in spans[len(spans) // STEPS:]:
        if r[3] > 1:
            key = f"{r[0]} {r[1]} {int(r[2])}B x{r[3]}"
            counts[key] += 1 / n
            per[key] += ms / n
    del out["state"]
    dist.barrier()
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers,
            "losses": out["losses"], "step_ms": out["step_ms"],
            "mean_step_ms": sum(out["step_ms"][1:]) / n,
            "counts": dict(counts), "ms_per_step": dict(per),
            "peak_bytes": peak}


def run_rank(rank: int, world: int, port: int, out_path: str, smoke: bool,
             device: str):
    """One rank: every case of :data:`CASES`; rank 0 writes every rank's
    records."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        recs = [_one_case(shape, axes, knob, smoke, device)
                for _, shape, axes, knob in CASES]
        gathered: List = [None] * world
        dist.all_gather_object(gathered, recs)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def _merge(by_rank: List[List[Dict]]) -> List[Dict]:
    """Each case's record: rank 0's losses and step times, each
    collective's ms a step least and most over the ranks."""
    out = []
    for i, (name, shape, axes, knob) in enumerate(CASES):
        recs = [r[i] for r in by_rank]
        keys = sorted(recs[0]["ms_per_step"])
        ms = {k: [r["ms_per_step"][k] for r in recs] for k in keys}
        out.append({
            "case": name, "mesh": dict(zip(axes, shape)), "knob": knob,
            "config": recs[0]["config"], "layers": recs[0]["layers"],
            "losses": recs[0]["losses"], "step_ms": recs[0]["step_ms"],
            "mean_step_ms": recs[0]["mean_step_ms"],
            "collectives": {k: {"per_step": recs[0]["counts"][k],
                                "ms_least": min(ms[k]),
                                "ms_most": max(ms[k])} for k in keys},
            "collective_ms_least": sum(min(v) for v in ms.values()),
            "collective_ms_most": max(sum(r["ms_per_step"].values())
                                      for r in recs),
            "peak_bytes_least": None if recs[0]["peak_bytes"] is None
            else min(r["peak_bytes"] for r in recs),
            "peak_bytes_most": None if recs[0]["peak_bytes"] is None
            else max(r["peak_bytes"] for r in recs)})
    return out


def run_all(smoke: bool, device: str) -> Dict:
    """Start a rank for each card (4 on the CPU) by ``spawn``, each running
    every case, and return the cases' records with the bars' verdicts
    (``ok``)."""
    ranks = torch.cuda.device_count() if device == "cuda" else 4
    with tempfile.TemporaryDirectory(prefix="mesh-bench-") as d:
        path = os.path.join(d, "out.json")
        mp.start_processes(run_rank, args=(ranks, _free_port(), path, smoke,
                                           device),
                           nprocs=ranks, start_method="spawn")
        with open(path) as f:
            by_rank = json.load(f)
    cases = _merge(by_rank)
    ref = cases[[c["case"] for c in cases].index("tp")]
    fails = []
    if any([c["losses"] for c in r] != [c["losses"] for c in by_rank[0]]
           for r in by_rank):
        fails.append("the ranks' losses differ")
    for c in cases:
        err = abs(c["losses"][0] / ref["losses"][0] - 1)
        c["step0_rel_err_vs_tp"] = err
        if not err <= LOSS_RTOL:
            fails.append(f"{c['case']} {c['mesh']}: step 0 off by {err}")
    return {"cases": cases, "ranks": ranks, "device": device,
            "ok": not fails, "failures": fails}


def _report(out: Dict) -> None:
    for c in out["cases"]:
        print(f"{c['case']:9s} {c['mesh']}: losses {c['losses']} (step 0 "
              f"rel {c['step0_rel_err_vs_tp']:.2e} of tp's); step "
              f"{c['mean_step_ms']} ms; collectives {c['collective_ms_least']}"
              f" ms a step (least over ranks), {c['collective_ms_most']} "
              f"(most); peak memory a rank {c['peak_bytes_least']} / "
              f"{c['peak_bytes_most']} B")
        for k, v in c["collectives"].items():
            print(f"    {k:60s} {v['per_step']:6.1f}/step "
                  f"{v['ms_least']:9.4f} / {v['ms_most']:9.4f} ms/step")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the f32 smoke config (CPU-runnable)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_bench: no CUDA device", file=sys.stderr)
        return 1
    out = run_all(args.smoke, args.device)
    _report(out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": out["ok"], "failures": out["failures"]}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
