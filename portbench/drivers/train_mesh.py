"""Training on a mesh of several chips: one process a chip, started here,
each running the step of ``make_train_step(mesh=)`` on its state from
``init_train_state(mesh=)`` over the same global batches.

The ranks meet over ``tcp://localhost:<a free port>`` (NCCL on the card,
gloo on the CPU) on the mesh the traffic file names, with its knobs (the
config's ``fsdp`` for ZeRO-3).  As on one chip, set-up drives the state
through the first ``check_steps`` steps and takes the program's readings
there (each norm summed over the ranks that hold slices of its leaf);
rank 0 decides when the window closes and tells the others each step.
Each rank reports the modules of JAX or of the JAX package it has loaded
once the window has closed, and the run prints no result if one has.
With ``--trace 1`` each rank times its steps and its collectives
(``record_collectives(timed=True)``) and profiles two more steps; the
idle share and collective time are the highest over the ranks, the busy
seconds their mean.

The reference runs over the same ranks, each on its own rows of the
batch, the gradients summed over them (:mod:`reference.train`).  Rank 0
returns the outcome.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Dict, List

import torch

import compare
import counts
import harness
from drivers.train import (directions, feeder, opt_config, program_sketch,
                           shapes)
from reference.model import strict_f32
from reference.params import leaves, make_weights, param_specs
from reference.train import run_steps

STAMP = time.perf_counter
COLLECTIVES = ("params/", "grads/")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx: harness.Context) -> Dict:
    world = ctx.cell["chips"]
    port = _free_port()
    started = time.time() - harness.process_age_s()
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=_rank, args=(r, world, port, ctx, started,
                                            queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Dict] = {}
    errors: List[str] = []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, out, err = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in got]
                if dead:
                    errors.append(f"ranks {dead} ended without a result")
                    break
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return _merge(ctx, [got[r] for r in range(world)])


def _merge(ctx, outs: List[Dict]) -> Dict:
    out = outs[0]
    rec = out["record"]
    traces = [o["record"].trace for o in outs]
    if all(t is not None for t in traces):
        rec.trace.busy_s = sum(t.busy_s for t in traces) / len(traces)
        rec.counters["idle_pct"] = max(
            100.0 * (1 - t.busy_s / t.window_s) for t in traces)
    coll = [o["record"].counters.get("collective_ms") for o in outs]
    if all(c is not None for c in coll):
        rec.counters["collective_ms"] = max(coll)
    out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    out["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
    return out


def _rank(rank, world, port, ctx, started, queue) -> None:
    try:
        queue.put((rank, _train(rank, world, port, ctx, started), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _sum_norms(tree, full: Dict, group, scale: float = 1.0,
               minus=None) -> Dict[str, float]:
    """Each leaf's norm where ranks hold slices of it: squares summed over
    the ranks for a leaf smaller here than whole, counted once for a leaf
    every rank holds whole.  With ``minus`` (a function of the leaf's path
    and local tensor) the norm of the difference."""
    import torch.distributed as dist
    paths, split, sq = [], [], []
    for p, t in leaves(tree):
        d = t.float() if minus is None else t.float() - minus(p, t)
        paths.append(".".join(p))
        split.append(t.numel() < math.prod(full[p][0]))
        sq.append(torch.sum(d * d))
    sq = torch.stack(sq)
    summed = sq.clone()
    dist.all_reduce(summed, group=group)
    return {n: scale * math.sqrt(float(a if s else b))
            for n, s, a, b in zip(paths, split, summed, sq)}


def _slice_of(full_t: torch.Tensor, local: torch.Tensor, world: int,
              rank: int) -> torch.Tensor:
    """This rank's contiguous block of ``full_t`` along the one dim where
    ``local`` is smaller (the whole tensor where it is not)."""
    for d, (a, b) in enumerate(zip(full_t.shape, local.shape)):
        if a != b:
            return full_t.chunk(world, d)[rank]
    return full_t


def _train(rank, world, port, ctx, started) -> Dict:
    harness.prepare_environment()
    if ctx.hook:
        import importlib
        mod, fn = ctx.hook.split(":")
        getattr(importlib.import_module(mod), fn)()
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    ctx = dataclasses.replace(ctx, device=dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        return _steps(rank, world, ctx, started, make_auto_mesh, Model,
                      record_collectives, init_train_state, make_train_step)
    finally:
        dist.destroy_process_group()


def _steps(rank, world, ctx, started, make_auto_mesh, Model,
           record_collectives, init_train_state, make_train_step) -> Dict:
    import torch.distributed as dist
    t, dev = ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    cfg_d = {**ctx.config, **t.get("knobs", {})}
    opt = t["optimizer"]
    full = dict(leaves(param_specs(cfg_d)))
    mesh = make_auto_mesh(t["mesh"], t["axes"], dev)
    group = dist.group.WORLD
    model = Model(harness.program_config(cfg_d))
    from repro_torch.launch.train import warmup_kernel_plans
    t_plan = STAMP()
    warmup_kernel_plans(model, t["seq"])
    plan_warmup_s = STAMP() - t_plan
    weights = make_weights(cfg_d, ctx.seed, dev)
    state = init_train_state(model, weights, mesh)
    del weights
    gc.collect()
    step = make_train_step(model, opt_config(opt), mesh)
    feed = feeder(ctx)

    prog: Dict = {"loss": []}
    for i in range(t["check_steps"]):
        state, metrics = step(state, feed(i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norm"] = _sum_norms(state.opt.m, full, group,
                                           1.0 / (1.0 - opt["betas"][0]))
            prog["grad_sketch"] = program_sketch(
                state.opt.m, cfg_d, ctx.seed, 1.0 / (1.0 - opt["betas"][0]),
                group, directions(ctx))
    w0 = dict(leaves(make_weights(cfg_d, ctx.seed, dev)))
    prog["change_norm"] = _sum_norms(
        state.params, full, group,
        minus=lambda p, x: _slice_of(w0[p], x, world, rank).float())
    del w0
    gc.collect()
    dist.barrier()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - started

    spans = harness.Spans(cuda)
    timed = spans.wrap("step", step) if ctx.trace else step
    go = torch.ones((), device=dev)
    losses: List[float] = []
    k = t["check_steps"]
    with record_collectives(timed=ctx.trace) as rec:
        spans.on = True
        t0 = STAMP()
        while True:
            go.fill_(float(STAMP() - t0 < ctx.seconds))
            dist.broadcast(go, 0)
            if not go.item():
                break
            state, metrics = timed(state, feed(k))
            losses.append(float(metrics["loss"]))
            k += 1
        window_s = STAMP() - t0
        spans.on = False
    n_steps = len(losses)
    coll_ms = None
    if ctx.trace and n_steps:
        coll_ms = sum(ms for r, ms in rec.times()
                      if r[0].startswith(COLLECTIVES) and r[3] > 1) / n_steps

    trace = None
    if ctx.trace and cuda:
        def two_steps():
            nonlocal state, k
            for _ in range(2):
                state, _ = step(state, feed(k))
                k += 1
        trace = harness.traced(two_steps)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tokens = t["batch"] * t["seq"]
    record = harness.Record(
        cell=ctx.cell, config=cfg_d, traffic=t, chips=world,
        window_s=window_s, spans={"step": spans.seconds("step")},
        counters={"plan_warmup_s": plan_warmup_s, "collective_ms": coll_ms,
                  "model_flops": n_steps * counts.train_step_flops(
                      cfg_d, t["batch"], t["seq"]),
                  **shapes(dataclasses.replace(
                      ctx, traffic={**t, "batch": t["batch"] // world}))},
        trace=trace)

    # ------------------------------------------------ the check
    t_check = STAMP()
    del state, step, model, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = _reference(ctx, prog, rank, world, group)
    checks = [(n, readings["program"][n], ctx.limits[n])
              for n in compare.TRAIN_CHECKS]
    bad = sum(1 for x in losses if not math.isfinite(x))
    checks.append(("nonfinite_losses", float(bad),
                   ctx.limits["nonfinite_losses"]))
    return {"e2e": {"setup_s": setup_s,
                    "train_tok_s": n_steps * tokens / window_s},
            "record": record, "attempted": n_steps, "failed": bad,
            "checks": checks, "memory_peak_bytes": peak,
            "readings": readings,
            "device_kind": torch.cuda.get_device_name(dev) if cuda
            else "cpu",
            # what this rank loaded of JAX or the JAX package, once the
            # window has closed: the process that prints sees only its own
            "forbidden": harness.forbidden_modules(),
            "timing": {"setup_s": setup_s, "window_s": window_s,
                       "check_s": STAMP() - t_check}}


def _reference(ctx, prog, rank, world, group) -> Dict:
    """The program's numbers against the float32 reference over the
    ranks, each on its rows; with ``ctx.control`` also those of the
    reference in float8 and with half of each batch left out, put in its
    place."""
    strict_f32()
    t = ctx.traffic
    b = t["batch"] // world
    rows = slice(rank * b, (rank + 1) * b)
    feed = feeder(ctx)
    batches = [(x["tokens"][rows], x["labels"][rows])
               for x in map(feed, range(t["check_steps"]))]

    def make():
        return make_weights(ctx.config, ctx.seed, ctx.device)
    kw = {"group": group, "rows_total": t["batch"],
          "sketch_seed": ctx.seed, "directions": directions(ctx)}
    ref = run_steps(ctx.config, make, batches, t["optimizer"], **kw)
    out = {"program": compare.train_gaps(prog, ref)}
    if ctx.control:
        out["control"] = compare.train_gaps(run_steps(
            ctx.config, make, batches, t["optimizer"], lowp="fp8", **kw), ref)
        half = [(a[:max(1, b // 2)], c[:max(1, b // 2)]) for a, c in batches]
        out["half_batch"] = compare.train_gaps(run_steps(
            ctx.config, make, half, t["optimizer"], **{
                **kw, "rows_total": world * max(1, b // 2)}), ref)
    return out
