"""Training on one chip: the step of ``train_step.make_train_step`` on the
state of ``init_train_state``, fed batches of the seeded token stream.

Set-up makes the weights from the seed, warms the step's kernel plans
(``launch.train.warmup_kernel_plans``), builds the state and the step
once, and drives them through the first ``check_steps`` steps: the
window's own call on the stream's first batches, which also builds every
kernel.  The program's readings are taken there: each step's loss, each
leaf's first gradient as the optimizer took it (its first moment after
one step over 1 - beta1) and each leaf's change over those steps (against
the weights made again from the seed).  The window then runs the same
state on, a step a batch, until ``--seconds`` have passed, each step's
loss read back as a training loop logs it.

Once the window has closed and the program's state is freed, the float32
reference runs the same steps from the same weights and batches, and
:mod:`compare` holds the readings to the limits.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

import compare
import counts
import harness
from data import TokenStream
from reference.model import strict_f32
from reference.params import (SKETCH, blocks_of, dims, direction, leaves,
                              make_weights, param_specs)
from reference.train import run_steps

STAMP = time.perf_counter


def opt_config(opt: Dict):
    from repro_torch.train.optimizer import OptConfig
    return OptConfig(lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
                     weight_decay=opt["weight_decay"],
                     clip_norm=opt["clip_norm"],
                     warmup_steps=opt["warmup_steps"],
                     total_steps=opt["total_steps"],
                     min_lr_frac=opt["min_lr_frac"])


def feeder(ctx, rows: slice = slice(None)):
    t = ctx.traffic
    stream = TokenStream(ctx.config["vocab_size"], t["seq"], t["batch"],
                         ctx.seed)

    def feed(i: int) -> Dict[str, torch.Tensor]:
        b = stream.batch(i)
        return {k: torch.from_numpy(v[rows]).long().to(ctx.device)
                for k, v in b.items()}
    return feed


def leaf_norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {".".join(p): scale * float(t.float().norm())
            for p, t in leaves(tree)}


def directions(ctx) -> int:
    """The random directions each leaf's first gradient is projected on:
    the mix's ``directions``, else :data:`reference.params.SKETCH`."""
    return ctx.traffic.get("directions", SKETCH)


def program_sketch(tree, cfg: Dict, seed: int, scale: float = 1.0,
                   group=None, n_dir: int = SKETCH
                   ) -> Dict[str, List[float]]:
    """Each leaf of ``tree`` (the whole leaves, or this rank's contiguous
    slices of them over ``group``) projected on the leaf's first ``n_dir``
    random directions (:func:`reference.params.direction`), summed over
    the ranks that hold slices of it."""
    world = 1 if group is None else torch.distributed.get_world_size(group)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    spec = dict(leaves(param_specs(cfg)))
    index = {p: i for i, p in enumerate(spec)}
    names, split, dots = [], [], []
    for p, t in leaves(tree):
        full = spec[p][0]
        n, shape = blocks_of(p, full)
        d = next((i for i, (a, b) in enumerate(zip(full, t.shape))
                  if a != b), None)
        acc = torch.zeros(n_dir, dtype=torch.float32, device=t.device)
        stacked = n > 1 or p[0] == "layers"
        for j in range(t.shape[0] if stacked else 1):
            blk = t[j] if stacked else t
            b = rank * (n // world) + j if stacked and d == 0 else j
            cut = None if d is None or (stacked and d == 0) else \
                (d - 1 if stacked else d)
            for k in range(n_dir):
                u = direction(seed, index[p], b, k, shape, t.device)
                if cut is not None:
                    u = u.chunk(world, cut)[rank]
                acc[k] += torch.dot(u.reshape(-1), blk.float().reshape(-1))
        names.append(".".join(p))
        split.append(d is not None)
        dots.append(acc * scale)
    local = torch.stack(dots)
    summed = local.clone()
    if group is not None:
        torch.distributed.all_reduce(summed, group=group)
    return {n: (a if s else b).tolist()
            for n, s, a, b in zip(names, split, summed, local)}


def change_norms(params, weights) -> Dict[str, float]:
    w = dict(leaves(weights))
    return {".".join(p): float((t.float() - w[p].float()).norm())
            for p, t in leaves(params)}


def shapes(ctx) -> Dict:
    """The hand-written kernels' launch shapes in a step, for the
    roofline readers."""
    t, c = ctx.traffic, ctx.config
    z = dims(c)
    out = {"fa_shape": {"B": t["batch"], "Hq": z["H"], "Hkv": z["Hkv"],
                        "Sq": t["seq"], "Skv": t["seq"], "D": z["hd"],
                        "causal": True, "window": c.get("window")}}
    if c.get("ssm_state"):
        out["ssd_shape"] = {"BH": t["batch"] * z["nh"],
                            "BG": t["batch"] * z["ng"], "S": t["seq"],
                            "P": z["hp"], "N": z["ns"]}
    return out


def run(ctx: harness.Context) -> Dict:
    from repro_torch.launch.train import warmup_kernel_plans
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    t, cfg_d, dev = ctx.traffic, ctx.config, ctx.device
    cuda = dev.type == "cuda"
    opt = t["optimizer"]
    weights = make_weights(cfg_d, ctx.seed, dev)
    model = Model(harness.program_config(cfg_d))
    t_plan = STAMP()
    warmup_kernel_plans(model, t["seq"])
    plan_warmup_s = STAMP() - t_plan
    state = init_train_state(model, weights)
    step = make_train_step(model, opt_config(opt))
    feed = feeder(ctx)

    prog: Dict = {"loss": []}
    for i in range(t["check_steps"]):
        state, metrics = step(state, feed(i))
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norm"] = leaf_norms(state.opt.m,
                                           1.0 / (1.0 - opt["betas"][0]))
            prog["grad_sketch"] = program_sketch(
                state.opt.m, cfg_d, ctx.seed, 1.0 / (1.0 - opt["betas"][0]),
                n_dir=directions(ctx))
    prog["change_norm"] = change_norms(state.params,
                                       make_weights(cfg_d, ctx.seed, dev))
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    setup_s = harness.process_age_s()

    spans = harness.Spans(cuda)
    timed = spans.wrap("step", step) if ctx.trace else step
    spans.on = True
    losses: List[float] = []
    k = t["check_steps"]
    t0 = STAMP()
    while STAMP() - t0 < ctx.seconds:
        state, metrics = timed(state, feed(k))
        losses.append(float(metrics["loss"]))
        k += 1
    window_s = STAMP() - t0
    spans.on = False
    n_steps = len(losses)

    trace = None
    if ctx.trace and cuda:
        def two_steps():
            nonlocal state, k
            for _ in range(2):
                state, _ = step(state, feed(k))
                k += 1
        trace = harness.traced(two_steps)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = harness.Record(
        cell=ctx.cell, config=cfg_d, traffic=t, chips=1, window_s=window_s,
        spans={"step": spans.seconds("step")},
        counters={"plan_warmup_s": plan_warmup_s,
                  "model_flops": n_steps * counts.train_step_flops(
                      cfg_d, t["batch"], t["seq"]), **shapes(ctx)},
        trace=trace)

    # ------------------------------------------------ the check
    t_check = STAMP()
    del state, step, model, weights, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = reference_gaps(ctx, prog)
    checks = [(n, readings["program"][n], ctx.limits[n])
              for n in compare.TRAIN_CHECKS]
    bad = sum(1 for x in losses if not math.isfinite(x))
    checks.append(("nonfinite_losses", float(bad),
                   ctx.limits["nonfinite_losses"]))
    tokens = t["batch"] * t["seq"]
    e2e = {"setup_s": setup_s, "train_tok_s": n_steps * tokens / window_s}
    return {"e2e": e2e, "record": record, "attempted": n_steps,
            "failed": bad, "checks": checks, "memory_peak_bytes": peak,
            "readings": readings,
            "timing": {"setup_s": setup_s, "window_s": window_s,
                       "check_s": STAMP() - t_check}}


def reference_gaps(ctx, prog: Dict) -> Dict:
    """The program's numbers against the float32 reference's steps; with
    ``ctx.control`` also those of the reference in float8 and of the
    reference with half of each batch left out, put in its place."""
    strict_f32()
    t = ctx.traffic
    steps = range(t["check_steps"])
    feed = feeder(ctx)
    batches = [(b["tokens"], b["labels"]) for b in map(feed, steps)]
    def make():
        return make_weights(ctx.config, ctx.seed, ctx.device)
    kw = {"sketch_seed": ctx.seed, "directions": directions(ctx)}
    ref = run_steps(ctx.config, make, batches, t["optimizer"], **kw)
    out = {"program": compare.train_gaps(prog, ref)}
    if ctx.control:
        low = run_steps(ctx.config, make, batches, t["optimizer"],
                        lowp="fp8", **kw)
        out["control"] = compare.train_gaps(low, ref)
        half = [(a[:len(a) // 2], b[:len(b) // 2]) for a, b in batches]
        halved = run_steps(ctx.config, make, half, t["optimizer"], **kw)
        out["half_batch"] = compare.train_gaps(halved, ref)
        out["bf16_reference"] = compare.train_gaps(run_steps(
            ctx.config, make, batches, t["optimizer"], lowp="bf16", **kw),
            ref)
        out["raw"] = {"program": prog, "reference": ref, "control": low,
                      "half_batch": halved}
    return out
