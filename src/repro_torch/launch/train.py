"""End-to-end training driver.

Wires together: a model of the zoo (--arch, reduced or full config), the
synthetic data pipeline, the train step (optional microbatch
accumulation, int8 gradient compression), async checkpointing with keep-k
retention, exact restart from the latest checkpoint, and straggler
monitoring.  Port of ``repro/launch/train.py`` with the same flags, and
``--device`` (``cuda`` unless ``cpu`` is passed; no fallback).  The model
runs with ``use_kernels=True``: on the card every layer's attention goes
through the FlashAttention kernel and every SSD scan through the SSD
kernel, each under autograd with its plain recompute backward.
``--mesh host`` trains any arch on
``launch/mesh.make_host_mesh(--model-parallel)`` (every rank of the world
group; one card: a ``(1, 1)`` NCCL mesh) and
``--mesh production``/``production-multi`` on ``make_production_mesh``
(256 ranks, or 512 over ``(pod, data, model)``, the gradients reduced
over ``(pod, data)`` as one group): the params placed by ``param_shardings``, the moments
by ``zero1_shardings``, every family tensor-parallel and the MoE layers
expert-parallel over ``model`` (``train/train_step.py``), checkpoints gathered and written by rank 0 and
restored onto the mesh's placements; ``--planner-loss`` takes the
COMET-planned explicit-collective loss over the vocab-sharded unembed.
A model whose config sets ``fsdp`` runs the ZeRO-3 step on a mesh: the
params at their ZeRO-1 slices (``train_step.state_placements``), each
layer's weights gathered over the data axes inside its remat body and
their gradients Reduce-Scattered.  The JAX loop always places the params
at ``param_shardings``; its ZeRO-3 step is the one GSPMD compiles from
``state_specs``' shardings.  The numbers are the same either way.

Example (CPU, reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --smoke --device cpu --steps 5
On one H100 (full mamba2-130m):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 6 --batch 8 --seq 1024
With the planner loss on the host mesh (one card: a one-rank NCCL mesh;
glm4-9b's full width fits at 4 of its 40 layers):
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --layers 4 --steps 3 --batch 4 --seq 1024 --mesh host --planner-loss

The last line printed is a JSON object: the final loss, the wall seconds,
the steps run, tokens per second and each kernel's launches over the run.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ssd import ssd_scan_fwd
from repro_torch.launch.mesh import (destroy, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)
from repro_torch.train.data import SyntheticLM
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state,
                                          make_train_step, state_placements)

__all__ = ["warmup_kernel_plans", "train_loop", "main"]

# the kernels a training step launches, by name: their wrappers' counters
KERNEL_COUNTERS = {"flash_attention": flash_attention_fwd,
                   "ssd_scan": ssd_scan_fwd}


def warmup_kernel_plans(model: Model, seq: int) -> Dict[str, int]:
    """Pre-solve the COMET block-selection plans the training step's
    kernels will ask for (attention blocks at the training sequence
    length, SSD chunk lengths) through the shared PlanCache, so the first
    step hits the store instead of searching."""
    from repro_torch.core.plan import get_plan_cache
    from repro_torch.kernels.autotune import plan_jobs

    cfg = model.cfg
    shapes: Dict[str, Any] = {}
    if not cfg.has_ssm or cfg.family == "hybrid":
        shapes["attention_blocks"] = [(seq, seq, cfg.hd)]
    if cfg.has_ssm:
        shapes["ssd_chunk_len"] = [(seq, cfg.ssm_headdim, cfg.ssm_state)]
    return get_plan_cache().warmup(plan_jobs(shapes),
                                   sweep_id="train-warmup")


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; token ids as int64."""
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind in "iu" else None)
        for k, v in batch.items()}


def train_loop(model: Model, *, steps: int, batch: int, seq: int,
               mesh=None, opt_cfg: Optional[OptConfig] = None,
               microbatches: int = 1, use_planner_loss: bool = False,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               keep: int = 3, seed: int = 0,
               log_every: int = 10,
               warmup_plans: bool = False,
               device=None) -> Dict[str, Any]:
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    if there is one).  Returns the losses, the final loss, the wall
    seconds, the straggler events, the steps run, each step's time in ms
    (CUDA events on the card, the host clock on the CPU), tokens per
    second, each kernel's launches over the run and the final state."""
    dev = resolve_device(device)
    cfg = model.cfg
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    if warmup_plans:
        from repro_torch.core.plan import get_plan_cache
        ws = warmup_kernel_plans(model, seq)
        store = get_plan_cache().store_stats()["store"]
        print(f"[train] plan warmup: {ws['solved']} solved, "
              f"{ws['hits']} already cached "
              f"(store: {store.get('backend')}, "
              f"{store.get('plans', 0)} plans)")
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                       encdec=cfg.is_encdec, d_model=cfg.d_model,
                       enc_ratio=cfg.enc_ratio)

    step_fn = make_train_step(model, opt_cfg, mesh, microbatches=microbatches,
                              use_planner_loss=use_planner_loss)
    # on a mesh: the params and the moments by state_placements
    state = init_train_state(model, model.init(seed, device=dev), mesh,
                             compression=opt_cfg.grad_compression)
    placed = (state_placements(model, mesh,
                               compression=opt_cfg.grad_compression)
              if mesh is not None else None)

    start_step = 0
    ckptr = None
    if ckpt_dir:
        ckptr = AsyncCheckpointer(ckpt_dir, keep=keep, placements=placed,
                                  mesh=mesh)
        if latest_step(ckpt_dir) is not None:
            state, start_step, extra = restore_checkpoint(
                ckpt_dir, state, shardings=placed, mesh=mesh)
            print(f"[train] restored step {start_step} from {ckpt_dir}")

    mon = StragglerMonitor()
    losses: List[float] = []
    step_ms: List[float] = []
    launched = {k: fn.launches for k, fn in KERNEL_COUNTERS.items()}
    cuda = dev.type == "cuda"
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            b = _to_device(data.batch(step), dev)
            mon.start()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            if cuda:
                ev[1].record()
            loss = float(metrics["loss"])        # waits for the step
            step_ms.append(ev[0].elapsed_time(ev[1]) if cuda
                           else 1e3 * (time.perf_counter() - t0))
            straggler = mon.stop(step)
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"lr {float(metrics['lr']):.2e}"
                      + (" STRAGGLER" if straggler else ""), flush=True)
            if ckptr and (step + 1) % ckpt_every == 0:
                ckptr.save(step + 1, state)
        if ckptr:
            ckptr.save(steps, state)
    finally:
        if ckptr:
            ckptr.wait()
    if ckptr and ckptr.errors:
        raise RuntimeError(f"checkpoint errors: {ckptr.errors}")
    wall = time.time() - t_start
    done = steps - start_step
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "wall_s": wall, "straggler_events": mon.events,
            "steps_done": done, "step_ms": step_ms,
            "tokens_per_s": done * batch * seq / wall if done else 0.0,
            "launches": {k: fn.launches - launched[k]
                         for k, fn in KERNEL_COUNTERS.items()},
            "state": state}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep this many layers of the config (a depth cut "
                         "at full width, e.g. to fit one card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--planner-loss", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["none", "host", "production",
                                       "production-multi"], default="none")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="--mesh host: the model axis's width (the largest "
                         "divisor of the world size not above it)")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="mapping-plan store directory "
                         "(default: $REPRO_PLAN_CACHE or ~/.cache/repro-plans)")
    ap.add_argument("--warmup-plans", action="store_true",
                    help="pre-solve kernel block-selection plans at startup")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args(argv)

    if args.plan_cache:
        os.environ["REPRO_PLAN_CACHE"] = args.plan_cache
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    model = Model(cfg.with_(use_kernels=True))
    mesh = None
    try:
        if args.mesh == "host":
            mesh = make_host_mesh(args.model_parallel, device=device)
        elif args.mesh.startswith("production"):
            mesh = make_production_mesh(
                multi_pod=args.mesh == "production-multi", device=device)
        out = train_loop(
            model, steps=args.steps, batch=args.batch, seq=args.seq,
            mesh=mesh,
            opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10),
                              grad_compression=args.grad_compression),
            microbatches=args.microbatches,
            use_planner_loss=args.planner_loss,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            warmup_plans=args.warmup_plans, device=device)
    finally:
        if args.mesh != "none":
            destroy()
    print(json.dumps({"final_loss": out["final_loss"],
                      "wall_s": round(out["wall_s"], 1),
                      "steps": out["steps_done"],
                      "tokens_per_s": out["tokens_per_s"],
                      "launches": out["launches"]}))
    return out


if __name__ == "__main__":
    main()
