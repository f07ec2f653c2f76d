"""Serving CLI: batched prefill+decode with the ServeEngine, with the
kernels on (``use_kernels=True``): attention through the FlashAttention
kernel, the Mamba-2 SSD scan through the SSD chunk-scan kernel.

``--arch`` takes every arch of ``repro_torch.configs.registry``: the dense
GQA decoders, mamba2-130m (ssm), hymba-1.5b (hybrid: both kernels in every
layer), qwen3-moe-30b-a3b and deepseek-v3-671b (MoE; DeepSeek's MLA takes
no kernel, its q and v head dims differ) and seamless-m4t-medium (enc-dec,
fed zero frame embeddings).  Runs on the CUDA card unless ``--device cpu``
is passed (the plain PyTorch path; no kernel).  Examples (full configs on
one H100; deepseek-v3-671b does not fit one card at its 61 layers):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --requests 8 --batch 4 --prompt-len 1024 --cache-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --requests 16 --batch 8 --prompt-len 1024 --cache-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --requests 8 --batch 4 --prompt-len 1536 --cache-len 2048
Reduced config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --smoke --device cpu

``--mesh host`` serves on ``launch/mesh.make_host_mesh()`` (the world's
ranks as ``(data, model)``; one card alone: the one-rank NCCL mesh), the
params placed by ``train_step.state_placements`` (``param_shardings``),
every rank running the same engine
(``ServeEngine(mesh=)``; under ``torchrun`` rank 0 prints), as the JAX
CLI's ``--mesh host`` does.

Plan-cache wiring (the MappingPlan subsystem, ``repro_torch.core.plan``):
``--plan-cache DIR`` points the engine's plan store somewhere explicit
(equivalent to ``REPRO_PLAN_CACHE=DIR``, which the JAX package reads too:
its plans and the port's sit apart by the arch in their keys);
``--plan-bundle PATH`` imports a bundle exported by
``PlanCache.export_bundle`` before the engine starts, so startup warmup
is pure cache hits; ``--no-plan-warmup`` skips the startup warmup sweep;
``--plan-gc`` runs the store's garbage collection (age expiry + LRU
eviction + vacuum) before startup.  The output JSON reports which store
backend served the run (``plan_store``): ``sqlite`` on a healthy host,
``json`` or ``memory`` after degradations (``repro_torch.core.planstore``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import shard_tree
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.train_step import state_placements


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mesh", choices=["none", "host"], default="none")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU fallback")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="mapping-plan store directory "
                         "(default: $REPRO_PLAN_CACHE or ~/.cache/repro-plans)")
    ap.add_argument("--plan-bundle", default=None, metavar="PATH",
                    help="import a plan bundle (PlanCache.export_bundle) "
                         "into the store before starting the engine")
    ap.add_argument("--no-plan-warmup", action="store_true",
                    help="skip the startup plan-warmup sweep")
    ap.add_argument("--plan-gc", action="store_true",
                    help="garbage-collect the plan store (age expiry + "
                         "LRU eviction + vacuum) before starting")
    args = ap.parse_args(argv)

    if args.plan_cache:
        os.environ["REPRO_PLAN_CACHE"] = args.plan_cache
    from repro_torch.core.plan import get_plan_cache
    imported = 0
    gc_out = None
    if args.plan_gc:
        gc_out = get_plan_cache().gc()
    if args.plan_bundle:
        imported = get_plan_cache().import_bundle(args.plan_bundle)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg.with_(use_kernels=True))
    params = model.init(0, device=device)
    mesh = None
    if args.mesh == "host":
        mesh = tmesh.make_host_mesh(device=device)
        params = shard_tree(params, state_placements(model, mesh).params,
                            mesh)
    try:
        return _serve(args, model, params, device, mesh, imported, gc_out)
    finally:
        if mesh is not None:
            tmesh.destroy()


def _serve(args, model, params, device, mesh, imported, gc_out) -> dict:
    from repro_torch.core.plan import get_plan_cache
    cfg = model.cfg

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(model, params, batch_size=args.batch,
                      cache_len=args.cache_len, prompt_len=args.prompt_len,
                      mesh=mesh, plan_warmup=not args.no_plan_warmup)
    t0 = time.time()
    done = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    store = get_plan_cache().store_stats()["store"]
    out = {
        "requests": len(done),
        "completed": sum(r.done or len(r.output) > 0 for r in done),
        "tokens": n_tok,
        "wall_s": round(dt, 2),
        "tok_per_s": round(n_tok / dt, 1),
        "decode_steps": eng.stats["decode_steps"],
        "prefill_calls": eng.stats["prefill_calls"],
        "plan_bundle_imported": imported,
        "plan_warmup_solved": eng.stats.get("plan_warmup_solved", 0),
        "plan_warmup_hits": eng.stats.get("plan_warmup_hits", 0),
        "plan_store": store.get("backend"),
        "plan_store_plans": store.get("plans", 0),
        "plan_gc": gc_out,
    }
    if mesh is None or torch.distributed.get_rank() == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
