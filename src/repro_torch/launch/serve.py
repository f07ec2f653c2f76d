"""Serving CLI: batched prefill+decode with the ServeEngine, attention
through the FlashAttention kernel (``use_kernels=True``).

Runs on the CUDA card unless ``--device cpu`` is passed (the plain PyTorch
path; no kernel).  Example (full glm4-9b on one H100):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --requests 8 --batch 4 --prompt-len 1024 --cache-len 2048
Reduced config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg.with_(use_kernels=True))
    params = model.init(0, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(model, params, batch_size=args.batch,
                      cache_len=args.cache_len, prompt_len=args.prompt_len)
    t0 = time.time()
    done = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    out = {
        "requests": len(done),
        "completed": sum(r.done or len(r.output) > 0 for r in done),
        "tokens": n_tok,
        "wall_s": round(dt, 2),
        "tok_per_s": round(n_tok / dt, 1),
        "decode_steps": eng.stats["decode_steps"],
        "prefill_calls": eng.stats["prefill_calls"],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
