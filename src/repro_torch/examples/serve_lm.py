"""Serve a small model with batched requests through the continuous-batching
engine (prefill + fixed-shape decode steps, slot reuse).

Port of ``examples/serve_lm.py``: the port's ``ServeEngine`` on a smoke
config, random weights from a ``torch.Generator`` seeded 0, prompts from
numpy's generator seeded 0.  Runs on the card unless ``--device cpu`` is
passed; ``--use-kernels`` (on by default on the card, off on the CPU)
sends every prefill's attention through the FlashAttention kernel and
every SSD scan through the SSD kernel.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 16
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The last line printed is a JSON object: requests, tokens, decode steps,
prefill calls and each kernel's launches over the run.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ssd import ssd_scan_fwd
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["make_requests", "run", "main"]

KERNEL_COUNTERS = {"flash_attention": flash_attention_fwd,
                   "ssd_scan": ssd_scan_fwd}
PROMPT_LEN, CACHE_LEN, ENGINE_PROMPT_LEN = 24, 96, 32


def make_requests(vocab: int, n: int, max_new: int) -> List[Request]:
    """``n`` requests of 24 prompt tokens from numpy's generator seeded 0,
    as the original example makes them."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, PROMPT_LEN).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def run(model: Model, params, *, requests: int, batch: int,
        max_new: int) -> Dict:
    """Serve ``requests`` requests through a ``batch``-slot engine; prints
    the original example's two lines and returns the finished requests,
    the engine's stats and each kernel's launches over the run."""
    reqs = make_requests(model.cfg.vocab_size, requests, max_new)
    eng = ServeEngine(model, params, batch_size=batch, cache_len=CACHE_LEN,
                      prompt_len=ENGINE_PROMPT_LEN)
    before = {k: f.launches for k, f in KERNEL_COUNTERS.items()}
    t0 = time.time()
    done = eng.run(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    n = sum(len(r.output) for r in done)
    print(f"{len(done)} requests, {n} tokens in {dt:.1f}s "
          f"({n/dt:.1f} tok/s, {eng.stats['decode_steps']} decode steps, "
          f"{eng.stats['prefill_calls']} prefill)")
    print("sample output:", done[0].output)
    return {"done": done, "tokens": n, "wall_s": dt, "stats": eng.stats,
            "launches": {k: f.launches - before[k]
                         for k, f in KERNEL_COUNTERS.items()}}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU fallback")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run the kernels (default: on for cuda, off for cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    use_kernels = (device.type == "cuda" if args.use_kernels is None
                   else args.use_kernels)
    model = Model(get_smoke_config(args.arch).with_(use_kernels=use_kernels))
    params = model.init(0, device=device)
    out = run(model, params, requests=args.requests, batch=args.batch,
              max_new=args.max_new)
    print(json.dumps({"requests": len(out["done"]), "tokens": out["tokens"],
                      "decode_steps": out["stats"]["decode_steps"],
                      "prefill_calls": out["stats"]["prefill_calls"],
                      "device": device.type, "use_kernels": use_kernels,
                      "launches": out["launches"]}))
    return out


if __name__ == "__main__":
    main()
