"""End-to-end example: train a ~100M-parameter LM with the full stack —
synthetic pipeline, AdamW, checkpointing/restart, straggler monitor.

Port of ``examples/train_lm.py``: ``lm100m()`` through the port's
``launch/train.train_loop``, with the kernels on (on the card every
layer's attention runs the FlashAttention kernel, in the forward pass and
in its remat recompute).  Runs on the card unless ``--device cpu`` is
passed.  Checkpoints only with ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --steps 3 --batch 2 --seq 32

The last line printed is a JSON object: the losses, the steps run and each
kernel's launches over the run.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train.optimizer import OptConfig

__all__ = ["lm100m", "main"]


def lm100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent CPU fallback")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = Model(lm100m().with_(use_kernels=True))
    print(f"params: {model.n_params()/1e6:.1f}M")
    out = train_loop(
        model, steps=args.steps, batch=args.batch, seq=args.seq,
        opt_cfg=OptConfig(lr=3e-4, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20)),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 5),
        log_every=10, device=device)
    print(f"final loss {out['final_loss']:.4f} in {out['wall_s']:.0f}s "
          f"({out['steps_done']} steps)")
    print(json.dumps({"losses": out["losses"], "steps": out["steps_done"],
                      "device": device.type, "launches": out["launches"]}))
    return out


if __name__ == "__main__":
    main()
