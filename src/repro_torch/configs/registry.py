"""Architecture registry: the 10 assigned archs × their input-shape sets.

Every (arch × shape) pair is a dry-run cell; skips follow the brief:
``long_500k`` only runs for sub-quadratic archs (ssm/hybrid), and is noted
as skipped for the pure full-attention archs in DESIGN.md §5.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke_config",
           "cells_for", "all_cells", "Shape"]

_MODULES = {
    "chameleon-34b": "chameleon_34b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "minitron-4b": "minitron_4b",
    "granite-34b": "granite_34b",
    "glm4-9b": "glm4_9b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS: List[str] = list(_MODULES)


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# archs with sub-quadratic attention (run long_500k); the rest skip it.
_SUBQUADRATIC = {"mamba2-130m", "hymba-1.5b"}


def _mod(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()


def cells_for(arch_id: str) -> List[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in _SUBQUADRATIC:
        names.append("long_500k")
    return names


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in cells_for(a)]
