"""Gradient compression: per-tensor symmetric int8 quantization with error
feedback (the residual is carried in the optimizer state and added back
next step, preserving convergence).

Port of ``repro/parallel/compression.py``'s single-device half.  Its
``compressed_psum``, the int8 all-reduce over a mesh axis, needs a process
group and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 q, f32 scale) with x ~ q * scale; ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed-then-decompressed gradient, new error feedback)."""
    x = g.to(F32) + err
    q, s = quantize_int8(x)
    dq = dequantize_int8(q, s)
    return dq.to(g.dtype), x - dq
