"""Gradient compression for cross-pod reduction.

Two pieces, ports of ``repro/parallel/compression.py``:

* :func:`quantize_int8` / :func:`dequantize_int8` — per-tensor symmetric
  int8 quantization with error feedback (the residual is carried in the
  optimizer state and added back next step, preserving convergence).
* :func:`compressed_psum` — the all-reduce of an int8-quantized payload
  (int32 accumulation, shared MAX scale) over one mesh axis's process
  group: the transport pattern a real cross-pod int8 gradient all-reduce
  uses (4–8× volume reduction on the slow hop).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

F32 = torch.float32

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback",
           "compressed_psum"]


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 q, f32 scale) with x ~ q * scale; ``torch.round`` rounds
    half to even, as ``jnp.round`` does.  ``amax`` is the largest |x| of
    the whole tensor when ``x`` is one shard of it (default: x's own)."""
    if amax is None:
        amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor, *,
                           amax: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed-then-decompressed gradient, new error feedback);
    ``amax`` as in :func:`quantize_int8`."""
    x = g.to(F32) + err
    q, s = quantize_int8(x, amax)
    dq = dequantize_int8(q, s)
    return dq.to(g.dtype), x - dq


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-reduce ``x`` over the mesh axis ``axis`` with an int8 payload
    (int32 accumulate, shared scale from a MAX all-reduce), called on every
    rank of ``mesh`` with its replica of ``x``; returns f32.  Both
    collectives go through ``collective_planner.collective``."""
    from .collective_planner import collective
    group = mesh.get_group(axis)
    amax = torch.clamp(x.abs().max().to(F32), min=1e-12)
    scale = collective("AllReduce", "compressed/scale", amax, group,
                       op=dist.ReduceOp.MAX) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    acc = collective("AllReduce", "compressed/payload", q, group)
    return acc.to(F32) * scale
