"""Fused GEMM-LayerNorm and GEMM-RMSNorm: the hand-written Hopper kernel's
wrappers.

Port of ``repro/kernels/gemm_layernorm.py`` (the Pallas TPU kernel
``_kernel`` behind ``_fused_gemm_norm``), the paper's GEMM-LayerNorm
compound operation.  The kernel is ``csrc/gemm_epilogue.cu`` (shared with
GEMM-Softmax): a thread-block cluster splits each row of C = A @ B across
its CTAs and all-reduces the row's mean and centred sum of squares (or
its mean square) through distributed shared memory.

The tiling is the COMET plan's (``gemm_epilogue.planned_tiling``), as the
JAX wrappers take their blocks from ``gemm_epilogue_blocks``; ``tiling=``
names one instead (one of ``gemm_epilogue.tilings(N, dtype)``).

Dispatch (``gemm_epilogue.run``, the op ``repro_torch::gemm_epilogue``):
tensors on the CPU take the plain versions; tensors on a CUDA device
launch the kernel at the tiling or raise; fake tensors launch nothing.
The checks run on all of them.  There is no backward, as the JAX package
has none.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import gemm_epilogue as ge

__all__ = ["gemm_layernorm", "gemm_rmsnorm"]


def gemm_layernorm(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, eps: float = 1e-6,
                   tiling: Optional[ge.Tiling] = None) -> torch.Tensor:
    """LayerNorm(a @ b) * gamma + beta; a (M, K), b (K, N) f32 or bf16,
    gamma/beta (N,) -> (M, N) in a.dtype, at ``tiling`` (default the
    plan's).

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_layernorm.launches``; on CPU tensors it returns the plain
    ``gemm_layernorm_ref``.  Either way ``gemm_layernorm.last_tiling`` is
    the call's tiling."""
    t = ge.check(a, b, gamma, beta, tiling=tiling)
    return ge.run("layernorm", a, b, gamma, beta, eps, t)


def gemm_rmsnorm(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, *,
                 eps: float = 1e-6,
                 tiling: Optional[ge.Tiling] = None) -> torch.Tensor:
    """RMSNorm(a @ b) * gamma; a (M, K), b (K, N) f32 or bf16, gamma (N,)
    -> (M, N) in a.dtype, at ``tiling`` (default the plan's).

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_rmsnorm.launches``; on CPU tensors it returns the plain
    ``gemm_rmsnorm_ref``.  Either way ``gemm_rmsnorm.last_tiling`` is the
    call's tiling."""
    t = ge.check(a, b, gamma, tiling=tiling)
    return ge.run("rmsnorm", a, b, gamma, None, eps, t)


gemm_layernorm.launches = 0
gemm_rmsnorm.launches = 0
gemm_layernorm.last_tiling = gemm_rmsnorm.last_tiling = None
ge.COUNTERS["layernorm"] = gemm_layernorm
ge.COUNTERS["rmsnorm"] = gemm_rmsnorm
