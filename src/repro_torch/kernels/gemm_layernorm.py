"""Fused GEMM-LayerNorm and GEMM-RMSNorm: the hand-written Hopper kernel's
wrappers.

Port of ``repro/kernels/gemm_layernorm.py`` (the Pallas TPU kernel
``_kernel`` behind ``_fused_gemm_norm``), the paper's GEMM-LayerNorm
compound operation.  The kernel is ``csrc/gemm_epilogue.cu`` (shared with
GEMM-Softmax): a thread-block cluster splits each row of C = A @ B across
its CTAs and all-reduces the row's mean and centred sum of squares (or
its mean square) through distributed shared memory.

Dispatch: tensors on the CPU take the plain versions; tensors on a CUDA
device launch the kernel or raise.  The checks run on both.  There is no
backward, as the JAX package has none.
"""
from __future__ import annotations

import torch

from . import gemm_epilogue as ge
from .ref import gemm_layernorm_ref, gemm_rmsnorm_ref

__all__ = ["gemm_layernorm", "gemm_rmsnorm"]


def gemm_layernorm(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(a @ b) * gamma + beta; a (M, K), b (K, N) f32 or bf16,
    gamma/beta (N,) -> (M, N) in a.dtype.

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_layernorm.launches``; on CPU tensors it returns the plain
    ``gemm_layernorm_ref``."""
    t = ge.check(a, b, gamma, beta)
    if a.device.type == "cpu":
        return gemm_layernorm_ref(a, b, gamma, beta, eps=eps)
    out = ge.launch("layernorm", a, b, gamma, beta, eps, t)
    gemm_layernorm.launches += 1
    return out


def gemm_rmsnorm(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm(a @ b) * gamma; a (M, K), b (K, N) f32 or bf16, gamma (N,)
    -> (M, N) in a.dtype.

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_rmsnorm.launches``; on CPU tensors it returns the plain
    ``gemm_rmsnorm_ref``."""
    t = ge.check(a, b, gamma)
    if a.device.type == "cpu":
        return gemm_rmsnorm_ref(a, b, gamma, eps=eps)
    out = ge.launch("rmsnorm", a, b, gamma, None, eps, t)
    gemm_rmsnorm.launches += 1
    return out


gemm_layernorm.launches = 0
gemm_rmsnorm.launches = 0
