"""Entry points for the port's kernels.

``mha`` (FlashAttention) and ``ssd`` (the Mamba-2 SSD chunk scan), which
the model code calls, and the paper's fused GEMM epilogues
``fused_gemm_softmax``, ``fused_gemm_layernorm`` and ``fused_gemm_rmsnorm``,
which no model calls: their entry point is the kernel benchmark
(``repro_torch.launch.kernel_bench``).  Each takes its kernel with
``use_kernel=True``, else the plain version; the fused GEMMs' kernel runs
at ``tiling`` (default the COMET plan's, ``gemm_epilogue.planned_tiling``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention
from .gemm_epilogue import Tiling
from .gemm_layernorm import gemm_layernorm, gemm_rmsnorm
from .gemm_softmax import gemm_softmax
from .ssd import expand_groups, ssd_scan

__all__ = ["mha", "ssd", "fused_gemm_softmax", "fused_gemm_layernorm",
           "fused_gemm_rmsnorm", "flash_attention", "ssd_scan",
           "gemm_softmax", "gemm_layernorm", "gemm_rmsnorm"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        window: Optional[int] = None, use_kernel: bool = False
        ) -> torch.Tensor:
    """Multi-head attention (GQA): the FlashAttention kernel or the plain
    reference."""
    if use_kernel:
        return flash_attention(q, k, v, causal, scale, window)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window)


def fused_gemm_softmax(a: torch.Tensor, b: torch.Tensor, *,
                       use_kernel: bool = False,
                       tiling: Optional[Tiling] = None) -> torch.Tensor:
    """softmax(a @ b, -1): the fused kernel (at ``tiling``) or the plain
    version."""
    if use_kernel:
        return gemm_softmax(a, b, tiling=tiling)
    return ref.gemm_softmax_ref(a, b)


def fused_gemm_layernorm(a: torch.Tensor, b: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, *,
                         eps: float = 1e-6, use_kernel: bool = False,
                         tiling: Optional[Tiling] = None) -> torch.Tensor:
    """LayerNorm(a @ b) * gamma + beta: the fused kernel (at ``tiling``)
    or the plain version."""
    if use_kernel:
        return gemm_layernorm(a, b, gamma, beta, eps=eps, tiling=tiling)
    return ref.gemm_layernorm_ref(a, b, gamma, beta, eps=eps)


def fused_gemm_rmsnorm(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                       *, eps: float = 1e-6, use_kernel: bool = False,
                       tiling: Optional[Tiling] = None) -> torch.Tensor:
    """RMSNorm(a @ b) * gamma: the fused kernel (at ``tiling``) or the
    plain version."""
    if use_kernel:
        return gemm_rmsnorm(a, b, gamma, eps=eps, tiling=tiling)
    return ref.gemm_rmsnorm_ref(a, b, gamma, eps=eps)


def ssd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: Optional[int] = None,
        use_kernel: bool = False) -> torch.Tensor:
    """Mamba-2 SSD chunk scan on B/C in group form (BH/r, S, N): the
    kernel, else the chunked reference when a chunk is given, else the
    sequential recurrence (both on B and C repeated to one row a head)."""
    if use_kernel:
        return ssd_scan(xdt, dA, B, C, chunk)
    r = xdt.shape[0] // B.shape[0]
    B, C = expand_groups(B, r), expand_groups(C, r)
    if chunk:
        return ref.ssd_chunked_ref(xdt, dA, B, C, chunk=chunk)
    return ref.ssd_ref(xdt, dA, B, C)
