"""Fused GEMM-Softmax: the hand-written Hopper kernel's wrapper.

Port of ``repro/kernels/gemm_softmax.py`` (the Pallas TPU kernel
``_kernel``), the paper's GEMM-Softmax compound operation.  The kernel is
``csrc/gemm_epilogue.cu`` (shared with GEMM-LayerNorm/RMSNorm): a
thread-block cluster splits each row of C = A @ B across its CTAs and
all-reduces the row max and sum through distributed shared memory, so C
never reaches device memory.

Dispatch: tensors on the CPU take the plain ``gemm_softmax_ref``; tensors
on a CUDA device launch the kernel or raise.  The checks run on both.
There is no backward, as the JAX package has none.
"""
from __future__ import annotations

import torch

from . import gemm_epilogue as ge
from .ref import gemm_softmax_ref

__all__ = ["gemm_softmax"]


def gemm_softmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """softmax(a @ b, -1); a (M, K), b (K, N), f32 or bf16 -> (M, N) in
    a.dtype.  The cluster size follows from N (``ge.cluster_size``).

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_softmax.launches``; on CPU tensors it returns the plain
    ``gemm_softmax_ref``."""
    cluster = ge.check(a, b)
    if a.device.type == "cpu":
        return gemm_softmax_ref(a, b)
    out = ge.launch("softmax", a, b, None, None, 0.0, cluster)
    gemm_softmax.launches += 1
    return out


gemm_softmax.launches = 0
