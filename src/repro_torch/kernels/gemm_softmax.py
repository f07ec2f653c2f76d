"""Fused GEMM-Softmax: the hand-written Hopper kernel's wrapper.

Port of ``repro/kernels/gemm_softmax.py`` (the Pallas TPU kernel
``_kernel``), the paper's GEMM-Softmax compound operation.  The kernel is
``csrc/gemm_epilogue.cu`` (shared with GEMM-LayerNorm/RMSNorm): a
thread-block cluster splits each row of C = A @ B across its CTAs and
all-reduces the row max and sum through distributed shared memory, so C
never reaches device memory.

The tiling is the COMET plan's (``gemm_epilogue.planned_tiling``: the
tiling ``autotune.gemm_epilogue_tiling`` chooses among every one the
kernel runs), as the JAX wrapper takes its blocks from
``gemm_epilogue_blocks``; ``tiling=`` names one instead, the counterpart
of the JAX wrapper's ``block_m``/``block_k``.

Dispatch (``gemm_epilogue.run``, the op ``repro_torch::gemm_epilogue``):
tensors on the CPU take the plain ``gemm_softmax_ref``; tensors on a CUDA
device launch the kernel at the tiling or raise; fake tensors launch
nothing.  The checks run on all of them.  There is no backward, as the
JAX package has none.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import gemm_epilogue as ge

__all__ = ["gemm_softmax"]


def gemm_softmax(a: torch.Tensor, b: torch.Tensor, *,
                 tiling: Optional[ge.Tiling] = None) -> torch.Tensor:
    """softmax(a @ b, -1); a (M, K), b (K, N), f32 or bf16 -> (M, N) in
    a.dtype, at ``tiling`` (one of ``ge.tilings(N, dtype)``; default the
    plan's).

    On CUDA tensors this launches the kernel and adds one to
    ``gemm_softmax.launches``; on CPU tensors it returns the plain
    ``gemm_softmax_ref``.  Either way ``gemm_softmax.last_tiling`` is the
    call's tiling."""
    t = ge.check(a, b, tiling=tiling)
    return ge.run("softmax", a, b, None, None, 0.0, t)


gemm_softmax.launches = 0
gemm_softmax.last_tiling = None
ge.COUNTERS["softmax"] = gemm_softmax
