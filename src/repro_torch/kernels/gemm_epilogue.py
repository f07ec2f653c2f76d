"""The fused GEMM-epilogue kernel's library: checks, cluster size, launch.

``csrc/gemm_epilogue.cu`` holds one thread-block-cluster kernel for the
three row epilogues of ``C = A @ B`` (softmax, LayerNorm, RMSNorm); its
header says what bounds it on the card and how it is laid out.  The
wrappers that users call are ``gemm_softmax.gemm_softmax`` and
``gemm_layernorm.gemm_layernorm`` / ``gemm_rmsnorm``; each counts its own
launches.

The checks run on every device, so a call the kernel would refuse is
refused on the CPU too, where the wrappers take the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import resolve_device
from . import _build

__all__ = ["EPILOGUES", "SLICE_COLUMNS", "CLUSTER_SIZES", "ROW_BLOCK",
           "slice_width", "cluster_size", "check", "launch", "smem_bytes",
           "slice_columns", "max_active_clusters", "tolerance"]

EPILOGUES = {"softmax": 0, "layernorm": 1, "rmsnorm": 2}
SLICE_COLUMNS = 1024           # NT of the source: the columns a CTA holds
CLUSTER_SIZES = (1, 2, 4, 8, 16)
ROW_BLOCK = 16                 # BM of the source: rows per cluster
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

# ge_fwd(a, b, gamma, beta, out, epilogue, dtype, M, N, K, cluster, eps,
# stream): pointers and the stream as c_void_p, or ctypes would pass them
# as 32-bit ints
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("gemm_epilogue")
    lib.ge_fwd.argtypes = _ARGTYPES
    lib.ge_fwd.restype = ctypes.c_int
    lib.ge_max_active_clusters.argtypes = [ctypes.c_int] * 3
    lib.ge_max_active_clusters.restype = ctypes.c_int
    lib.ge_smem_bytes.argtypes = [ctypes.c_int]
    lib.ge_smem_bytes.restype = ctypes.c_int
    lib.ge_slice_columns.restype = ctypes.c_int
    return lib


def slice_width(N: int, cluster: int) -> int:
    """Columns of a CTA's slice: ceil(N / cluster) rounded up to 16."""
    return math.ceil(math.ceil(N / cluster) / 16) * 16


def cluster_size(N: int) -> int:
    """The smallest cluster of ``CLUSTER_SIZES`` whose per-CTA slice of N
    columns fits the kernel's ``SLICE_COLUMNS``; ValueError if none does
    (N > 16384)."""
    for cl in CLUSTER_SIZES:
        if slice_width(N, cl) <= SLICE_COLUMNS:
            return cl
    raise ValueError(
        f"N={N} does not fit {CLUSTER_SIZES[-1]} slices of "
        f"{SLICE_COLUMNS} columns: the fused kernel holds a row of C on "
        f"one thread-block cluster")


def tolerance(epilogue: str, dtype: torch.dtype,
              max_abs_plain: float) -> float:
    """The bar on max |kernel - plain| for ``epilogue`` in ``dtype``, given
    the plain output's largest magnitude.

    f32: softmax 2e-5 (``TOL`` of tests/test_kernels.py), the norms 1e-4
    (that file's norm bar); the same f32 math, sums in another order.
    bf16, all three: 1e-2 of the largest |plain|.  Both sides round the
    output to bf16, and the two roundings of nearly equal values differ by
    at most one step, which is at most 2^-7 (0.78%) of the largest |y|.
    Relative, because a softmax over N columns has outputs near 1/N: an
    absolute bar would pass zeros at the paper's widths, while this one
    is broken by a cluster that leaves one of 16 partial sums out (about
    6%; tests/test_torch_gemm_epilogue.py plants such faults).
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want one of "
                         f"{list(EPILOGUES)}")
    if dtype == torch.float32:
        return 2e-5 if epilogue == "softmax" else 1e-4
    if dtype == torch.bfloat16:
        return 1e-2 * max_abs_plain
    raise TypeError(f"no bar for {dtype}")


def check(a: torch.Tensor, b: torch.Tensor,
          gamma: Optional[torch.Tensor] = None,
          beta: Optional[torch.Tensor] = None) -> int:
    """Raise on anything the kernel does not take; returns the cluster
    size."""
    ts = [t for t in (a, b, gamma, beta) if t is not None]
    if any(t.device != a.device for t in ts):
        raise ValueError(f"a/b/gamma/beta on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one dtype of {list(_DTYPES)}, "
                        f"got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"empty input: M={M}, K={K}, N={N}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            continue
        if tuple(t.shape) != (N,):
            raise ValueError(f"{name} must have shape ({N},), got "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"a and b must be contiguous, got strides "
                         f"{a.stride()}, {b.stride()}")
    # B's rows move in 16-byte cp.async chunks
    per16 = 16 // a.element_size()
    if N % per16 or b.data_ptr() % 16:
        raise ValueError(f"b's rows must be 16-byte aligned: N={N} must be a "
                         f"multiple of {per16} for {a.dtype}")
    if -(-M // ROW_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds {ROW_BLOCK * _MAX_GRID_Y} rows")
    return cluster_size(N)


def launch(epilogue: str, a: torch.Tensor, b: torch.Tensor,
           gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
           eps: float, cluster: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors; raise on a non-zero CUDA
    error.  gamma/beta are handed to the kernel as f32, as the TPU kernel
    casts them."""
    resolve_device(a.device)
    M, N = a.shape[0], b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    g = gamma.float().contiguous() if gamma is not None else None
    be = beta.float().contiguous() if beta is not None else None
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ge_fwd(a.data_ptr(), b.data_ptr(),
                         g.data_ptr() if g is not None else None,
                         be.data_ptr() if be is not None else None,
                         out.data_ptr(), EPILOGUES[epilogue],
                         _DTYPES[a.dtype], M, N, a.shape[1], cluster,
                         float(eps), stream)
    if err != 0:
        raise RuntimeError(f"gemm_{epilogue} kernel launch failed: CUDA "
                           f"error {err}")
    return out


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of the kernel for ``dtype``."""
    return _library().ge_smem_bytes(_DTYPES[dtype])


def slice_columns() -> int:
    """The source's per-CTA slice budget (must equal ``SLICE_COLUMNS``)."""
    return _library().ge_slice_columns()


def max_active_clusters(epilogue: str, dtype: torch.dtype,
                        cluster: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of one instance (0: a cluster of
    that size cannot be placed); raises on a failed query."""
    n = _library().ge_max_active_clusters(EPILOGUES[epilogue],
                                          _DTYPES[dtype], cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {-n}")
    return n
