"""The fused GEMM-epilogue kernel's library: tiling, checks, launch.

``csrc/gemm_epilogue.cu`` holds one thread-block-cluster kernel for the
three row epilogues of ``C = A @ B`` (softmax, LayerNorm, RMSNorm); its
header says what bounds it on the card and how it is laid out.  The
wrappers that users call are ``gemm_softmax.gemm_softmax`` and
``gemm_layernorm.gemm_layernorm`` / ``gemm_rmsnorm``; each counts its own
launches.

``tiling(N, dtype)`` says how a row of N columns is cut: the cluster of
CTAs that shares a block of rows, the rows per block, the columns of a
CTA's slice and the column passes a CTA makes over its slice.  It is the
only copy of that rule: ``launch`` hands it to the source, which checks
only that it has such an instance and that the slices cover N.

The launch is the custom op ``repro_torch::gemm_epilogue`` (:func:`run`):
on the CPU it takes the plain versions, on the card it launches the kernel
or raises, and on fake tensors (``FakeTensorMode``) it builds and launches
nothing.  The checks run on every device, so a call the kernel would
refuse is refused on the CPU too.  ``mma_flops`` is the op's FLOP
formula: the products the launch issues on its tiling.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from . import _build
from ._op import aligned16, register_kernel_op
from .ref import gemm_layernorm_ref, gemm_rmsnorm_ref, gemm_softmax_ref

__all__ = ["EPILOGUES", "CLUSTER_SIZES", "TILING_BOUNDARIES", "Tiling",
           "tiling", "instances", "boundary_shapes", "check",
           "kernel_operand", "launch", "run", "smem_bytes",
           "max_active_clusters", "tolerance", "mma_flops", "COUNTERS",
           "launch_grid", "layout_smem_bytes"]

EPILOGUES = {"softmax": 0, "layernorm": 1, "rmsnorm": 2}
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# N on either side of every change of tiling (bf16 and f32), and the
# widest row taken
TILING_BOUNDARIES = (8, 256, 264, 512, 520, 1024, 1032, 2048, 2056, 4096,
                     4104, 8192, 8200, 16384)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_F32_SLICE = 1024              # most columns an f32 CTA holds
_BF16_PASS = {128: 256, 64: 512}   # columns a bf16 pass holds, by rows

# ge_fwd(a, b, gamma, beta, out, epilogue, dtype, M, N, K, lda, eps,
# cluster, rows, columns, passes, stream): pointers and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


class Tiling(NamedTuple):
    """How a row block of C is cut across a thread-block cluster."""
    cluster: int     # CTAs that share a block of rows
    rows: int        # rows of C per block
    columns: int     # columns of a CTA's slice
    passes: int      # column passes a CTA makes over its slice


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("gemm_epilogue")
    lib.ge_fwd.argtypes = _ARGTYPES
    lib.ge_fwd.restype = ctypes.c_int
    lib.ge_max_active_clusters.argtypes = [ctypes.c_int] * 5
    lib.ge_max_active_clusters.restype = ctypes.c_int
    lib.ge_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ge_smem_bytes.restype = ctypes.c_int
    return lib


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tiling(N: int, dtype: torch.dtype) -> Tiling:
    """The kernel's tiling of a row of N columns in ``dtype``; ValueError
    if no cluster of 16 CTAs holds it (N > 16384).

    f32 (CUDA cores): 16 rows, the smallest cluster whose slice,
    ceil(N / cluster) rounded up to 16, fits 1024 columns.
    bf16 (wgmma): the smallest cluster whose slice, rounded up to 8, fits
    256 columns, at 128 rows (N <= 4096); else 16 CTAs at 64 rows, with
    slices of up to 512 columns in one pass (N <= 8192) or up to 1024 in
    two (N <= 16384).  B is read once per row block, so at least once per
    64 rows, at every N it takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"no tiling for {dtype}")
    if dtype == torch.float32:
        for cl in CLUSTER_SIZES:
            ns = _round_up(math.ceil(N / cl), 16)
            if ns <= _F32_SLICE:
                return Tiling(cl, 16, ns, 1)
        widest = _F32_SLICE
    else:
        for cl in CLUSTER_SIZES:
            ns = _round_up(math.ceil(N / cl), 8)
            if ns <= _BF16_PASS[128]:
                return Tiling(cl, 128, ns, 1)
        ns = _round_up(math.ceil(N / CLUSTER_SIZES[-1]), 8)
        if ns <= 2 * _BF16_PASS[64]:
            return Tiling(CLUSTER_SIZES[-1], 64, ns,
                          1 if ns <= _BF16_PASS[64] else 2)
        widest = 2 * _BF16_PASS[64]
    raise ValueError(
        f"N={N} does not fit {CLUSTER_SIZES[-1]} slices of {widest} "
        f"columns: the fused kernel holds a row of C on one thread-block "
        f"cluster")


def instances(dtype: torch.dtype) -> Tuple[Tuple[int, int, int], ...]:
    """(rows, passes, cluster) of every instance the tiling launches for
    ``dtype``, over ``TILING_BOUNDARIES``."""
    return tuple(sorted({(t.rows, t.passes, t.cluster) for t in
                         (tiling(n, dtype) for n in TILING_BOUNDARIES)}))


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


def boundary_shapes(dtype: torch.dtype) -> Tuple[Tuple[int, int, int], ...]:
    """(M, K, N) on both sides of every change of tiling: N at 256 / 264,
    4096 / 4104, 8192 / 8200 and 16384; at each N, M at 1, BM - 1, BM + 1
    and a ragged 2.5 BM + 3 (BM the rows per block there); K in turn at 8,
    100 (not a multiple of 8: bf16 A goes padded) and one that is a
    multiple of 8 but not of the K step (40 for bf16's 32, 12 for f32's
    8).  The card's tests hold the kernel to its plain version at each."""
    ks = (8, 100, 40 if dtype == torch.bfloat16 else 12)
    shapes = []
    for i, n in enumerate((256, 264, 4096, 4104, 8192, 8200, 16384)):
        bm = tiling(n, dtype).rows
        for j, m in enumerate((1, bm - 1, bm + 1, 2 * bm + bm // 2 + 3)):
            shapes.append((m, ks[(i + j) % 3], n))
    return tuple(shapes)


def check(a: torch.Tensor, b: torch.Tensor,
          gamma: Optional[torch.Tensor] = None,
          beta: Optional[torch.Tensor] = None) -> Tiling:
    """Raise on anything the kernel does not take; returns the tiling."""
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
    # B's rows move in 16-byte chunks (cp.async in f32, TMA boxes in bf16)
    per16 = 16 // a.element_size()
    if N % per16 or not aligned16(b):
        raise ValueError(f"b's rows must be 16-byte aligned: N={N} must be a "
                         f"multiple of {per16} for {a.dtype}")
    t = tiling(N, a.dtype)
    if -(-M // t.rows) > _MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds {t.rows * _MAX_GRID_Y} rows "
                         f"(65535 blocks of {t.rows} at N={N})")
    return t


def kernel_operand(a: torch.Tensor) -> torch.Tensor:
    """A as the kernel reads it.  bf16 tiles of A come by TMA, whose rows
    must start 16 bytes apart and whose base must be 16-byte aligned: for K
    not a multiple of 8 (or an unaligned A) the kernel gets a copy of A
    with its rows zero-padded to a multiple of 8.  The kernel still reads
    only K columns (the tensor map's width is K), so this changes no
    result; it happens only at shapes far smaller than the paper's (the
    JAX sweep's K = 100).  f32 A is read element by element and passes as
    it is."""
    K = a.shape[1]
    if a.dtype != torch.bfloat16 or (K % 8 == 0 and aligned16(a)):
        return a
    return F.pad(a, (0, _round_up(K, 8) - K))


def launch(epilogue: str, a: torch.Tensor, b: torch.Tensor,
           gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
           eps: float, t: Tiling) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``check`` passed, with the
    tiling it returned; raise on a non-zero CUDA error.  gamma/beta are
    handed to the kernel as f32, as the TPU kernel casts them."""
    resolve_device(a.device)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ak = kernel_operand(a)
    g = gamma.float().contiguous() if gamma is not None else None
    be = beta.float().contiguous() if beta is not None else None
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ge_fwd(ak.data_ptr(), b.data_ptr(),
                         g.data_ptr() if g is not None else None,
                         be.data_ptr() if be is not None else None,
                         out.data_ptr(), EPILOGUES[epilogue],
                         _DTYPES[a.dtype], M, N, K, ak.shape[1], float(eps),
                         *t, stream)
    if err != 0:
        raise RuntimeError(f"gemm_{epilogue} kernel launch failed: CUDA "
                           f"error {err}")
    return out


# epilogue -> the user's wrapper whose ``.launches`` counts its launches
# (gemm_softmax.py, gemm_layernorm.py register theirs)
COUNTERS = {}
_PLAIN = {"softmax": lambda a, b, g, be, eps: gemm_softmax_ref(a, b),
          "layernorm": lambda a, b, g, be, eps: gemm_layernorm_ref(
              a, b, g, be, eps=eps),
          "rmsnorm": lambda a, b, g, be, eps: gemm_rmsnorm_ref(a, b, g,
                                                               eps=eps)}


def run(epilogue: str, a: torch.Tensor, b: torch.Tensor,
        gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
        eps: float) -> torch.Tensor:
    """``epilogue(a @ b)`` on inputs that :func:`check` passed, through the
    op: the plain version on CPU tensors, the kernel on CUDA tensors (one
    more launch on the wrapper's count), an empty result on fake ones."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want one of "
                         f"{list(EPILOGUES)}")
    return _op(a, b, gamma, beta, epilogue, float(eps))


def _run(a: torch.Tensor, b: torch.Tensor, gamma: Optional[torch.Tensor],
         beta: Optional[torch.Tensor], epilogue: str,
         eps: float) -> torch.Tensor:
    if a.device.type == "cpu":
        return _PLAIN[epilogue](a, b, gamma, beta, eps)
    out = launch(epilogue, a, b, gamma, beta, eps, tiling(b.shape[1],
                                                          a.dtype))
    COUNTERS[epilogue].launches += 1
    return out


def _fake(a, b, gamma, beta, epilogue, eps):
    return a.new_empty((a.shape[0], b.shape[1]))


def mma_flops(M: int, N: int, K: int, dtype: torch.dtype) -> int:
    """The products one launch issues: every block of ``rows`` rows of C
    on a cluster of CTAs, each over its slice of ``columns`` columns and
    all of K in steps of BK (bf16 32, or 16 with two column passes; f32
    8), padding included."""
    t = tiling(N, dtype)
    bk = 8 if dtype == torch.float32 else (16 if t.passes == 2 else 32)
    return (2 * -(-M // t.rows) * t.rows * t.cluster * t.columns
            * -(-K // bk) * bk)


def _flops(a, b, gamma, beta, epilogue, eps, out_val=None):
    return mma_flops(a.shape[0], b.shape[1], a.shape[1], a.dtype)


_op = register_kernel_op("gemm_epilogue", _run, _fake, _flops)


def launch_grid(M: int, t: Tiling) -> Tuple[int, int]:
    """The launch's grid: the cluster's CTAs across, a block of ``rows``
    rows of C down."""
    return (t.cluster, -(-M // t.rows))


def layout_smem_bytes(dtype: torch.dtype, rows: int, passes: int) -> int:
    """Dynamic shared memory of an instance, from the source's layout in
    Python (``Bf16Cfg::SMEM``, ``F32Tile::SMEM``): bf16, 1024 bytes of
    alignment slack and a ring of stages of A's (rows x BK) and B's
    (BK x 256 or 512 columns) tiles, BK 32 (16 with two passes, beside the
    parked first pass of 128 KB); f32, two stages of 8 rows of B (1024
    columns) and of A (16 rows).  ``smem_bytes`` reads the built
    library's (on the card), which chip_smoke holds it to."""
    if dtype == torch.float32:
        return 2 * (8 * _F32_SLICE + 8 * 16) * 4
    bk = 16 if passes == 2 else 32
    b_cols = 256 if rows == 128 else 512
    stages = 5 if passes == 2 else (8 if rows == 128 else 6)
    park = 256 * 128 * 4 if passes == 2 else 0
    return 1024 + stages * (rows * bk * 2 + b_cols * bk * 2) + park


def smem_bytes(dtype: torch.dtype, rows: int, passes: int) -> int:
    """Dynamic shared memory of the instance for ``dtype``, ``rows`` and
    ``passes``."""
    n = _library().ge_smem_bytes(_DTYPES[dtype], rows, passes)
    if n < 0:
        raise ValueError(f"no {dtype} instance of {rows} rows and {passes} "
                         f"passes")
    return n


def max_active_clusters(epilogue: str, dtype: torch.dtype, rows: int,
                        passes: int, cluster: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of one instance at a cluster of
    ``cluster`` CTAs (0: such a cluster cannot be placed); raises on a
    failed query."""
    n = _library().ge_max_active_clusters(EPILOGUES[epilogue],
                                          _DTYPES[dtype], rows, passes,
                                          cluster)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {-n}")
    return n
