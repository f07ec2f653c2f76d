"""The fused GEMM-epilogue kernel's library: tiling, checks, launch.

``csrc/gemm_epilogue.cu`` holds one thread-block-cluster kernel for the
three row epilogues of ``C = A @ B`` (softmax, LayerNorm, RMSNorm); its
header says what bounds it on the card and how it is laid out.  The
wrappers that users call are ``gemm_softmax.gemm_softmax`` and
``gemm_layernorm.gemm_layernorm`` / ``gemm_rmsnorm``; each counts its own
launches.

A ``Tiling`` says how a row of N columns is cut: the cluster of CTAs that
shares a block of rows, the rows per block, the columns of a CTA's slice
and the column passes a CTA makes over its slice.  ``tilings(N, dtype)``
lists every tiling the source runs at N (its ``valid_tiling`` states the
same rule); ``tiling(N, dtype)``, the first of them, is the smallest
cluster that holds the row.  Which one a call launches is the COMET
plan's choice (``autotune.gemm_epilogue_tiling``, memoized here by
``planned_tiling``), unless the caller names one; ``check`` refuses a
tiling that is not in ``tilings``, on every device.

The launch is the custom op ``repro_torch::gemm_epilogue`` (:func:`run`),
which carries the tiling's four numbers: on the CPU it takes the plain
versions (the same math at every tiling), on the card it launches the
kernel at that tiling or raises, and on fake tensors (``FakeTensorMode``)
it builds and launches nothing.  The checks run on every device, so a
call the kernel would refuse is refused on the CPU too.  ``mma_flops`` is
the op's FLOP formula: the products the launch issues on its tiling.
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

__all__ = ["EPILOGUES", "ROUNDS", "CLUSTER_SIZES", "TILING_BOUNDARIES",
           "Tiling", "tilings", "tiling", "planned_tiling", "instances",
           "boundary_shapes", "check", "kernel_operand", "launch", "run",
           "smem_bytes", "max_active_clusters", "tolerance", "pass_columns",
           "mma_flops", "COUNTERS", "launch_grid", "layout_smem_bytes"]

EPILOGUES = {"softmax": 0, "layernorm": 1, "rmsnorm": 2}
# statistic rounds of an epilogue, each a DSMEM All-Reduce of the block's
# per-row f32 partials over the cluster (``rounds`` in the source)
ROUNDS = {"softmax": 2, "layernorm": 2, "rmsnorm": 1}
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# N on either side of every change of tiling (bf16 and f32), and the
# widest row taken
TILING_BOUNDARIES = (8, 256, 264, 512, 520, 1024, 1032, 2048, 2056, 4096,
                     4104, 8192, 8200, 16384)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_F32_SLICE = 1024              # most columns an f32 CTA holds
_BF16_PASS = {128: 256, 64: 512}   # columns a bf16 pass holds, by rows
# (rows, passes, fewest columns, most columns) of a CTA's slice, by
# instance, in the order ``tilings`` lists them: a two-pass instance takes
# only slices one pass cannot hold
_INSTANCES = {
    torch.float32: ((16, 1, 1, _F32_SLICE),),
    torch.bfloat16: ((128, 1, 1, _BF16_PASS[128]),
                     (64, 1, 1, _BF16_PASS[64]),
                     (64, 2, _BF16_PASS[64] + 1, 2 * _BF16_PASS[64])),
}
_SLICE_ALIGN = {torch.float32: 16, torch.bfloat16: 8}

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


@functools.lru_cache(maxsize=4096)
def tilings(N: int, dtype: torch.dtype) -> Tuple[Tiling, ...]:
    """Every tiling the source runs for a row of N columns in ``dtype``,
    instance by instance, the clusters of 1, 2, 4, 8 and 16 CTAs in turn
    within each: the slice is ceil(N / cluster) rounded up to 16 columns
    (f32) or 8 (bf16), it must fit the instance, and every CTA of the
    cluster must get columns.  The Python copy of ``valid_tiling`` in
    ``csrc/gemm_epilogue.cu``; empty where no cluster holds the row.

    f32 (CUDA cores): 16 rows, slices of up to 1024 columns.
    bf16 (wgmma): 128 rows with slices of up to 256 columns in one pass;
    64 rows with slices of up to 512 in one pass, or of 520 to 1024 in
    two.  B is read once per row block, so at least once per 64 rows."""
    if dtype not in _DTYPES:
        raise TypeError(f"no tiling for {dtype}")
    out = []
    for rows, passes, lo, hi in _INSTANCES[dtype]:
        for cl in CLUSTER_SIZES:
            ns = _round_up(math.ceil(N / cl), _SLICE_ALIGN[dtype])
            if lo <= ns <= hi and (cl - 1) * ns < N:
                out.append(Tiling(cl, rows, ns, passes))
    return tuple(out)


def tiling(N: int, dtype: torch.dtype) -> Tiling:
    """The first of ``tilings(N, dtype)``: the smallest cluster whose
    slices fit, at 128 rows in bf16 where one does (N <= 4096), else at
    64 rows in one pass (N <= 8192), else in two; ValueError if no
    cluster of 16 CTAs holds the row (N > 16384)."""
    ts = tilings(N, dtype)
    if not ts:
        widest = _INSTANCES[dtype][-1][3]
        raise ValueError(
            f"N={N} does not fit {CLUSTER_SIZES[-1]} slices of {widest} "
            f"columns: the fused kernel holds a row of C on one "
            f"thread-block cluster")
    return ts[0]


@functools.lru_cache(maxsize=1024)
def planned_tiling(M: int, N: int, K: int, dtype: torch.dtype) -> Tiling:
    """The tiling the COMET plan chooses at (M, N, K) in ``dtype``
    (``autotune.gemm_epilogue_tiling``), memoized per shape and dtype so a
    repeated call looks nothing up; ValueError where the kernel takes no
    tiling."""
    from .autotune import gemm_epilogue_tiling
    t = gemm_epilogue_tiling(M, N, K, dtype)
    if t is None:
        tiling(N, dtype)                 # raises with the reason
    return t


def instances(dtype: torch.dtype) -> Tuple[Tuple[int, int, int], ...]:
    """(rows, passes, cluster) of every instance and cluster size the
    tilings at ``TILING_BOUNDARIES`` launch for ``dtype`` (every one the
    source runs)."""
    return tuple(sorted({(t.rows, t.passes, t.cluster)
                         for n in TILING_BOUNDARIES
                         for t in tilings(n, dtype)}))


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
          beta: Optional[torch.Tensor] = None,
          tiling: Optional[Tiling] = None) -> Tiling:
    """Raise on anything the kernel does not take; returns the tiling the
    call launches: ``tiling`` if given (ValueError unless it is one of
    ``tilings(N, dtype)``), else the plan's (``planned_tiling``)."""
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
    if tiling is None:
        t = planned_tiling(M, N, K, a.dtype)
    else:
        t = Tiling(*tiling)
        if t not in tilings(N, a.dtype):
            runs = [tuple(x) for x in tilings(N, a.dtype)]
            raise ValueError(f"the kernel does not run tiling {tuple(t)} "
                             f"at N={N} in {a.dtype}; it runs {runs}")
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
# and whose ``.last_tiling`` is its last call's tiling (gemm_softmax.py,
# gemm_layernorm.py register theirs)
COUNTERS = {}
_PLAIN = {"softmax": lambda a, b, g, be, eps: gemm_softmax_ref(a, b),
          "layernorm": lambda a, b, g, be, eps: gemm_layernorm_ref(
              a, b, g, be, eps=eps),
          "rmsnorm": lambda a, b, g, be, eps: gemm_rmsnorm_ref(a, b, g,
                                                               eps=eps)}


def run(epilogue: str, a: torch.Tensor, b: torch.Tensor,
        gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
        eps: float, t: Tiling) -> torch.Tensor:
    """``epilogue(a @ b)`` on inputs that :func:`check` passed, at the
    tiling ``t`` it returned, through the op: the plain version on CPU
    tensors, the kernel at ``t`` on CUDA tensors (one more launch on the
    wrapper's count), an empty result on fake ones.  The wrapper's
    ``.last_tiling`` becomes ``t``."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want one of "
                         f"{list(EPILOGUES)}")
    COUNTERS[epilogue].last_tiling = t
    return _op(a, b, gamma, beta, epilogue, float(eps), *t)


def _run(a: torch.Tensor, b: torch.Tensor, gamma: Optional[torch.Tensor],
         beta: Optional[torch.Tensor], epilogue: str, eps: float,
         cluster: int, rows: int, columns: int,
         passes: int) -> torch.Tensor:
    if a.device.type == "cpu":
        return _PLAIN[epilogue](a, b, gamma, beta, eps)
    out = launch(epilogue, a, b, gamma, beta, eps,
                 Tiling(cluster, rows, columns, passes))
    COUNTERS[epilogue].launches += 1
    return out


def _fake(a, b, gamma, beta, epilogue, eps, cluster, rows, columns, passes):
    return a.new_empty((a.shape[0], b.shape[1]))


def pass_columns(t: Tiling, dtype: torch.dtype) -> int:
    """Columns of C a CTA computes at tiling ``t``: in f32 its slice (its
    threads past the slice idle); in bf16 every pass's whole width, 256
    columns at 128 rows and 512 at 64 (each warpgroup issues wgmma
    m64n256 over its 256 whatever the slice holds; the columns past the
    slice are computed and dropped)."""
    if dtype == torch.float32:
        return t.columns
    return t.passes * _BF16_PASS[t.rows]


def mma_flops(M: int, N: int, K: int, dtype: torch.dtype, t: Tiling) -> int:
    """The products one launch at tiling ``t`` issues: every block of
    ``rows`` rows of C on a cluster of CTAs, each over its
    ``pass_columns`` and all of K in steps of BK (bf16 32, or 16 with two
    column passes; f32 8), padding included."""
    bk = 8 if dtype == torch.float32 else (16 if t.passes == 2 else 32)
    return (2 * -(-M // t.rows) * t.rows * t.cluster * pass_columns(t, dtype)
            * -(-K // bk) * bk)


def _flops(a, b, gamma, beta, epilogue, eps, cluster, rows, columns, passes,
           out_val=None):
    return mma_flops(a.shape[0], b.shape[1], a.shape[1], a.dtype,
                     Tiling(cluster, rows, columns, passes))


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
