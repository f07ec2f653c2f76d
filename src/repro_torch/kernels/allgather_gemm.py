"""Streamed all-gather GEMM: the hand-written Hopper kernel's wrapper and
its ``torch.distributed`` entry.

Port of ``repro/kernels/allgather_gemm.py``.  Two layers, as there:

* :func:`streamed_gemm` computes ``x @ w`` with the contraction K streamed
  in ``chunks`` chunks, one per gather shard (``csrc/streamed_gemm.cu``;
  its header says how the TPU kernel's whole-chunk VMEM slots and (M, N)
  accumulator became tiles, and what bounds it on the card).  In bf16 a
  persistent, warp-specialised kernel streams each chunk's k-tiles by TMA
  into an mbarrier ring and runs its products on wgmma; ``buffers=2``
  keeps the next k-tiles' loads in flight under the current products,
  ``buffers=1`` (a ring of one stage) is the serial baseline that
  ``launch/overlap_bench.py`` compares it with.  The f32 path runs on the
  CUDA cores through one or two cp.async stages.
* :func:`allgather_gemm` gathers the K-sharded activation over a process
  group (NCCL on the card, gloo on the CPU) and streams the result through
  :func:`streamed_gemm` with one chunk per rank.

In bf16 the source sizes the kernel's persistent grid: a cluster of two
CTAs per slot the card holds at once (:func:`max_active_clusters`), each
cluster taking units of two tiles that share an operand.

Dispatch: the entry is the custom op ``repro_torch::streamed_gemm``.
Tensors on the CPU take the plain ``streamed_gemm_ref``; tensors on a CUDA
device launch the kernel or raise; fake tensors (``FakeTensorMode``) take
the op's shape function and launch nothing.  ``mma_flops`` is the op's
FLOP formula: the products the launch issues on its tiling.  The checks
run on all of them, in the JAX package's order and with its messages,
then the card's alignment rule.  There is no backward, as the JAX kernel has none.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from . import _build
from ._op import aligned16, register_kernel_op
from .ref import allgather_gemm_reference, gather_columns, streamed_gemm_ref

__all__ = ["streamed_gemm", "allgather_gemm", "allgather_gemm_reference",
           "BUDGET_SHAPES", "TILES", "CLUSTER", "boundary_shapes",
           "check", "cluster", "max_active_clusters", "tile", "tolerance",
           "mma_flops", "layout_smem_bytes"]

# The (M, K, N, chunks) configurations the JAX package's tests and overlap
# bench drive its kernel with (repro/kernels/allgather_gemm.py:57-61).
BUDGET_SHAPES = (
    (256, 4096, 512, 8),   # overlap_bench.measure_hidden_fraction scale
    (128, 1024, 256, 8),   # overlap_bench.measure_double_buffer
    (128, 512, 256, 4),    # test_kernels streamed-GEMM cases (largest)
)
# (rows, columns, k-tile depth) of a CTA's tile in the source, per dtype
TILES = {torch.bfloat16: (256, 128, 64), torch.float32: (64, 64, 16)}
# CTAs of a thread-block cluster in the source, per dtype: in bf16 two
# tiles of a row share X's tile by TMA multicast (and, with an odd count of
# column tiles, two of the last column share W's); f32 has no clusters
CLUSTER = {torch.bfloat16: 2, torch.float32: 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535     # the f32 grid's column tiles

# sg_fwd(x, w, out, dtype, M, N, K, chunks, buffers, stream): pointers and
# the stream as c_void_p, or ctypes would pass them as 32-bit ints
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("streamed_gemm")
    lib.sg_fwd.argtypes = _ARGTYPES
    lib.sg_fwd.restype = ctypes.c_int
    lib.sg_tile.argtypes = [ctypes.c_int] * 2
    lib.sg_tile.restype = ctypes.c_int
    lib.sg_max_active_clusters.argtypes = []
    lib.sg_max_active_clusters.restype = ctypes.c_int
    return lib


def tile(dtype: torch.dtype) -> tuple:
    """The source's (rows, columns, k-tile depth) for ``dtype``, read from
    the built library (must equal ``TILES[dtype]``)."""
    lib = _library()
    return tuple(lib.sg_tile(_DTYPES[dtype], i) for i in range(3))


def cluster(dtype: torch.dtype) -> int:
    """The source's CTAs of a cluster for ``dtype``, read from the built
    library (must equal ``CLUSTER[dtype]``)."""
    return _library().sg_tile(_DTYPES[dtype], 3)


def boundary_shapes(dtype: torch.dtype
                    ) -> Tuple[Tuple[int, int, int, int], ...]:
    """(M, K, N, chunks) at every edge of the kernel's tiling in ``dtype``
    (BM x BN tiles, k-tiles of BK; ``TILES``): M at 1, BM - 1, BM + 1 and
    2 BM + 8; N at BN - 8, BN + 8 and at an odd count of column tiles (in
    bf16 the last column's tiles go in column pairs, and with an odd count
    of row tiles the last pair's second tile lies past M); a chunk's
    columns kc at 8, 40, 56, 64, 72 and 1024 (below, at and across a
    k-tile); ``chunks=1``; and more bf16 units than the card runs at once,
    so that a persistent cluster takes several.  The card's tests hold the
    kernel to its plain version at each."""
    bm, bn, _ = TILES[dtype]
    shapes = [(m, 128, bn, 2) for m in (1, bm - 1, bm + 1, 2 * bm + 8)]
    shapes += [(bm + 1, 128, n, 2) for n in (bn - 8, bn + 8, 3 * bn - 8)]
    shapes += [(bm // 2 + 3, kc * c, 2 * bn + 8, c)
               for kc, c in ((8, 8), (40, 4), (56, 3), (64, 2), (72, 2),
                             (1024, 2))]
    shapes.append((3 * bm // 2, 520, 3 * bn, 1))
    # 9 x 33 tiles of 256 x 128 in bf16: 16 x 9 + 5 = 149 units on 66
    # clusters
    shapes.append((8 * 256 + 8, 256, 32 * 128 + 8, 4))
    return tuple(shapes)


def tolerance(dtype: torch.dtype, max_abs_plain: float
              ) -> Tuple[float, float]:
    """(atol, rtol) of the bar |kernel - plain| <= atol + rtol |plain|,
    elementwise, for ``dtype``, given the plain output's largest magnitude.

    f32: atol 2e-4, rtol 2e-5, tests/test_kernels.py's bar for the JAX
    kernel (with w scaled 0.2 there): the same f32 products, summed in
    another order.  bf16: 1e-2 of the largest |plain|, the bf16 bar of
    ``gemm_epilogue.tolerance``: both sides round the f32 sum to bf16, and
    two roundings of nearly equal values differ by at most one step, 2^-7
    (0.78%) of the largest |y|."""
    if dtype == torch.float32:
        return 2e-4, 2e-5
    if dtype == torch.bfloat16:
        return 1e-2 * max_abs_plain, 0.0
    raise TypeError(f"no bar for {dtype}")


def check(x: torch.Tensor, w: torch.Tensor, chunks: int, buffers: int
          ) -> None:
    """Raise on anything the kernel does not take: the JAX kernel's checks
    first, in its order and with its messages, then the card's."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"want x (M, K) and w (K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"x has K={K} columns but w has K={K2} rows")
    if K % chunks != 0:
        raise ValueError(f"chunks={chunks} must divide K={K}")
    if buffers not in (1, 2):
        raise ValueError(f"buffers must be 1 or 2, got {buffers}")
    if x.device != w.device:
        raise ValueError(f"x and w on different devices: {x.device}, "
                         f"{w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype of {list(_DTYPES)}, "
                        f"got {x.dtype}, {w.dtype}")
    if M < 1 or N < 1:
        raise ValueError(f"empty input: M={M}, K={K}, N={N}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"x and w must be contiguous, got strides "
                         f"{x.stride()}, {w.stride()}")
    # TMA (bf16) and cp.async (f32) move 16-byte groups: W's rows, and the
    # start of every chunk of X's columns, must be 16-byte aligned
    per16 = 16 // x.element_size()
    kc = K // chunks
    if N % per16 or kc % per16 or not aligned16(x) or not aligned16(w):
        raise ValueError(f"rows must be 16-byte aligned: N={N} and "
                         f"K/chunks={kc} must be multiples of {per16} for "
                         f"{x.dtype}")
    if x.dtype == torch.float32 and -(-N // TILES[x.dtype][1]) > _MAX_GRID_Y:
        raise ValueError(f"N={N} exceeds {TILES[x.dtype][1] * _MAX_GRID_Y} "
                         f"columns (65535 column tiles in f32)")


def streamed_gemm(x: torch.Tensor, w: torch.Tensor, *, chunks: int,
                  buffers: int = 2) -> torch.Tensor:
    """x @ w with K streamed in ``chunks`` chunks through ``buffers`` (1 or
    2) stages; x (M, K), w (K, N), f32 or bf16, K % chunks == 0 -> (M, N)
    in x.dtype, accumulated in f32.

    On CUDA tensors this launches the kernel and adds one to
    ``streamed_gemm.launches``; on CPU tensors it returns the plain
    ``streamed_gemm_ref``; on fake tensors an empty result of the shape."""
    check(x, w, chunks, buffers)
    return _op(x, w, int(chunks), int(buffers))


streamed_gemm.launches = 0


def _run(x: torch.Tensor, w: torch.Tensor, chunks: int,
         buffers: int) -> torch.Tensor:
    """The op on real tensors: the plain version on the CPU, else the
    kernel's launch."""
    if x.device.type == "cpu":
        return streamed_gemm_ref(x, w, chunks=chunks)
    resolve_device(x.device)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sg_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                         _DTYPES[x.dtype], M, N, K, chunks, buffers, stream)
    if err != 0:
        raise RuntimeError(f"streamed_gemm kernel launch failed: CUDA error "
                           f"{err}")
    streamed_gemm.launches += 1
    return out


def _fake(x, w, chunks, buffers):
    return x.new_empty((x.shape[0], w.shape[1]))


def mma_flops(M: int, N: int, K: int, chunks: int,
              dtype: torch.dtype) -> int:
    """The products one launch issues: every tile it computes, BM x BN
    over each chunk's k-tiles of BK (a chunk's last k-tile padded), the
    same in both buffer modes.  bf16: units of two 256 x 128 tiles, so
    with an odd count of column tiles and of row tiles the last column
    pair's second tile, past M, is computed too; f32: one 64 x 64 tile a
    CTA."""
    bm, bn, bk = TILES[dtype]
    tm, tn = -(-M // bm), -(-N // bn)
    tiles = tm * tn
    if dtype == torch.bfloat16:
        tiles = 2 * ((tn // 2) * tm + (tn % 2) * ((tm + 1) // 2))
    return 2 * tiles * bm * bn * chunks * -(-(K // chunks) // bk) * bk


def _flops(x, w, chunks, buffers, out_val=None):
    return mma_flops(x.shape[0], w.shape[1], x.shape[1], chunks, x.dtype)


_op = register_kernel_op("streamed_gemm", _run, _fake, _flops)


def layout_smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of the instance for ``dtype``, from the
    source's layout in Python (``Bf16Cfg::SMEM``): bf16, 1024 bytes of
    alignment slack, 4 stages of X's (256 x 64) and W's (64 x 128) bf16
    tiles and two 64 x 128 staging tiles of C; f32 takes static shared
    memory only (0 dynamic)."""
    if dtype == torch.float32:
        return 0
    bm, bn, bk = TILES[dtype]
    return 1024 + 4 * (bm * bk * 2 + bk * bn * 2) + 2 * 64 * bn * 2


def max_active_clusters(device: Optional[torch.device] = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the bf16 kernel on ``device``
    (the current CUDA device if None; 0: its cluster cannot be placed), the
    count that sizes its persistent grid there; raises on a failed query.
    The source asks each device once."""
    with torch.cuda.device(device):
        n = _library().sg_max_active_clusters()
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {-n}")
    return n


def allgather_gemm(x_shard: torch.Tensor, w: torch.Tensor, *,
                   group: Optional[dist.ProcessGroup] = None,
                   buffers: int = 2) -> torch.Tensor:
    """Gather the K-sharded activation ``x_shard`` (M, K/P) over ``group``
    (the default group if None) along dim 1 in rank order, then contract
    the gathered (M, K) with the replicated ``w`` (K, N) through
    :func:`streamed_gemm`, one chunk per rank.  Equals
    :func:`allgather_gemm_reference` up to the f32 summation order."""
    xg = gather_columns(x_shard, group)
    return streamed_gemm(xg, w, chunks=dist.get_world_size(group),
                         buffers=buffers)
