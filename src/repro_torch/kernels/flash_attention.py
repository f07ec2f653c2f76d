"""FlashAttention: the hand-written Hopper kernel and its autograd wrapper.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``_fa_kernel``).  The CUDA source is ``csrc/flash_attention.cu``; its header
says what bounds the kernel on the card and how it is laid out.

``tiling(B, Hq, Hkv, Sq, Skv, D, dtype)`` says how the work is cut: the q
rows of one consumer, the keys of a K/V tile, the q heads a CTA serves
(sharing each K/V tile), the stages of the K/V ring and the grid.  It is the
only copy of that rule: ``flash_attention_fwd`` hands it to the source,
which checks only that it has such an instance and that the grid covers the
work.  ``tile_range`` is the source's range of K/V tiles a q tile reads.

Dispatch: the entry is the custom op ``repro_torch::flash_attention_fwd``.
Tensors on the CPU take the plain ``attention_ref``; tensors on a CUDA
device launch the kernel or raise.  Fake tensors (``FakeTensorMode``, the
dry run's) take the op's shape function, which builds and launches
nothing.  The checks run on all three, so the CPU refuses what the card
refuses.  There is no fallback between them.  ``mma_flops`` is the op's
FLOP formula (``torch.utils.flop_counter``): the products the launch
issues on its tiling, padding included, the tiles ``tile_range`` skips
left out.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from . import _build
from ._op import aligned16, register_kernel_op
from .ref import attention_ref

__all__ = ["flash_attention_fwd", "flash_attention", "HEAD_DIMS", "Tiling",
           "tiling", "tile_range", "kernel_strides", "smem_bytes",
           "source_tile", "mma_flops", "layout_smem_bytes",
           "BOUNDARY_CASES"]

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_MAX_ITEMS = 2 ** 31 - 1
SMS = 132        # streaming multiprocessors of an H100 SXM
# bf16: keys of a K/V tile (S, P and O of a consumer thread fit the 232
# registers it takes), and the ring's stages: as many as fit beside the q
# buffer of two tiles, at most 8 (the source's FaCfg)
_BF16_KEYS = 128
_SMEM_LIMIT = 232448 - 1024


def _bf16_stages(D: int, keys: int) -> int:
    q_bytes, kv_bytes = 64 * 2 * D, keys * 2 * D
    return min(8, (_SMEM_LIMIT - 1024 - 2 * q_bytes) // (2 * kv_bytes))


# (name, B, Hq, Hkv, Sq, Skv, D, causal, window, model layout): both sides
# of the bf16 q tile (64 rows a warpgroup, 128-row items of one head) and
# the key tile (128; f32 64), a single key tile, groups of 1, 3 and 16, a
# window inside one key tile and one across several, Sq > Skv with fully
# masked rows (whole items among them), Sq = 1, and every head dim.  The
# card's checks (chip_smoke phase 3, tests/test_torch_kernels_cuda.py) hold
# the kernel to ``attention_ref`` at each, in both dtypes.
BOUNDARY_CASES = (
    ("q63_k127", 1, 4, 2, 63, 127, 64, True, None, False),
    ("q64_k128", 1, 4, 2, 64, 128, 64, True, None, False),
    ("q65_k129", 1, 4, 2, 65, 129, 64, True, None, False),
    ("q127_k255_noncausal", 1, 2, 1, 127, 255, 128, False, None, False),
    ("q128_k256_group1", 1, 3, 3, 128, 256, 32, True, None, False),
    ("q129_k257_group1", 1, 3, 3, 129, 257, 32, True, None, False),
    ("single_key_tile", 2, 8, 2, 100, 100, 128, False, None, False),
    ("group1_mha", 2, 4, 4, 200, 200, 64, True, None, True),
    ("group3_odd", 1, 6, 2, 150, 150, 128, True, None, True),
    ("group16_glm4", 1, 32, 2, 300, 300, 128, True, None, True),
    ("window_30_in_a_tile", 1, 4, 2, 300, 300, 64, True, 30, False),
    ("window_300_across_tiles", 1, 4, 2, 700, 700, 128, True, 300, True),
    ("window_noncausal", 1, 2, 1, 200, 333, 32, False, 50, False),
    ("sq_gt_skv_masked_items", 1, 2, 2, 300, 130, 64, True, None, False),
    ("sq1_group16", 2, 32, 2, 1, 777, 128, True, None, True),
    ("sq1_skv1_d16", 1, 2, 2, 1, 1, 16, True, None, False),
    ("d16", 1, 4, 2, 72, 200, 16, True, None, False),
    ("d32_window", 2, 8, 2, 64, 192, 32, True, 100, False),
)

# fa_fwd(q, k, v, o, dtype, B, Hq, Hkv, Sq, Skv, D, 9 strides, scale,
#        causal, window, q_rows, keys, heads, stages, grid_x, grid_y,
#        stream): pointers and the stream as c_void_p, or ctypes would pass
# them as 32-bit ints
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p])


class Tiling(NamedTuple):
    """How the attention of one call is cut across CTAs."""
    q_rows: int      # q rows of one consumer (a warpgroup; the f32 CTA)
    consumers: int   # consumers a CTA: 2 warpgroups (bf16), 1 (f32)
    keys: int        # keys of a K/V tile
    heads: int       # q heads of one GQA group a CTA serves
    stages: int      # K/V ring stages (1: no ring)
    items: int       # work items: (batch, kv head, heads, q tile)
    grid: Tuple[int, int]

    @property
    def rows(self) -> int:
        """q rows of each of its heads a CTA holds."""
        return self.q_rows * self.consumers // self.heads


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.fa_fwd.argtypes = _ARGTYPES
    lib.fa_fwd.restype = ctypes.c_int
    lib.fa_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fa_smem_bytes.restype = ctypes.c_int
    lib.fa_bf16_tile.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.fa_bf16_tile.restype = ctypes.c_int
    return lib


def tiling(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
           dtype: torch.dtype, sms: int = SMS) -> Tiling:
    """The kernel's tiling of q (B, Hq, Sq, D) against k/v (B, Hkv, Skv, D)
    in ``dtype`` on a card of ``sms`` SMs; ValueError if the grid does not
    fit.

    bf16 (TMA, wgmma, two consumer warpgroups of 64 q rows): K/V tiles of
    ``_BF16_KEYS`` keys in a ring as deep as shared memory allows.  A
    work item is a pair of q heads of one GQA group at the same 64 rows
    when the group is even, so each K/V tile in shared memory serves both;
    an odd group (1 included) takes one head an item, 128 rows of it.
    ``items`` = B x Hkv x pairs x q tiles; the grid is ``min(items, sms)``
    persistent CTAs, which walk the items longest (last causal q tile)
    first.
    f32 (CUDA cores): one CTA per 64 q rows of one (batch, q head), 64-key
    tiles, grid (q tiles, B x Hq)."""
    if dtype not in _DTYPES:
        raise TypeError(f"no tiling for {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if min(B, Hq, Hkv, Sq, Skv) < 1 or Hq % Hkv:
        raise ValueError(f"unsupported sizes B={B}, Hq={Hq}, Hkv={Hkv}, "
                         f"Sq={Sq}, Skv={Skv}")
    if dtype == torch.float32:
        if B * Hq > _MAX_GRID_Y:
            raise ValueError(f"unsupported sizes: B*Hq={B * Hq} exceeds the "
                             f"grid's {_MAX_GRID_Y}")
        nqt = -(-Sq // 64)
        return Tiling(64, 1, 64, 1, 1, nqt * B * Hq, (nqt, B * Hq))
    group = Hq // Hkv
    heads = 2 if group % 2 == 0 else 1
    keys = _BF16_KEYS
    items = B * Hkv * (group // heads) * -(-Sq // (128 // heads))
    if items > _MAX_ITEMS:
        raise ValueError(f"unsupported sizes: {items} work items exceed "
                         f"{_MAX_ITEMS}")
    return Tiling(64, 2, keys, heads, _bf16_stages(D, keys), items,
                  (min(items, sms), 1))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_range(Sq: int, Skv: int, q0: int, rows: int, keys: int,
               causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """[lo, hi): the ``keys``-key tiles that hold a key visible to some of
    the q rows [q0, q0 + rows) (q aligned to the end of kv); the source's
    ``tile_range``."""
    nk = -(-Skv // keys)
    off = Skv - Sq
    q_last = min(q0 + rows, Sq) - 1 + off
    lo, hi = 0, nk
    if causal:
        hi = 0 if q_last < 0 else min(nk, q_last // keys + 1)
    if window is not None:
        k_first = q0 + off - window + 1
        if k_first > 0:
            lo = min(k_first // keys, nk)
    return lo, hi


def smem_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of the kernel's instance (from the source)."""
    return _library().fa_smem_bytes(_DTYPES[dtype], D)


def layout_smem_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of the instance, from the source's layout in
    Python (``FaCfg::SMEM``, ``f32_smem``): bf16, 1024 bytes of alignment
    slack, two q tiles of 64 rows and ``_bf16_stages`` stages of a K and a
    V tile of ``_BF16_KEYS`` keys; f32, the q tile (odd pitch), a K and a V
    tile of 64 keys and the 64 x 64 scores.  ``smem_bytes`` reads the
    built library's (on the card), which chip_smoke holds it to."""
    if dtype == torch.float32:
        return (64 * (D + 1) + 2 * 64 * D + 64 * 64) * 4
    q_bytes, kv_bytes = 64 * 2 * D, _BF16_KEYS * 2 * D
    return 1024 + 2 * q_bytes + 2 * _bf16_stages(D, _BF16_KEYS) * kv_bytes


def source_tile(D: int) -> Tuple[int, int]:
    """(keys a K/V tile, ring stages) of the source's bf16 instance of head
    dim D, which ``tiling`` must name."""
    keys, stages = ctypes.c_int(), ctypes.c_int()
    if _library().fa_bf16_tile(D, ctypes.byref(keys), ctypes.byref(stages)):
        raise ValueError(f"no bf16 instance of head dim {D}")
    return keys.value, stages.value


def kernel_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, head, seq) element strides handed to the kernel: a dim
    of size 1 is never stepped, so it takes the head dim's extent, which
    the tensor map accepts, whatever stride the view gives it."""
    return tuple(st if n > 1 else t.shape[3]
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> Tiling:
    """Raise on anything the kernel does not take; returns the tiling (on
    an H100 SXM's 132 SMs)."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v must share one dtype of {list(_DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,Sq,D), k = v (B,Hkv,Skv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 \
            or Hq % k.shape[1] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    t = tiling(B, Hq, k.shape[1], Sq, k.shape[2], D, q.dtype)
    # bf16 tiles move by TMA: a 16-byte aligned base and strides of a
    # multiple of 16 bytes, none of them 0; f32 tiles are read element by
    # element
    bf16 = q.dtype == torch.bfloat16
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim, "
                             f"got strides {x.stride()}")
        if bf16 and (any(st % 8 or st == 0 for st in kernel_strides(x))
                     or not aligned16(x)):
            raise ValueError(f"{name} rows are not 16-byte aligned "
                             f"(strides {x.stride()}): TMA needs a 16-byte "
                             f"aligned base and nonzero strides of a "
                             f"multiple of 16 bytes")
    return t


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D), q.dtype.

    On CUDA tensors this launches the kernel and adds one to
    ``flash_attention_fwd.launches``; on CPU tensors it returns the plain
    ``attention_ref``; on fake tensors an empty result of the shape."""
    _check(q, k, v, window)     # on every device: the CPU refuses alike
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _op(q, k, v, bool(causal), float(scale), window)


flash_attention_fwd.launches = 0


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         scale: float, window: Optional[int]) -> torch.Tensor:
    """The op on real tensors: the plain version on the CPU, else the
    kernel's launch."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window)
    resolve_device(q.device)
    B, Hq, Sq, D = q.shape
    t = tiling(B, Hq, k.shape[1], Sq, k.shape[2], D, q.dtype, _sms(q.device))
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), _DTYPES[q.dtype],
                         B, Hq, Hkv, Sq, Skv, D, *kernel_strides(q),
                         *kernel_strides(k), *kernel_strides(v),
                         float(scale), int(bool(causal)),
                         -1 if window is None else int(window),
                         t.q_rows, t.keys, t.heads, t.stages, *t.grid,
                         stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    return out


def _fake(q, k, v, causal, scale, window):
    """The op's shape function: the output, built and launched nowhere."""
    return q.new_empty(q.shape)


def mma_flops(q_shape, k_shape, dtype: torch.dtype, causal: bool,
              window: Optional[int]) -> int:
    """The products one launch issues: for every work item (a CTA's q
    tile of its heads) each K/V tile of ``tile_range`` costs Q K^T and P V
    over the tile's whole q rows and keys, padding included; an item with
    no visible key issues none.  bf16: 128 q rows an item (two warpgroups
    of 64), ``keys``-key tiles; f32: 64 q rows a CTA, 64-key tiles."""
    B, Hq, Sq, D = q_shape
    Hkv, Skv = k_shape[1], k_shape[2]
    t = tiling(B, Hq, Hkv, Sq, Skv, D, dtype)
    if dtype == torch.float32:
        rows, units = 64, B * Hq
    else:
        rows, units = t.rows, B * Hkv * (Hq // Hkv // t.heads)
    tiles = 0
    for q0 in range(0, Sq, rows):
        lo, hi = tile_range(Sq, Skv, q0, rows, t.keys, causal, window)
        tiles += max(0, hi - lo)
    return 4 * units * tiles * (t.q_rows * t.consumers) * t.keys * D


def _flops(q, k, v, causal, scale, window, out_val=None):
    return mma_flops(tuple(q.shape), tuple(k.shape), q.dtype, causal, window)


_op = register_kernel_op("flash_attention_fwd", _run, _fake, _flops)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel; backward recomputes attention through
    ``attention_ref`` (as the JAX package's ``custom_vjp`` does), so no
    S/P matrices are stored."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, scale, window)
        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, scale, window = ctx.opts
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_ref(*xs, causal=causal, scale=scale,
                                window=window)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """FlashAttention with a recompute-based backward."""
    return _FlashAttention.apply(q, k, v, causal, scale, window)
