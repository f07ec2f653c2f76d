"""Mamba-2 SSD chunk scan: the hand-written Hopper kernel and its autograd
wrapper.

Port of ``repro/kernels/ssd.py`` (the Pallas TPU kernel ``_ssd_kernel``).
The CUDA source is ``csrc/ssd_scan.cu``; its header says what bounds the
kernel on the card and how it is laid out.

y_t = C_t · h_t,   h_t = exp(dA_t) · h_{t-1} + B_t ⊗ xdt_t

Inputs (per flattened batch*heads row):
  xdt (BH, S, P)  dA (BH, S)  B (BH/r, S, N)  C (BH/r, S, N)

B and C come in group form: head row ``bh`` reads group row ``bh // r``,
``r = BH // B.shape[0]`` (``jnp.repeat``'s order: each group's heads
adjacent, BH flattened as (batch, head)).  ``r = 1`` is one row a head, the
interface of the JAX kernel.

``tiling(BH, r, S, P, N, dtype)`` says how the work is cut: one CTA a
head, the ring's stages, the CTAs and the CTAs an SM holds.  It is the only
copy of that rule:
``ssd_scan_fwd`` hands it to the source, which checks only that it has
such an instance.

Dispatch: the entry is the custom op ``repro_torch::ssd_scan_fwd``.
Tensors on the CPU take the plain ``ssd_chunked_ref`` on B and C repeated
to one row a head; tensors on a CUDA device launch the kernel or raise;
fake tensors (``FakeTensorMode``) take the op's shape function, which
builds and launches nothing.  There is no fallback between them.  The
checks below run on all three, so a call the kernel would refuse is
refused on the CPU too.  ``mma_flops`` is the op's FLOP formula: the
products the launch issues, every chunk staged as a 64-row tile.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from . import _build
from ._op import aligned16, register_kernel_op
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan_fwd", "ssd_scan", "expand_groups", "Tiling", "tiling",
           "bf16_layout", "bf16_tile", "f32_smem_bytes", "kernel_strides",
           "CHUNK", "HEAD_DIMS", "STATE_DIMS", "SMS", "BOUNDARY_CASES",
           "mma_flops"]

CHUNK = 64                     # the kernel's chunk tile (rows)
HEAD_DIMS = (16, 32, 64)       # P
STATE_DIMS = (16, 32, 64, 128)  # N
SMS = 132                      # streaming multiprocessors of an H100 SXM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_SM = 233472              # shared memory of an SM
_BF16_CTAS = 2                 # bf16 CTAs an SM
_MAX_STAGES = 4

# (name, BH, r, S, P, N, chunk, xbc view): every edge of ``tiling`` and of
# the kernel's masks: a chunk below 64 (8, 40) and a ragged S (the box's
# rows past S), each P and N (one B/C box of 16, 32 or 64 columns, two of
# 128; a state of fewer than 64 rows), group sizes 1, 2,
# 8 and 24 (mamba2's), and B/C as strided views of a conv output (B, S,
# conv_dim) as the model hands them over.  The card's checks (chip_smoke
# phase 7, tests/test_torch_kernels_cuda.py) hold the kernel to the plain
# version at each, in both dtypes.
BOUNDARY_CASES = (
    ("chunk8_p16_n16", 4, 1, 24, 16, 16, 8, False),
    ("chunk40_ragged_p32_n32", 4, 2, 100, 32, 32, 40, False),
    ("ragged_p64_n64", 3, 1, 130, 64, 64, 64, False),
    ("s63_p64_n128", 2, 2, 63, 64, 128, 64, False),
    ("s65_p16_n128", 8, 8, 65, 16, 128, 64, False),
    ("group24_p64_n128", 48, 24, 256, 64, 128, 64, False),
    ("group24_xbc_view", 48, 24, 192, 64, 128, 64, True),
    ("group8_xbc_view_ragged", 16, 8, 77, 32, 64, 64, True),
    ("group1_xbc_view_p16_n16", 4, 4, 40, 16, 16, 8, True),
)

# ssd_fwd(x, dA, B, C, y, dtype, BH, S, P, N, chunk, r, 7 strides,
#         stages, grid, stream): pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


class Tiling(NamedTuple):
    """How the scan of one call is cut across CTAs: a CTA a head, all
    of its P columns."""
    stages: int       # ring stages (1: no ring, the f32 CTA)
    units: int        # CTAs: BH
    ctas_per_sm: int  # CTAs an SM holds (shared memory and registers)

    @property
    def grid(self) -> Tuple[int, int]:
        """The launch's grid: one CTA a head."""
        return (self.units, 1)


@functools.lru_cache(maxsize=None)
def _library(edit: Optional[Callable[[str], str]] = None) -> ctypes.CDLL:
    """The built ``ssd_scan.cu``; ``edit`` builds a copy of its text
    changed by that function instead (``launch/ssd_trace.py``'s clock
    stamps)."""
    lib = _build.load("ssd_scan", edit)
    lib.ssd_fwd.argtypes = _ARGTYPES
    lib.ssd_fwd.restype = ctypes.c_int
    lib.ssd_bf16_tile.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    lib.ssd_bf16_tile.restype = ctypes.c_int
    return lib


def _round1k(n: int) -> int:
    return -(-n // 1024) * 1024


def bf16_layout(N: int, P: int) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory) of the bf16 CTA at state dim
    N and head dim P: a stage holds C's, B's and X's 64-row tiles; beside
    the ring, the bf16 copy of h (at least 64 rows: it also stages y's
    tile), the decayed X and the warps' cumsums; as many stages as fit two
    CTAs an SM, at most 4.  The source's ``SsdCfg``,
    which phase 2 of chip_smoke holds to it."""
    stage = 2 * _round1k(64 * 2 * N) + _round1k(64 * 2 * P)
    fixed = (1024 + _round1k(max(N, 64) * 2 * P)
             + _round1k(64 * 2 * P) + 4 * 64 * 4)
    budget = _SMEM_SM // _BF16_CTAS - 1024 - 256
    stages = min(_MAX_STAGES, (budget - fixed) // stage)
    return stages, fixed + stages * stage


def f32_smem_bytes(N: int, P: int) -> int:
    """Dynamic shared memory of the f32 CTA (the source's ``smem_f32``)."""
    return (64 * P + 2 * 64 * (N + 1) + 64 * 65 + N * P + 5 * 64) * 4


def tiling(BH: int, r: int, S: int, P: int, N: int,
           dtype: torch.dtype) -> Tiling:
    """The kernel's tiling of a scan of BH heads in groups of r, S rows,
    head dim P and state dim N in ``dtype``; ValueError on sizes it does
    not take.

    bf16 (TMA, wgmma): one head and all its P columns a CTA of one
    warpgroup, two CTAs an SM (a ring of two stages at N 128):
    mamba2-130m's serving shape (BH 192) is one wave on 132 SMs.  r does
    not change the unit: a head reads its group's B/C row.
    f32 (CUDA cores): one CTA a head, no ring."""
    if dtype not in _DTYPES:
        raise TypeError(f"no tiling for {dtype}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS} or state dim {N} "
                         f"not in {STATE_DIMS}")
    if min(BH, r, S) < 1 or BH % r:
        raise ValueError(f"unsupported sizes BH={BH}, r={r}, S={S}")
    if dtype == torch.float32:
        smem = f32_smem_bytes(N, P)
        return Tiling(1, BH, min(_SMEM_SM // (smem + 1024), 16))
    return Tiling(bf16_layout(N, P)[0], BH, _BF16_CTAS)


def bf16_tile(N: int, P: int) -> Tuple[int, int, int]:
    """The source's bf16 instance (N, P): its ring stages, dynamic shared
    memory, and the CTAs of it an SM of the current card holds at once
    (the occupancy calculator).  ValueError if there is no such
    instance."""
    out = [ctypes.c_int() for _ in range(3)]
    err = _library().ssd_bf16_tile(N, P, *(ctypes.byref(o) for o in out))
    if err == -1:
        raise ValueError(f"no bf16 instance N={N}, P={P}")
    if err:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return tuple(o.value for o in out)


def kernel_strides(t: torch.Tensor) -> Tuple[int, int]:
    """The (row, seq) element strides handed to the kernel: a dim of size 1
    is never stepped, so it takes the extent of the dims inside it, which
    the tensor map accepts, whatever stride the view gives it."""
    ss = t.stride(1) if t.shape[1] > 1 else t.shape[2]
    sb = t.stride(0) if t.shape[0] > 1 else t.shape[1] * ss
    return sb, ss


def _check(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, chunk: int) -> int:
    """Raise on anything the kernel does not take; returns r."""
    if not (xdt.device == dA.device == B.device == C.device):
        raise ValueError(f"xdt/dA/B/C on different devices: {xdt.device}, "
                         f"{dA.device}, {B.device}, {C.device}")
    if xdt.dtype not in _DTYPES or not (xdt.dtype == B.dtype == C.dtype):
        raise TypeError(f"xdt/B/C must share one dtype of {list(_DTYPES)}, "
                        f"got {xdt.dtype}, {B.dtype}, {C.dtype}")
    if dA.dtype != torch.float32:
        raise TypeError(f"dA must be float32, got {dA.dtype}")
    if xdt.dim() != 3 or dA.dim() != 2 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"want xdt (BH,S,P), dA (BH,S), B = C (BH/r,S,N); "
                         f"got {tuple(xdt.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    BH, S, P = xdt.shape
    G = B.shape[0]
    if tuple(dA.shape) != (BH, S) or B.shape[1] != S:
        raise ValueError(f"dA {tuple(dA.shape)} / B {tuple(B.shape)} do not "
                         f"match xdt {tuple(xdt.shape)}")
    if G < 1 or BH % G:
        raise ValueError(f"B/C rows {G} do not divide BH {BH}: want BH/r "
                         f"group rows")
    if P not in HEAD_DIMS or B.shape[2] not in STATE_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS} or state dim "
                         f"{B.shape[2]} not in {STATE_DIMS}")
    if BH < 1 or S < 1:
        raise ValueError(f"empty input: BH={BH}, S={S}")
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"chunk must be in [1, {CHUNK}], got {chunk}")
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit inner stride, got strides "
                             f"{t.stride()}")
    # bf16 tiles move by TMA: 16-byte aligned base and strides; f32 tiles
    # are read element by element
    if xdt.dtype == torch.bfloat16:
        for name, t in (("xdt", xdt), ("B", B), ("C", C)):
            if any(s % 8 for s in kernel_strides(t)) or not aligned16(t):
                raise ValueError(f"{name} rows are not 16-byte aligned "
                                 f"(strides {t.stride()})")
    return BH // G


def expand_groups(B: torch.Tensor, r: int) -> torch.Tensor:
    """Group form (BH/r, S, N) -> one row a head (BH, S, N), as
    ``jnp.repeat(B, r, 0)``."""
    return B if r == 1 else B.repeat_interleave(r, dim=0)


def ssd_scan_fwd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: Optional[int] = None
                 ) -> torch.Tensor:
    """xdt (BH, S, P), dA (BH, S) f32, B/C (BH/r, S, N) -> y (BH, S, P) in
    xdt.dtype.  ``chunk`` defaults to the COMET plan's
    (``autotune.ssd_chunk_len(S, P, N)``) and is clipped to S, as the JAX
    wrapper's ``min(chunk or ssd_chunk_len(S, P, N), S)``.

    On CUDA tensors this launches the kernel, adds one to
    ``ssd_scan_fwd.launches`` and one to ``ssd_scan_fwd.chunks[chunk]``
    (the launches at each chunk); on CPU tensors it returns the plain
    ``ssd_chunked_ref`` of B and C repeated to one row a head; on fake
    tensors an empty y of the shape."""
    if chunk is None:
        from .autotune import ssd_chunk_len   # autotune imports this module
        chunk = ssd_chunk_len(xdt.shape[1], xdt.shape[-1], B.shape[-1])
    chunk = min(chunk, xdt.shape[1])
    _check(xdt, dA, B, C, chunk)
    return _op(xdt, dA, B, C, chunk)


ssd_scan_fwd.launches = 0
ssd_scan_fwd.chunks = {}


def _run(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
         C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The op on real tensors: the plain version on the CPU, else the
    kernel's launch."""
    r = xdt.shape[0] // B.shape[0]
    if xdt.device.type == "cpu":
        return ssd_chunked_ref(xdt, dA, expand_groups(B, r),
                               expand_groups(C, r), chunk=chunk)
    out = _launch(_library(), xdt, dA, B, C, chunk, r)
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.chunks[chunk] = ssd_scan_fwd.chunks.get(chunk, 0) + 1
    return out


def _fake(xdt, dA, B, C, chunk):
    """The op's shape function: y, built and launched nowhere."""
    return xdt.new_empty(xdt.shape)


def mma_flops(BH: int, S: int, P: int, N: int, chunk: int,
              dtype: torch.dtype) -> int:
    """The products one launch issues, a head (CTA) at a time over
    ceil(S / chunk) chunks, each staged as a 64-row tile (rows past the
    chunk or S zero).

    bf16 (wgmma): S = C B^T (64 x 64 x N); (S o L) X (64 x P x 64) twice,
    once for S o L's bf16 high part and once for its low part; C h
    (64 x P x N); and the state update B^T Xd (N x P x 64, N rounded up
    to 64 rows, one m64 tile per 64 state rows).
    f32 (CUDA cores, as the loops run): C B^T on the tile's lower
    triangle, (S o L) X over each valid row's visible keys, C h over the
    valid rows, the state update over all 64 rows."""
    nc = -(-S // chunk)
    if dtype == torch.bfloat16:
        n64 = -(-N // CHUNK) * CHUNK
        per = 2 * CHUNK * (CHUNK * N + 2 * CHUNK * P + P * N + n64 * P)
        return BH * nc * per
    total = 0
    for ci in range(nc):
        rows = min(chunk, S - ci * chunk)
        total += (CHUNK * (CHUNK + 1) * N + P * rows * (rows + 1)
                  + 2 * rows * P * N + 2 * N * P * CHUNK)
    return BH * total


def _flops(xdt, dA, B, C, chunk, out_val=None):
    BH, S, P = xdt.shape
    return mma_flops(BH, S, P, B.shape[2], chunk, xdt.dtype)


_op = register_kernel_op("ssd_scan_fwd", _run, _fake, _flops)


def _launch(lib: ctypes.CDLL, xdt: torch.Tensor, dA: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int,
            r: int) -> torch.Tensor:
    """y of the checked CUDA inputs from ``lib``'s ``ssd_fwd``."""
    resolve_device(xdt.device)
    BH, S, P = xdt.shape
    N = B.shape[2]
    t = tiling(BH, r, S, P, N, xdt.dtype)
    out = torch.empty((BH, S, P), dtype=xdt.dtype, device=xdt.device)
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_fwd(xdt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                          C.data_ptr(), out.data_ptr(), _DTYPES[xdt.dtype],
                          BH, S, P, N, chunk, r,
                          *kernel_strides(xdt), dA.stride(0),
                          *kernel_strides(B), *kernel_strides(C),
                          t.stages, t.units, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    return out


class _SSDScan(torch.autograd.Function):
    """Forward through the kernel; backward recomputes through
    ``ssd_chunked_ref`` with chunk 64 when none is given, as the JAX
    package's ``custom_vjp`` does (there is no SSD backward kernel), on B
    and C repeated to one row a head inside autograd, so their gradients
    come back in group form, summed over each group's heads."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C, chunk):
        ctx.save_for_backward(xdt, dA, B, C)
        ctx.chunk = chunk
        return ssd_scan_fwd(xdt, dA, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        r = xs[0].shape[0] // xs[2].shape[0]
        with torch.enable_grad():
            out = ssd_chunked_ref(xs[0], xs[1], expand_groups(xs[2], r),
                                  expand_groups(xs[3], r),
                                  chunk=ctx.chunk or CHUNK)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None)


def ssd_scan(xdt, dA, B, C, chunk: Optional[int] = None) -> torch.Tensor:
    """SSD chunk scan with a recompute-based backward; B/C (BH/r, S, N)."""
    return _SSDScan.apply(xdt, dA, B, C, chunk)
