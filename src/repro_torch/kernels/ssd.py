"""Mamba-2 SSD chunk scan: the hand-written Hopper kernel and its autograd
wrapper.

Port of ``repro/kernels/ssd.py`` (the Pallas TPU kernel ``_ssd_kernel``).
The CUDA source is ``csrc/ssd_scan.cu``; its header says what bounds the
kernel on the card and how it is laid out.

y_t = C_t · h_t,   h_t = exp(dA_t) · h_{t-1} + B_t ⊗ xdt_t

Inputs (per flattened batch*heads row):
  xdt (BH, S, P)  dA (BH, S)  B (BH, S, N)  C (BH, S, N)

Dispatch: tensors on the CPU take the plain ``ssd_chunked_ref``; tensors
on a CUDA device launch the kernel or raise.  There is no fallback between
the two.  The checks below run on both, so a call the kernel would refuse
is refused on the CPU too.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import resolve_device
from . import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan_fwd", "ssd_scan", "smem_bytes", "CHUNK", "HEAD_DIMS",
           "STATE_DIMS"]

CHUNK = 64                     # the kernel's chunk tile (rows)
HEAD_DIMS = (16, 32, 64)       # P
STATE_DIMS = (16, 32, 64, 128)  # N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# ssd_fwd(x, dA, B, C, y, dtype, BH, S, P, N, chunk, 7 strides, stream):
# pointers and the stream as c_void_p, or ctypes would pass them as 32-bit
# ints
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_fwd.argtypes = _ARGTYPES
    lib.ssd_fwd.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, P: int, N: int) -> int:
    """Dynamic shared memory of the kernel instance for these sizes."""
    return _library().ssd_smem_bytes(_DTYPES[dtype], N, P)


def _check(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, chunk: int) -> None:
    """Raise on anything the kernel does not take."""
    if not (xdt.device == dA.device == B.device == C.device):
        raise ValueError(f"xdt/dA/B/C on different devices: {xdt.device}, "
                         f"{dA.device}, {B.device}, {C.device}")
    if xdt.dtype not in _DTYPES or not (xdt.dtype == B.dtype == C.dtype):
        raise TypeError(f"xdt/B/C must share one dtype of {list(_DTYPES)}, "
                        f"got {xdt.dtype}, {B.dtype}, {C.dtype}")
    if dA.dtype != torch.float32:
        raise TypeError(f"dA must be float32, got {dA.dtype}")
    if xdt.dim() != 3 or dA.dim() != 2 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"want xdt (BH,S,P), dA (BH,S), B = C (BH,S,N); got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    BH, S, P = xdt.shape
    if tuple(dA.shape) != (BH, S) or tuple(B.shape[:2]) != (BH, S):
        raise ValueError(f"dA {tuple(dA.shape)} / B {tuple(B.shape)} do not "
                         f"match xdt {tuple(xdt.shape)}")
    if P not in HEAD_DIMS or B.shape[2] not in STATE_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS} or state dim "
                         f"{B.shape[2]} not in {STATE_DIMS}")
    if BH < 1 or S < 1:
        raise ValueError(f"empty input: BH={BH}, S={S}")
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"chunk must be in [1, {CHUNK}], got {chunk}")
    # bf16 tiles move in 16-byte cp.async chunks: rows must start 16-byte
    # aligned; f32 tiles are read element by element
    align = 8 if xdt.dtype == torch.bfloat16 else 1
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit inner stride, got strides "
                             f"{t.stride()}")
    for name, t in (("xdt", xdt), ("B", B), ("C", C)):
        if any(s % align for s in t.stride()[:2]) \
                or t.data_ptr() % (2 * align):
            raise ValueError(f"{name} rows are not 16-byte aligned "
                             f"(strides {t.stride()})")


def ssd_scan_fwd(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: Optional[int] = None
                 ) -> torch.Tensor:
    """xdt (BH, S, P), dA (BH, S) f32, B/C (BH, S, N) -> y (BH, S, P) in
    xdt.dtype.  ``chunk`` defaults to the kernel's 64 and is clipped to S
    (the JAX rule ``min(chunk, S)``).

    On CUDA tensors this launches the kernel and adds one to
    ``ssd_scan_fwd.launches``; on CPU tensors it returns the plain
    ``ssd_chunked_ref``."""
    chunk = min(CHUNK if chunk is None else chunk, xdt.shape[1])
    _check(xdt, dA, B, C, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunked_ref(xdt, dA, B, C, chunk=chunk)
    resolve_device(xdt.device)
    BH, S, P = xdt.shape
    N = B.shape[2]
    out = torch.empty((BH, S, P), dtype=xdt.dtype, device=xdt.device)
    lib = _library()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_fwd(xdt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                          C.data_ptr(), out.data_ptr(), _DTYPES[xdt.dtype],
                          BH, S, P, N, chunk,
                          xdt.stride(0), xdt.stride(1), dA.stride(0),
                          B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                          stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan_fwd.launches += 1
    return out


ssd_scan_fwd.launches = 0


class _SSDScan(torch.autograd.Function):
    """Forward through the kernel; backward recomputes through
    ``ssd_chunked_ref`` with chunk 64 when none is given, as the JAX
    package's ``custom_vjp`` does (there is no SSD backward kernel)."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C, chunk):
        ctx.save_for_backward(xdt, dA, B, C)
        ctx.chunk = chunk
        return ssd_scan_fwd(xdt, dA, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ssd_chunked_ref(*xs, chunk=ctx.chunk or CHUNK)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None)


def ssd_scan(xdt, dA, B, C, chunk: Optional[int] = None) -> torch.Tensor:
    """SSD chunk scan with a recompute-based backward."""
    return _SSDScan.apply(xdt, dA, B, C, chunk)
