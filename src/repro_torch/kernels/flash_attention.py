"""FlashAttention: the hand-written Hopper kernel and its autograd wrapper.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``_fa_kernel``).  The CUDA source is ``csrc/flash_attention.cu``; its header
says what bounds the kernel on the card and how it is laid out.

Dispatch: tensors on the CPU take the plain ``attention_ref``; tensors on a
CUDA device launch the kernel or raise.  There is no fallback between the
two.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import resolve_device
from . import _build
from .ref import attention_ref

__all__ = ["flash_attention_fwd", "flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

# fa_fwd(q, k, v, o, dtype, B, Hq, Hkv, Sq, Skv, D, 9 strides, scale,
#        causal, window, stream): pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.fa_fwd.argtypes = _ARGTYPES
    lib.fa_fwd.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """Raise on anything the kernel does not take."""
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
    if Sq < 1 or k.shape[2] < 1 or B * Hq > _MAX_GRID_Y:
        raise ValueError(f"unsupported sizes B*Hq={B * Hq}, Sq={Sq}, "
                         f"Skv={k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    # bf16 tiles move in 16-byte cp.async chunks: rows must start 16-byte
    # aligned; f32 tiles are read element by element
    align = 8 if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim, "
                             f"got strides {t.stride()}")
        if any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % (2 * align):
            raise ValueError(f"{name} rows are not 16-byte aligned "
                             f"(strides {t.stride()})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D), q.dtype.

    On CUDA tensors this launches the kernel and adds one to
    ``flash_attention_fwd.launches``; on CPU tensors it returns the plain
    ``attention_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window)
    _check(q, k, v, window)
    resolve_device(q.device)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), _DTYPES[q.dtype],
                         B, Hq, Hkv, Sq, Skv, D,
                         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                         float(scale), int(bool(causal)),
                         -1 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


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
