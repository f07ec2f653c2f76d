"""Plain PyTorch versions of the hand-written kernels (the correctness
references).

Each function is the mathematically transparent version of its kernel: the
CPU tests run it against the JAX package's reference, a kernel's wrapper
takes it for tensors that lie on the CPU, and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["attention_ref", "ssd_ref", "ssd_chunked_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); Hq % Hkv == 0.
    ``window``: optional sliding-window width.  q is aligned to the end of
    the kv axis (position offset ``Skv - Sq``).  Returns (B, Hq, Sq, D) in
    q.dtype; math in f32; rows with no visible key are 0.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal or window is not None:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)   # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ssd_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor) -> torch.Tensor:
    """Sequential SSD (Mamba-2 SSM) recurrence.

    xdt: (BH, S, P) dt-weighted inputs; dA: (BH, S) per-step log-decay
    (A * dt, A < 0); B/C: (BH, S, N) input/output projections.  Returns y
    (BH, S, P) in xdt.dtype, with h_t = exp(dA_t) h_{t-1} + B_t xdt_t^T and
    y_t = C_t @ h_t.  Math in f32.
    """
    BH, S, P = xdt.shape
    N = B.shape[-1]
    xf, df, Bf, Cf = xdt.float(), dA.float(), B.float(), C.float()
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        h = torch.exp(df[:, t])[:, None, None] * h \
            + Bf[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(xdt.dtype)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{k=j+1..i} dA_k for i >= j else -inf (log decay)."""
    S = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(S, device=dA.device)[:, None]
    j = torch.arange(S, device=dA.device)[None, :]
    return diff.masked_fill(i < j, float("-inf"))


def ssd_chunked_ref(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Chunked SSD: the blocked algorithm the kernel implements, an
    intra-chunk attention-like term plus an inter-chunk state carry.
    Equal to :func:`ssd_ref` up to rounding.  A ragged S is zero-padded
    (dA 0) to a multiple of ``chunk``, as the JAX package's kernel wrapper
    ``ssd_scan_fwd`` pads (its reference asserts a multiple instead)."""
    BH, S, P = xdt.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        y = ssd_chunked_ref(F.pad(xdt, (0, 0, 0, pad)), F.pad(dA, (0, pad)),
                            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                            chunk=chunk)
        return y[:, :S]
    nc = S // chunk
    xf = xdt.float().reshape(BH, nc, chunk, P)
    df = dA.float().reshape(BH, nc, chunk)
    Bf = B.float().reshape(BH, nc, chunk, N)
    Cf = C.float().reshape(BH, nc, chunk, N)

    cs = torch.cumsum(df, dim=-1)                      # (BH, nc, c)
    L = torch.exp(_segsum(df))                         # (BH, nc, c, c)
    # intra-chunk
    CB = torch.einsum("bzin,bzjn->bzij", Cf, Bf) * L
    y_intra = torch.einsum("bzij,bzjp->bzip", CB, xf)
    # chunk-final states
    decay_in = torch.exp(cs[..., -1:] - cs)            # (BH, nc, c)
    chunk_state = torch.einsum("bzcn,bzc,bzcp->bznp", Bf, decay_in, xf)
    # carry states across chunks: prev[z] is the state before chunk z
    total = torch.exp(cs[..., -1])                     # (BH, nc)
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=xdt.device)
    prev = []
    for z in range(nc):
        prev.append(h)
        h = total[:, z, None, None] * h + chunk_state[:, z]
    prev = torch.stack(prev, dim=1)                    # (BH, nc, N, P)
    y_inter = torch.einsum("bzcn,bznp,bzc->bzcp", Cf, prev, torch.exp(cs))
    y = (y_intra + y_inter).reshape(BH, S, P)
    return y.to(xdt.dtype)
