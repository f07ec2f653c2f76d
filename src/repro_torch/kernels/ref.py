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

__all__ = ["attention_ref"]


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
