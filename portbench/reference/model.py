"""The decoder's forward in float32, from its equations, one layer at a
time.

A layer: x += mixer(rmsnorm(x)); x += mlp(rmsnorm(x)).  The mixer is
grouped-query attention (RoPE over the whole head, rotate-half form;
causal, and within ``window`` of the query where the config sets one), a
Mamba-2 SSD mixer (in-projection to z|x|B|C|dt, causal depthwise conv and
SiLU, the scan h_t = exp(dt A) h_{t-1} + dt B_t x_t^T, y_t = C_t h_t + D
x_t, a gated RMS norm, the out-projection), or both side by side, mixed
as 0.5 (a alpha_attn + s alpha_ssm) (Hymba's parallel heads).  The MLP is
SwiGLU: (silu(x wg) * (x wi)) wo.  The logits are the final RMS norm's
output times ``unembed``.

Every product runs in float32 with TF32 off (:func:`strict_f32`).  With
``lowp="fp8"`` every matmul's operands, attention's q, k, v and
probabilities included, are rounded to float8 (e4m3, one scale a tensor)
and their cotangents to e5m2: the control that a lower precision than the
configuration's has to fail.  ``lowp="bf16"`` rounds the same operands
and cotangents to bfloat16, the configuration's own precision (a witness
of how far that precision alone moves the numbers compared).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .params import dims

F32 = torch.float32
NEG = -1e30
_E4M3, _E5M2 = 448.0, 57344.0


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round8(x: torch.Tensor, fmt) -> torch.Tensor:
    top = _E4M3 if fmt == torch.float8_e4m3fn else _E5M2
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(fmt).to(F32) * s


class _FP8(torch.autograd.Function):
    """Rounds to e4m3 going forward and the cotangent to e5m2 coming back
    (an fp8 training recipe's formats)."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


class _BF16(torch.autograd.Function):
    """Rounds to bfloat16 going forward and the cotangent coming back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(F32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(F32)


_ROUND = {"fp8": _FP8, "bf16": _BF16}


class Ref:
    """The reference model of ``cfg`` (a config dict) over ``weights``
    (the benchmark's tree); each layer's weights are taken in float32 when
    the layer runs (:meth:`layer_weights`)."""

    def __init__(self, cfg: Dict, weights: Dict, lowp: Optional[str] = None):
        self.cfg, self.w, self.lowp = cfg, weights, lowp
        self.z = dims(cfg)
        self.eps = cfg.get("norm_eps", 1e-6)

    # ---------------------------------------------------------- precision
    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _ROUND[self.lowp].apply(x) if self.lowp else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)

    # ------------------------------------------------------------ weights
    def layer_weights(self, l: int, grad: bool = False) -> Dict:
        def take(t):
            if isinstance(t, dict):
                return {k: take(v) for k, v in t.items()}
            return t[l].to(F32, copy=True).requires_grad_(grad)
        return take(self.w["layers"])

    def head_weights(self, grad: bool = False) -> Dict:
        return {"final_norm": self.w["final_norm"]["scale"]
                .to(F32, copy=True).requires_grad_(grad),
                "unembed": self.w["unembed"].to(F32, copy=True)
                .requires_grad_(grad)}

    # ------------------------------------------------------------- pieces
    def rms(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x, pos):
        """x (B, S, H, D) at positions ``pos`` (S,)."""
        half = x.shape[-1] // 2
        freqs = 1.0 / (self.cfg.get("rope_theta", 10000.0) ** (
            torch.arange(half, dtype=F32, device=x.device) / half))
        ang = pos.to(F32)[:, None] * freqs
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def attention(self, W, h, block: int = 512):
        B, S, _ = h.shape
        H, Hkv, hd = self.z["H"], self.z["Hkv"], self.z["hd"]
        g = H // Hkv
        win = self.cfg.get("window")
        pos = torch.arange(S, device=h.device)
        q = self.rope(self.mm(h, W["wq"]).view(B, S, H, hd), pos)
        k = self.rope(self.mm(h, W["wk"]).view(B, S, Hkv, hd), pos)
        v = self.mm(h, W["wv"]).view(B, S, Hkv, hd)
        q = self.q(q).view(B, S, Hkv, g, hd).permute(0, 2, 3, 1, 4)
        k, v = self.q(k).transpose(1, 2), self.q(v).transpose(1, 2)
        outs = []
        for q0 in range(0, S, block):
            q1 = min(S, q0 + block)
            k0 = 0 if win is None else max(0, q0 - win + 1)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q[:, :, :, q0:q1],
                             k[:, :, k0:q1]) / math.sqrt(hd)
            qp = pos[q0:q1, None]
            kp = pos[None, k0:q1]
            ok = kp <= qp
            if win is not None:
                ok = ok & (qp - kp < win)
            p = torch.softmax(torch.where(ok, s, NEG), dim=-1)
            outs.append(torch.einsum("bhgqk,bhkd->bhgqd", self.q(p),
                                     v[:, :, k0:q1]))
        o = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, S, -1)
        return self.mm(o, W["wo"])

    def ssd(self, x, dA, Bh, Ch, chunk: int = 64):
        """y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<u<=t} dA_u) x_s, chunk by
        chunk.  x (B, S, nh, P); dA (B, S, nh); Bh, Ch (B, S, nh, N)."""
        B, S, nh, P = x.shape
        pad = (-S) % chunk
        if pad:
            x, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bh, Ch))
            dA = F.pad(dA, (0, 0, 0, pad))
        c = (S + pad) // chunk
        x, Bh, Ch = (t.reshape(B, c, chunk, nh, -1) for t in (x, Bh, Ch))
        cs = torch.cumsum(dA.reshape(B, c, chunk, nh), dim=2)
        seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (b,c,l,s,h)
        tri = torch.ones(chunk, chunk, dtype=torch.bool,
                         device=x.device).tril()[None, None, :, :, None]
        decay = torch.exp(torch.where(tri, seg, NEG))
        cb = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)
        y = torch.einsum("bclsh,bcshp->bclhp", cb * decay, x)
        to_end = torch.exp(cs[:, :, -1:, :] - cs)               # (b,c,l,h)
        states = torch.einsum("bclhn,bclh,bclhp->bchnp", Bh, to_end, x)
        h = torch.zeros_like(states[:, 0])
        carry = []
        for i in range(c):
            carry.append(h)
            h = torch.exp(cs[:, i, -1, :])[:, :, None, None] * h \
                + states[:, i]
        carry = torch.stack(carry, dim=1)                    # (b,c,h,n,p)
        y = y + torch.einsum("bclhn,bchnp,bclh->bclhp", Ch, carry,
                             torch.exp(cs))
        return y.reshape(B, c * chunk, nh, P)[:, :S]

    def ssm(self, W, h):
        z = self.z
        B, S, _ = h.shape
        di, ng, ns, nh, hp, K = (z["di"], z["ng"], z["ns"], z["nh"],
                                 z["hp"], z["K"])
        proj = self.mm(h, W["in_proj"])
        zg = proj[..., :di]
        xbc = proj[..., di:2 * di + 2 * ng * ns]
        dt_raw = proj[..., 2 * di + 2 * ng * ns:]
        up = F.pad(xbc, (0, 0, K - 1, 0))
        conv = sum(up[:, i:i + S] * W["conv_w"][i] for i in range(K))
        xbc = F.silu(conv + W["conv_b"])
        xs = xbc[..., :di].reshape(B, S, nh, hp)
        r = nh // ng
        Bh = xbc[..., di:di + ng * ns].reshape(B, S, ng, ns) \
            .repeat_interleave(r, dim=2)
        Ch = xbc[..., di + ng * ns:].reshape(B, S, ng, ns) \
            .repeat_interleave(r, dim=2)
        dt = F.softplus(dt_raw + W["dt_bias"])
        dA = dt * -torch.exp(W["A_log"])
        y = self.ssd(self.q(xs * dt[..., None]), dA, self.q(Bh), self.q(Ch))
        y = (y + xs * W["D"][:, None]).reshape(B, S, di)
        return self.mm(self.rms(y * F.silu(zg), W["norm_scale"]),
                       W["out_proj"])

    # -------------------------------------------------------------- model
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embedding"][tokens].to(F32)

    def layer(self, W, x):
        h = self.rms(x, W["norm1"]["scale"])
        if "attn" in W and "ssm" in W:
            mix = 0.5 * (self.attention(W["attn"], h) * W["alpha_attn"]
                         + self.ssm(W["ssm"], h) * W["alpha_ssm"])
        elif "ssm" in W:
            mix = self.ssm(W["ssm"], h)
        else:
            mix = self.attention(W["attn"], h)
        x = x + mix
        if "mlp" in W:
            m, hh = W["mlp"], self.rms(x, W["norm2"]["scale"])
            x = x + self.mm(F.silu(self.mm(hh, m["wg"]))
                            * self.mm(hh, m["wi"]), m["wo"])
        return x

    def logits(self, Wh, x):
        return self.mm(self.rms(x, Wh["final_norm"]), Wh["unembed"])

    @torch.no_grad()
    def last_logits(self, tokens: torch.Tensor, n: int) -> torch.Tensor:
        """The logits (B, n, Vp) of the last ``n`` positions of a causal
        forward over ``tokens`` (B, S)."""
        x = self.embed(tokens)
        for l in range(self.z["L"]):
            x = self.layer(self.layer_weights(l), x)
        return self.logits(self.head_weights(), x[:, -n:])


def xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int
         ) -> torch.Tensor:
    """Summed token NLL over the real vocab (the padded entries masked)."""
    Vp = logits.shape[-1]
    if Vp > vocab:
        logits = logits.masked_fill(
            torch.arange(Vp, device=logits.device) >= vocab, NEG)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - ll).sum()
