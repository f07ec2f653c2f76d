"""Model configuration covering all assigned architecture families (a copy
of the JAX package's, field for field; the port keeps its own)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["ModelConfig", "pad_to_multiple"]


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"            # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1000

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla | none (ssm) | parallel (hybrid)
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: Optional[int] = None     # sliding-window width (None = global)
    # MLA (DeepSeek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- FFN / MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # DeepSeek: leading dense layers
    router_type: str = "softmax"     # softmax | sigmoid (DeepSeek noaux bias)
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_kernel: int = 4

    # --- enc-dec ---
    n_enc_layers: int = 0
    enc_ratio: int = 8               # encoder frames = seq // enc_ratio (stub frontend)

    # --- misc ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad: int = 128             # pad vocab to this multiple (sharding)

    # --- runtime knobs (not architecture) ---
    use_kernels: bool = False        # route hot ops through the hand-written kernels
    remat: bool = True
    remat_policy: str = "full"       # full (nothing saveable) | dots | none
    softmax_strategy: str = "auto"   # dist | gather | auto (COMET-planned)
    seq_shard: bool = False          # sequence-parallel residual stream (hillclimb)
    tensor_parallel: bool = True     # False: replicate params (small models)
    banded_attention: bool = True    # O(S*2W) sliding-window path
    fsdp: bool = False               # ZeRO-3: shard params over data too
                                     # (required to fit 671B+Adam on a pod)
    scan_unroll: int = 1             # layer-scan unroll (9999 = full; used by
                                     # measurement dry-runs: XLA cost_analysis
                                     # does not scale while-loop bodies)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def has_attention(self) -> bool:
        return self.attn_type != "none"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        hd = self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn_type == "mla":
            att = (self.q_lora_rank * d + self.q_lora_rank * self.n_heads
                   * (128 + self.rope_head_dim)
                   + d * (self.kv_lora_rank + self.rope_head_dim)
                   + self.kv_lora_rank * self.n_heads * (128 + self.v_head_dim)
                   + self.n_heads * self.v_head_dim * d)
        elif self.attn_type == "none":
            att = 0
        else:
            att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn_dense = 3 * d * self.d_ff
        if self.is_moe:
            ffn = (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff \
                + d * self.n_experts
            dense_part = self.first_dense_layers * ffn_dense
            moe_part = (L - self.first_dense_layers) * ffn
            ffn_total = dense_part + moe_part
        else:
            ffn_total = L * ffn_dense
        ssm = 0
        if self.has_ssm:
            di, cd = self.d_inner, self.conv_dim
            ssm = (d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state
                        + self.ssm_nheads)
                   + cd * self.conv_kernel + di * d + 3 * self.ssm_nheads)
            ssm *= L
        att_total = L * att
        if self.is_encdec:
            att_total += self.n_enc_layers * att * 2  # enc self + dec cross
            ffn_total += self.n_enc_layers * ffn_dense
        return int(emb + att_total + ffn_total + ssm)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        full = self.n_params()
        all_experts = (L - self.first_dense_layers) * self.n_experts * 3 * d * self.moe_d_ff
        active = (L - self.first_dense_layers) * (self.top_k + self.n_shared_experts) \
            * 3 * d * self.moe_d_ff
        return int(full - all_experts + active)
