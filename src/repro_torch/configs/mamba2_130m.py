"""mamba2-130m [ssm]: attention-free SSD (state-space duality); mixer-only
blocks (d_ff=0), tied embeddings.  The COMET attention-collective technique
is inapplicable (DESIGN.md §Arch-applicability); the SSD chunk dataflow is
modeled instead.  [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
        attn_type="none", d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        conv_kernel=4, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, vocab_size=512, ssm_state=16,
        ssm_headdim=16, name="mamba2-smoke")
