"""hymba-1.5b [hybrid]: parallel attention + SSM heads per layer; sliding
window (1024) on all layers — the 3 global-attention layers of the source
model are approximated by the window to keep the scanned stack homogeneous
(DESIGN.md §5); meta-tokens omitted.  [arXiv:2411.13676]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001, window=1024,
        ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        conv_kernel=4, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, window=32, ssm_state=8, ssm_headdim=16,
        name="hymba-smoke")
