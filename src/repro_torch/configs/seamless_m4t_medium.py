"""seamless-m4t-medium [audio]: enc-dec backbone (12 enc + 12 dec layers,
LayerNorm); speech frontend stubbed — input_specs() provides precomputed
frame embeddings at seq/enc_ratio.  [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab_size=256206,
        norm_type="layernorm", enc_ratio=8, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=1024, name="seamless-smoke")
