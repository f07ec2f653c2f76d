"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA.  [arXiv:2412.08905]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=200064, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, name="phi4-smoke")
