"""glm4-9b [dense]: RoPE, GQA kv=2.  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=151552, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, name="glm4-smoke")
