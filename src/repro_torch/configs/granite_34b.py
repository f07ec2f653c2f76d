"""granite-34b [dense]: 88-layer code model with MQA (kv=1).
[arXiv:2405.04324]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab_size=49152, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512, name="granite-smoke")
