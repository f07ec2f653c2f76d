"""chameleon-34b [vlm]: early-fusion backbone — plain decoder over a VQ
token vocabulary (image frontend stubbed per brief); qk-norm as in the
paper.  [arXiv:2405.09818]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=65536, qk_norm=True,
        norm_type="rmsnorm", rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, name="chameleon-smoke")
