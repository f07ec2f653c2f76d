"""minitron-4b [dense]: pruned Nemotron; very large vocab (256000) makes
the vocab-sharded logits/loss the dominant memory term.  [arXiv:2407.14679]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab_size=256000, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=1024, name="minitron-smoke")
