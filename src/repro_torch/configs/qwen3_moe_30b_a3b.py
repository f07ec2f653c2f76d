"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 (softmax router), GQA kv=4,
head_dim 128, qk-norm.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=0, vocab_size=151936, qk_norm=True,
        n_experts=128, top_k=8, moe_d_ff=768, router_type="softmax",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=512, n_experts=8, top_k=2, moe_d_ff=32,
        name="qwen3-moe-smoke")
