"""deepseek-v3-671b [moe]: MLA (q-LoRA 1536 / kv-LoRA 512 / rope 64),
1 shared + 256 routed experts top-8 (sigmoid aux-free router), 3 leading
dense layers (dense d_ff 18432; per-expert d_ff 2048 per the brief).
MTP head omitted (DESIGN.md §5).  [arXiv:2412.19437]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18432, vocab_size=129280,
        attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        rope_head_dim=64, v_head_dim=128,
        n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
        first_dense_layers=3, router_type="sigmoid",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, q_lora_rank=32, kv_lora_rank=16,
        rope_head_dim=8, v_head_dim=16, n_experts=8, top_k=2,
        moe_d_ff=32, first_dense_layers=1, name="deepseek-smoke")
