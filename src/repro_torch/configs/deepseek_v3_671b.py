"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8) + MTP.
First 3 layers dense (d_ff=18432); MoE expert hidden = 2048.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                  # dense layers
    vocab=129280,
    n_experts=256, experts_per_token=8, moe_d_ff=2048,
    n_shared_experts=1, first_dense_layers=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=192, vocab=512,
        n_experts=8, experts_per_token=2, moe_d_ff=64,
        n_shared_experts=1, first_dense_layers=2,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        mtp_depth=1,
    )
