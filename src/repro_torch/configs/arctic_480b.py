"""arctic-480b — Snowflake Arctic: 128 routed experts top-2 + dense residual
FFN in parallel in every layer. [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, experts_per_token=2, moe_d_ff=4864,
    dense_residual=True, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512,
        n_experts=8, experts_per_token=2, moe_d_ff=96,
        dense_residual=True,
    )
