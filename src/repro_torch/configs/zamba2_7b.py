"""zamba2-7b — Mamba2 backbone + shared attention block every 6 layers.
81 SSM layers = 13 groups of 6 + 3 tail; the attention/MLP block params are
SHARED across all 13 application points (zamba's trick). [arXiv:2411.15242;
unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    attn_every=6, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=32,
        attn_every=3,  # 2 groups + 2 tail layers
    )
