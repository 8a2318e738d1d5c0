"""rwkv6-1.6b — "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, rwkv_head_dim=64,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="rwkv",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, vocab=512, rwkv_head_dim=32,
    )
