"""gemma3-27b — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", family="localglobal",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144,
    sliding_window=1024, global_every=6, rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b-smoke", family="localglobal",
        n_layers=8, d_model=96, n_heads=6, n_kv_heads=3,
        d_ff=192, vocab=512, sliding_window=8, global_every=4,
    )
