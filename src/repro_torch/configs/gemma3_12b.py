"""gemma3-12b — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b", family="localglobal",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144,
    sliding_window=1024, global_every=6, rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="localglobal",
        n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, sliding_window=16, global_every=3,
    )
