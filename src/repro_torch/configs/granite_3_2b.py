"""granite-3-2b — IBM Granite 3.0 2B base: dense GQA decoder.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=503,  # deliberately non-multiple-of-256 (pad path)
    )
