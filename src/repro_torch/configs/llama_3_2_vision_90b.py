"""llama-3.2-vision-90b — 100 layers = 20 groups of (4 self + 1 gated
cross-attn image layer). Vision frontend STUBBED: input_specs provides
precomputed patch embeddings (B, n_patches, d).
[hf:meta-llama/Llama-3.2-11B-Vision family; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    cross_every=5, n_patches=1601, rope_theta=5e5,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, cross_every=3, n_patches=16,
    )
