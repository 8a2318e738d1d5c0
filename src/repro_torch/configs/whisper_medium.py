"""whisper-medium — encoder-decoder; conv audio frontend STUBBED: input_specs
provides precomputed frame embeddings (B, 1500, d). [arXiv:2212.04356;
unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, n_frames=1500,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, encoder_layers=2, n_frames=32,
    )
