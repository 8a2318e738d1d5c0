"""minitron-8b — NVIDIA Minitron 8B (pruned Nemotron-4): dense GQA.
[arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab=512,
    )
