"""ServingEngine / TorchComputeBackend, hybrid cell: mean host wall of
``ServingEngine.step`` in the window (each step ends in a host read of its
tokens; the pooled step, 81 Mamba2 layers and 13 block applications, is one
CUDA graph replay). Moves served_tok_per_s."""

from work.readers import mean_ms


def read(rec):
    return mean_ms(rec.spans.get("decode_step"))
