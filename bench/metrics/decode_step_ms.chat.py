"""ServingEngine / TorchComputeBackend: mean host wall of
``ServingEngine.step`` in the window (each step ends in a host read of its
tokens). Moves ttft_p90_s."""

from work.readers import mean_ms


def read(rec):
    return mean_ms(rec.spans.get("decode_step"))
