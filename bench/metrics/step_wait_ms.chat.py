"""ServingEngine / TorchComputeBackend: the host wall a pooled decode step
spends in its two transfers, which wait for the card: the spans
``decode.upload`` (the tokens' ``.to(device)``) and ``decode.readback`` (the
argmax's ``.cpu()``), summed, per decode call, ms. The records cover the
traced slice of a --trace 1 run (the profiler is active only there), not the
whole window. Moves ttft_p90_s."""

from work import spans


def read(rec):
    s = spans.records()
    if s is None:
        return None
    calls = len(spans.named(s, "decode.upload"))
    if not calls:
        return None
    wait = sum(spans.seconds(x)
               for x in spans.named(s, "decode.upload", "decode.readback"))
    return 1e3 * wait / calls
