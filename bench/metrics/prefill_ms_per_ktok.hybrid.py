"""ServingEngine / TorchComputeBackend, hybrid cell: the seconds that
``TorchComputeBackend.prefill`` measured for each prefill of the window
(device synchronised on both sides), summed, per thousand prompt tokens.
Moves served_tok_per_s."""


def read(rec):
    dts, lens = rec.spans.get("prefill"), rec.work.get("prefill_lengths")
    if not dts or not lens:
        return None
    return 1e3 * sum(dts) / (sum(lens) / 1e3)
