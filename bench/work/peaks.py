"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at its 700 W limit): copied from ``repro_torch.launch.
profile_cell`` (989e12) and ``repro_torch.core.locstore.tiered_hierarchy``
(3.35e12)."""

PEAK_BF16_FLOPS = 989e12        # bf16 tensor cores, FLOP/s
PEAK_HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    operations over peak FLOP/s and bytes over peak bandwidth."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
