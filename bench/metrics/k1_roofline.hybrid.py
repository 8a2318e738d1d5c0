"""Kernels: K1 (``kernels/flash_attention.py`` -> ``csrc/flash_attention.cu``)
at the traced slice's prefills of the hybrid cell, in percent: flash_work's
least time of every K1 call (one a shared-block application, causal, at the
prompt's length, hd 224) over the device time of the kernels named here.
Moves served_tok_per_s."""

from work.readers import k1_roofline, prefill_cases

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(rec):
    return k1_roofline(rec, KERNELS, prefill_cases(rec,
                                                   rec.work.get("k1_prompts")))
