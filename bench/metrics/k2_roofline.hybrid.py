"""Kernels: K2 (``kernels/decode_attention.py`` ->
``csrc/decode_attention.cu``) at the traced slice's decode steps of the
hybrid cell, in percent: decode_work's least time at each step's slot
lengths (one call a shared-block application, hd 224) over the device time
of the chunk kernel and its merge. Moves served_tok_per_s."""

from work.readers import k2_roofline

KERNELS = ("decode_chunk_kernel", "decode_merge_kernel")


def read(rec):
    return k2_roofline(rec, KERNELS)
