"""Hand-written Hopper (sm_90a) attention kernels + their plain versions.

csrc/flash_attention.cu / csrc/decode_attention.cu: CUDA C++ with a plain C
interface (csrc/wgmma.cuh: the tensor-core products in inline PTX), built by
``_build`` with nvcc at first use and loaded with ctypes;
flash_attention.py / decode_attention.py: the checked wrappers (launch
counters included); ops.py: the ops the model calls; ref.py: the plain
versions. Importing this package builds nothing.
"""

from repro_torch.kernels.ops import attention_op, decode_attention_op, window_slice

__all__ = ["attention_op", "decode_attention_op", "window_slice"]
