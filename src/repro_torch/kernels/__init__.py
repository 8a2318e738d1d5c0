"""Hand-written Hopper (sm_90a) kernels + their plain versions.

csrc/flash_attention.cu / csrc/decode_attention.cu / csrc/ssd_scan.cu: CUDA
C++ with a plain C interface (csrc/wgmma.cuh: the tensor-core products in
inline PTX), built by ``_build`` with nvcc at first use and loaded with
ctypes; flash_attention.py / decode_attention.py / ssd_scan.py: the checked
wrappers (launch counters included); ops.py: the attention ops the model
calls; ref.py: the attention kernels' plain versions (the SSD's is
``models.ssm._ssd_plain``). Importing this package builds nothing.
"""

from repro_torch.kernels.ops import attention_op, decode_attention_op, window_slice

__all__ = ["attention_op", "decode_attention_op", "window_slice"]
