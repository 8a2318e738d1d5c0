"""The chunked SSD of a Mamba2 prefill — the Hopper kernels' wrapper.

The kernels are ``csrc/ssd_scan.cu``; they replace no TPU kernel (the
reference's SSD is plain ``jnp``). The wrapper takes CUDA tensors and launches
them, or raises; the model decides where the kernels run and runs the plain
version (:func:`repro_torch.models.ssm._ssd_plain`, around ``_ssd_scan``)
elsewhere.

Three kernels a call, in the SSD paper's split: each chunk's state increment
(one block per chunk, head and row; further blocks form each chunk's C B^T
of a B/C group), the carry over chunks (one thread per
state element), each chunk's output (one block per half chunk, head and
row). Nothing of size (chunk, head, 128, 128) is written to device memory;
the scratch is the chunk states (B, chunks, h, P, N), the cumulative
log-decay (B, chunks, h, 128) and C B^T of each chunk and B/C group the
heads read (B, chunks, groups, 128, 128), f32.

For a ``meta`` tensor the wrapper returns empty outputs of the kernels'
shapes: it launches nothing and leaves the count alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 128            # the kernels' chunk, models/ssm.py's CHUNK
MAX_DIM = 64           # largest head dim P and state N the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan(xbc: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
             D: torch.Tensor, *, h0: int, heads_per_group: int,
             head_dim: int, state: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD of heads [h0, h0 + h) over a whole prefill.

    xbc: (B, S, h P + 2 G N), the conv's silu output: x of the h heads, then
    B and C of every group (f32 or bf16); dt, loga: (B, S, h) f32, the step
    and the log-decay ``-exp(A_log) dt``; D: (h,) f32. Head k reads group
    ``(h0 + k) // heads_per_group``. Returns y (B, S, h P), the SSD output
    with ``D x`` added, and the state after the last token (B, h, P, N),
    both f32.
    """
    if xbc.ndim != 3 or dt.ndim != 3:
        raise ValueError(f"ssd_scan: xbc{tuple(xbc.shape)} and "
                         f"dt{tuple(dt.shape)} must be (B, S, ...)")
    B, S, width = xbc.shape
    h, P, N = dt.shape[-1], head_dim, state
    if xbc.device.type == "meta":
        f32 = torch.float32
        return (torch.empty((B, S, h * P), dtype=f32, device="meta"),
                torch.empty((B, h, P, N), dtype=f32, device="meta"))
    if xbc.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xbc.device}")
    if not (0 < P <= MAX_DIM and 0 < N <= MAX_DIM and P % 4 == 0
            and N % 4 == 0):
        raise ValueError(f"ssd_scan: P {P} and N {N} must be multiples of 4 "
                         f"in 4..{MAX_DIM}")
    G, rest = divmod(width - h * P, 2 * N)
    if dt.shape != (B, S, h) or loga.shape != dt.shape \
            or D.shape != (h,) or rest or G <= 0:
        raise ValueError(f"ssd_scan: bad shapes xbc{tuple(xbc.shape)} "
                         f"dt{tuple(dt.shape)} loga{tuple(loga.shape)} "
                         f"D{tuple(D.shape)} at P {P}, N {N}")
    if heads_per_group <= 0 or h0 < 0 \
            or (h0 + h - 1) // heads_per_group >= G:
        raise ValueError(f"ssd_scan: heads [{h0}, {h0 + h}) at "
                         f"{heads_per_group} a group exceed {G} groups")
    if xbc.dtype not in _DTYPES or any(t.dtype != torch.float32
                                       for t in (dt, loga, D)):
        raise TypeError(f"ssd_scan: dtypes xbc {xbc.dtype}, dt {dt.dtype}, "
                        f"loga {loga.dtype}, D {D.dtype}; the kernels take "
                        f"xbc in float32 or bfloat16, the rest in float32")
    if not all(t.device == xbc.device for t in (dt, loga, D)):
        raise ValueError("ssd_scan: inputs on different devices")
    if not all(t.is_contiguous() for t in (xbc, dt, loga, D)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    if B == 0 or S == 0 or h == 0:
        raise ValueError("ssd_scan: empty input")
    if xbc.data_ptr() % 16:
        raise ValueError("ssd_scan: xbc must start on a 16-byte boundary "
                         "(the kernels' vector loads)")
    nc = -(-S // CHUNK)
    f32 = torch.float32
    y = torch.empty((B, S, h * P), dtype=f32, device=xbc.device)
    hs = torch.empty((B, h, P, N), dtype=f32, device=xbc.device)
    states = torch.empty((B, nc, h, P, N), dtype=f32, device=xbc.device)
    lcum = torch.empty((B, nc, h, CHUNK), dtype=f32, device=xbc.device)
    ng = (h0 + h - 1) // heads_per_group - h0 // heads_per_group + 1
    cbT = torch.empty((B, nc, ng, CHUNK, CHUNK), dtype=f32,
                      device=xbc.device)
    lib = _build.load()
    with torch.cuda.device(xbc.device):
        err = lib.repro_ssd_scan(
            xbc.data_ptr(), dt.data_ptr(), loga.data_ptr(), D.data_ptr(),
            y.data_ptr(), hs.data_ptr(), states.data_ptr(), lcum.data_ptr(),
            cbT.data_ptr(), B, S, h, P, N, G, h0, heads_per_group,
            _DTYPES[xbc.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 3
    return y, hs


ssd_scan.launches = 0     # kernel launches; callers reset it to 0
