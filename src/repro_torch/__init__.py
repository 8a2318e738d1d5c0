"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It keeps the reference package's module tree and public names (configs,
kernels, models, core, analysis, serve, launch) and imports ``torch``,
``numpy`` and the standard library only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the default device with no card they
raise instead of running on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for (explicitly or by default) and this
    process has no CUDA device — the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run the plain versions on the CPU")
    return dev
