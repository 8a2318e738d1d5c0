"""Carry the reference's params and decode states into the port and back.

The reference's pytrees arrive as numpy arrays (the caller converts them
with ``np.asarray`` per leaf); torch cannot reproduce ``jax.random``, so the
parity tests bridge the reference's params instead of re-initialising.

bf16 arrives as an ``ml_dtypes`` array, which ``torch.from_numpy`` rejects:
it crosses as its ``uint16`` bit pattern and is viewed back as
``torch.bfloat16``, bit for bit. On the way out, bf16 becomes float32 (every
bf16 value is exactly representable), so no ml_dtypes import is needed here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import DenseLM

__all__ = ["to_torch", "to_numpy", "from_reference", "state_from_reference",
           "state_to_numpy"]


def to_torch(a: Any, device: str | torch.device | None = None) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array (bf16 widened to float32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _tree(fn, x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x)


def from_reference(cfg: ModelConfig, np_params: dict,
                   device: str | torch.device | None = None) -> DenseLM:
    """The reference's dense/localglobal param pytree as the port's model:
    the stacked ``(L, ...)`` leaves of ``params["blocks"]`` are split into
    one module per layer."""
    dev = resolve_device(device)
    conv = _tree(lambda a: to_torch(a, dev), np_params)
    stacked = conv["blocks"]
    blocks = [_tree(lambda t, i=i: t[i].contiguous(), stacked)
              for i in range(cfg.n_layers)]
    return DenseLM(cfg, conv["embed"], blocks, conv["final_norm"])


def state_from_reference(np_state: dict,
                         device: str | torch.device | None = None) -> dict:
    """A reference decode state (numpy leaves) as the port's decode state."""
    dev = resolve_device(device)
    return _tree(lambda a: to_torch(a, dev), np_state)


def state_to_numpy(state: dict) -> dict:
    """The port's decode state (or parked slice) as numpy leaves."""
    return _tree(to_numpy, state)
