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
from repro_torch.models.model import _hybrid_layout, _vlm_layout, build_model

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


def _unstack(tree: Any, n: int) -> list:
    """A pytree whose leaves are stacked ``(n, ...)`` as n per-layer trees."""
    return [_tree(lambda t, i=i: t[i].contiguous(), tree) for i in range(n)]


def from_reference(cfg: ModelConfig, np_params: dict,
                   device: str | torch.device | None = None):
    """The reference's param pytree as the port's model for ``cfg.family``:
    the stacked leaves of its layer scans (``blocks``; ``enc_blocks`` /
    ``dec_blocks``; ``self_groups`` (G, S_per, ...) / ``cross_blocks``;
    ``dense_blocks`` / ``moe_blocks``; hybrid ``groups`` (G, A, ...) and
    ``tail``; rwkv ``blocks``) are split into one module per layer. zamba2's
    ``shared_attn`` is not stacked and is carried once."""
    dev = resolve_device(device)
    tree = _tree(lambda a: to_torch(a, dev), np_params)
    L = cfg.n_layers
    if cfg.family == "encdec":
        tree["enc_blocks"] = _unstack(tree["enc_blocks"], cfg.encoder_layers)
        tree["dec_blocks"] = _unstack(tree["dec_blocks"], L)
    elif cfg.family == "vlm":
        G, S_per = _vlm_layout(cfg)
        tree["self_groups"] = [_unstack(g, S_per)
                               for g in _unstack(tree["self_groups"], G)]
        tree["cross_blocks"] = _unstack(tree["cross_blocks"], G)
    elif cfg.family == "moe":
        if "dense_blocks" in tree:
            tree["dense_blocks"] = _unstack(tree["dense_blocks"],
                                            cfg.first_dense_layers)
        tree["moe_blocks"] = _unstack(tree["moe_blocks"],
                                      L - cfg.first_dense_layers)
    elif cfg.family == "hybrid":
        G, tail = _hybrid_layout(cfg)
        tree["groups"] = [_unstack(g, cfg.attn_every)
                          for g in _unstack(tree["groups"], G)]
        if tail:
            tree["tail"] = _unstack(tree["tail"], tail)
    else:                                       # dense, localglobal, rwkv
        tree["blocks"] = _unstack(tree["blocks"], L)
    return build_model(cfg, tree)


def state_from_reference(np_state: dict,
                         device: str | torch.device | None = None) -> dict:
    """A reference decode state (numpy leaves) as the port's decode state —
    any family's: its dicts and the moe caches' (c1, c2) tuples are kept."""
    dev = resolve_device(device)
    return _tree(lambda a: to_torch(a, dev), np_state)


def state_to_numpy(state: dict) -> dict:
    """The port's decode state (or parked slice) as numpy leaves."""
    return _tree(to_numpy, state)
