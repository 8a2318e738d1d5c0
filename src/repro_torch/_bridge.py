"""Carry the reference's params, optimizer states and decode states into
the port and back.

The reference's pytrees arrive as numpy arrays (the caller converts them
with ``np.asarray`` per leaf); torch cannot reproduce ``jax.random``, so the
parity tests bridge the reference's params instead of re-initialising.

bf16 arrives as an ``ml_dtypes`` array, which ``torch.from_numpy`` rejects:
it crosses as its ``uint16`` bit pattern and is viewed back as
``torch.bfloat16``, bit for bit. On the way out, bf16 becomes float32 (every
bf16 value is exactly representable), so no ml_dtypes import is needed here.

The port keeps one module per layer where the reference stacks the layers of
a scan into one leaf. :func:`reference_key` names each port parameter by its
reference key path and its index in that stacked leaf; :func:`to_reference`
and :func:`opt_state_to_reference` stack the port's tensors into the
reference's layout (checkpoints are written in it, and the weight-decay mask
reads its dims), :func:`load_reference` and :func:`opt_state_from_reference`
go back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import _hybrid_layout, _vlm_layout, build_model

__all__ = ["to_torch", "to_numpy", "from_reference", "state_from_reference",
           "state_to_numpy", "reference_key", "reference_ndims",
           "to_reference", "load_reference", "opt_state_to_reference",
           "opt_state_from_reference"]


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


# ------------------------------------------------- the reference's stacked layout
def reference_key(name: str) -> tuple[str, tuple[int, ...]]:
    """A port parameter name as (the reference's key path, the index of this
    tensor in that stacked leaf): ``"blocks.3.attn.wq"`` is layer 3 of
    ``"blocks/attn/wq"``, ``"self_groups.1.2.ln1"`` is ``[1, 2]`` of
    ``"self_groups/ln1"``, ``"final_norm"`` is ``("final_norm", ())``. The
    layer lists' indices follow the list's name, as ``from_reference`` split
    them."""
    parts = name.split(".")
    n = 1
    while n < len(parts) and parts[n].isdigit():
        n += 1
    return "/".join([parts[0]] + parts[n:]), tuple(int(x) for x in parts[1:n])


def reference_ndims(model: torch.nn.Module) -> dict[str, int]:
    """Each parameter's number of dims in the reference's stacked layout (a
    layer's norm gain (d,) is ``blocks/ln1`` (L, d) there: 2)."""
    return {name: p.ndim + len(reference_key(name)[1])
            for name, p in model.named_parameters()}


def _nest(flat: dict[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        cur = out
        parts = key.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = v
    return out


def _flat(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _stack(named: dict[str, torch.Tensor], device) -> dict:
    """Port tensors by parameter name as the reference's nested tree of
    stacked leaves, copied onto ``device`` (default: where they are)."""
    groups: dict[str, list] = {}
    for name, t in named.items():
        key, idx = reference_key(name)
        groups.setdefault(key, []).append((idx, t.detach()))
    flat = {}
    for key, items in groups.items():
        t0 = items[0][1]
        lead = tuple(max(idx[i] for idx, _ in items) + 1
                     for i in range(len(items[0][0])))
        if len(items) != int(np.prod(lead)):
            raise ValueError(f"{key}: {len(items)} tensors for a stack of "
                             f"{lead}")
        out = torch.empty(lead + tuple(t0.shape), dtype=t0.dtype,
                          device=t0.device if device is None else device)
        for idx, t in items:
            out[idx].copy_(t)
        flat[key] = out
    return _nest(flat)


def _unstack_named(names, tree: dict, device) -> dict[str, torch.Tensor]:
    """The reference's nested tree (torch or numpy leaves) as port tensors
    by parameter name, copied onto ``device``. The key sets must match."""
    flat = _flat(tree)
    keys = {name: reference_key(name) for name in names}
    differ = {k for k, _ in keys.values()} ^ set(flat)
    if differ:
        raise ValueError(f"reference tree and model differ at {sorted(differ)}")
    leaves = {k: v if isinstance(v, torch.Tensor) else to_torch(v, "cpu")
              for k, v in flat.items()}
    return {name: leaves[key][idx].to(device, copy=True)
            for name, (key, idx) in keys.items()}


def _check_model(cfg: ModelConfig, model: torch.nn.Module) -> None:
    if getattr(model, "cfg", None) != cfg:
        raise ValueError(f"the model was not built for {cfg.name}")


def to_reference(cfg: ModelConfig, model: torch.nn.Module,
                 device: str | torch.device | None = None) -> dict:
    """The model's weights as the reference's param tree (stacked leaves,
    the reference's key paths), copied onto ``device`` (default: the
    model's; ``"cpu"`` stacks on the host)."""
    _check_model(cfg, model)
    return _stack(dict(model.named_parameters()), device)


@torch.no_grad()
def load_reference(cfg: ModelConfig, model: torch.nn.Module,
                   tree: dict) -> torch.nn.Module:
    """Copy a reference param tree (torch or numpy leaves, the key paths of
    :func:`to_reference`) into ``model``'s parameters in place."""
    _check_model(cfg, model)
    params = dict(model.named_parameters())
    for name, t in _unstack_named(params, tree, model.device).items():
        params[name].copy_(t)
    return model


def opt_state_to_reference(cfg: ModelConfig, model: torch.nn.Module,
                           opt_state: dict,
                           device: str | torch.device | None = None) -> dict:
    """The port's AdamW state ``{"m", "v": by parameter name, "step"}`` as
    the reference's ``{"m", "v": param-shaped trees, "step"}``."""
    _check_model(cfg, model)
    step = opt_state["step"].detach()
    return {"m": _stack(opt_state["m"], device),
            "v": _stack(opt_state["v"], device),
            "step": step.to(step.device if device is None else device,
                            copy=True)}


def opt_state_from_reference(cfg: ModelConfig, model: torch.nn.Module,
                             tree: dict) -> dict:
    """A reference AdamW state (torch or numpy leaves) as the port's, on
    the model's device."""
    _check_model(cfg, model)
    names = [name for name, _ in model.named_parameters()]
    step = tree["step"]
    step = step if isinstance(step, torch.Tensor) else to_torch(step, "cpu")
    return {"m": _unstack_named(names, tree["m"], model.device),
            "v": _unstack_named(names, tree["v"], model.device),
            "step": step.to(model.device, copy=True)}
