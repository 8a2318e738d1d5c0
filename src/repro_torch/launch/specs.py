"""input_specs(): meta-device stand-ins for every model input (the port of
``repro.launch.specs``).

Shapes and dtypes without storage, in the reference's layout: params as its
stacked tree (``_bridge.to_reference`` of a meta model), decode states as
its ``init_decode_state``. Nothing is allocated, even for the full
deepseek-v3 and arctic configs. Modality frontends are stubs: whisper gets
precomputed frame embeddings, llama-vision gets patch embeddings.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M

Pytree = Any
_META = torch.device("meta")


def batch_specs_for(cfg: ModelConfig, shape: InputShape) -> Pytree:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=_META),
             "labels": torch.empty((B, S), dtype=torch.int32, device=_META)}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        batch["frames"] = torch.empty((B, cfg.n_frames, cfg.d_model),
                                      dtype=dt, device=_META)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                       dtype=dt, device=_META)
    return batch


def decode_specs_for(cfg: ModelConfig, shape: InputShape
                     ) -> tuple[Pytree, Pytree]:
    """(state_specs, token_specs) for one serve_step with a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len
    state = M.init_decode_state(cfg, B, S, device="meta")
    tokens = torch.empty((B, 1), dtype=torch.int32, device=_META)
    return state, tokens


def params_specs_for(cfg: ModelConfig) -> Pytree:
    from repro_torch._bridge import to_reference
    return to_reference(cfg, M.init_params(cfg, device="meta"))


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Pytree]:
    """Everything the chosen step consumes, as meta tensors."""
    out = {"params": params_specs_for(cfg)}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_specs_for(cfg, shape)
    if shape.kind == "decode":
        state, tokens = decode_specs_for(cfg, shape)
        out["state"], out["tokens"] = state, tokens
    return out
