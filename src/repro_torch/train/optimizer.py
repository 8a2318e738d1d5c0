"""AdamW over a dict of named tensors (the port of ``repro.train.optimizer``).

No optimizer library: the reference's pytree AdamW with global-norm
clipping, decoupled weight decay, a linear-warmup + cosine schedule and a
configurable moment dtype. Params, grads and moments are dicts keyed by
parameter name (``dict(model.named_parameters())``); the update is computed
in f32 and written back in place, in each tensor's own dtype. The schedule
and the bias corrections are f32 tensors on the params' device, as the
reference computes them, so no step reads a value back to the host.

Weight decay follows the reference's rule, ``ndim >= 2``, evaluated on the
reference's stacked layout (``adamw_update``'s ``ndims``): there a layer's
norm gain is ``(L, d)``, so the reference decays every per-layer norm gain
(though its docstring says it does not) and only ``final_norm`` (and the
other unstacked vectors) escape. The port keeps that for parity (ROADMAP.md,
Queue 3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # "bfloat16" for the giant configs


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a tensor), as an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: OptConfig, params: Tensors) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each param, step 0 (int32
    on the params' device)."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _decay_mask(ndims: dict[str, int]) -> dict[str, float]:
    """Weight decay on every tensor of two or more dims, counted in the
    reference's stacked layout: no decay on unstacked vectors or scalars
    (``final_norm``), decay on a layer's norm gain (``(L, d)`` there)."""
    return {k: float(n >= 2) for k, n in ndims.items()}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Tensors, opt_state: dict,
                 params: Tensors, ndims: dict[str, int]
                 ) -> tuple[Tensors, dict, dict]:
    """One AdamW step, IN PLACE on ``params`` and ``opt_state``'s moments
    (the returned dicts hold the same tensors; ``step`` is a new tensor).

    ``ndims`` gives each param's dims for the decay mask, counted in the
    reference's stacked layout (``repro_torch._bridge.reference_ndims``); a
    flat dict of tensors that has no stacked layout passes its own dims."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    mask = _decay_mask(ndims)
    for k, p in params.items():
        m, v = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + (cfg.weight_decay * mask[k]) * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
