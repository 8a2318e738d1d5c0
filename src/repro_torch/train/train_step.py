"""The train, serve and prefill steps (the port of
``repro.train.train_step``).

``make_train_step(cfg, opt_cfg)`` returns ``step(model, opt_state, batch)
-> (model, opt_state, metrics)``: the loss and its gradients by autograd
(each layer of every family recomputed in the backward, attention through
the flash kernel's autograd node), optional gradient accumulation over microbatches,
then AdamW in place. There is no ``jit``: PyTorch runs eagerly, and the
step's tensors stay on the model's device (``metrics`` are 0-d tensors; the
caller decides when to read them back).
"""

from __future__ import annotations

import torch

from repro_torch._bridge import reference_ndims
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import OptConfig, adamw_update


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    microbatches: int = 1, accum_dtype=None,
                    grad_specs=None):
    """Train step; ``microbatches > 1`` runs the global batch in
    micro-slices, accumulating ``grad / microbatches`` (in the param dtype)
    into an ``accum_dtype`` buffer (default f32) and casting the sum back to
    the param dtype, as the reference's scan does. ``grad_specs`` (the
    reference's sharding constraint on the gradients) needs the port of
    ``dist/`` and is refused."""
    if grad_specs is not None:
        raise NotImplementedError("repro_torch: grad_specs needs the port of "
                                  "dist/ (ROADMAP.md, Queue 1)")
    acc_dt = accum_dtype or torch.float32

    def grads_of(model, names, params, batch):
        loss, metrics = M.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    def train_step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        names = list(params)
        if not all(p.requires_grad for p in params.values()):
            raise ValueError("train_step: the model's weights are frozen; "
                             "call models.make_trainable first")
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, names, params, batch)
            loss = metrics["loss"]
        else:
            mb = microbatches
            micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                     for k, v in batch.items()}
            acc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            all_metrics = []
            for i in range(mb):
                loss_i, metrics_i, g = grads_of(
                    model, names, params, {k: v[i] for k, v in micro.items()})
                for k in names:
                    acc[k].add_((g[k] / mb).to(acc_dt))
                del g
                loss = loss + loss_i / mb
                all_metrics.append(metrics_i)
            grads = {}
            for k in names:
                grads[k] = acc.pop(k).to(params[k].dtype)
            metrics = {k: torch.stack([m[k] for m in all_metrics]).mean()
                       for k in all_metrics[0]}
        with torch.autograd.profiler.record_function("adamw_update"):
            _, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, params, reference_ndims(model))
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model, state: dict, tokens: torch.Tensor):
        return M.decode_step(cfg, model, state, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    @torch.no_grad()
    def prefill_step(model, batch: dict):
        return M.prefill(cfg, model, batch, max_seq)

    return prefill_step
