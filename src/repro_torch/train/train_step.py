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
    the param dtype, as the reference's scan does.

    ``grad_specs`` (a spec per parameter name, ``dist.sharding.P``; e.g.
    ``named_param_specs(cfg, mesh)``) places each microbatch's gradient on
    its spec before the add, as the reference constrains it: the rank's
    gradient is a ``Partial`` DTensor over the DP mesh dims (the rank's
    batch is its share of the global batch, so the share is divided by the
    DP size), redistributed to ``placements(mesh, spec)`` — a reduce-scatter
    across ranks, a relabelling on a 1x1 mesh — and the accumulator holds
    that placement. AdamW then takes the whole gradient (``full_tensor``);
    the loss and metrics stay this rank's. The step must run under
    ``dist.hints.sharding_rules`` with a DeviceMesh: a spec means nothing
    without a mesh (the reference's constraint fails outside one)."""
    acc_dt = accum_dtype or torch.float32

    def place(grads):
        """Each gradient on its spec (grad_specs), under the active rules."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        from repro_torch.dist.hints import get_rules
        from repro_torch.dist.sharding import AbstractMesh, placements
        r = get_rules()
        if r is None or isinstance(r["mesh"], AbstractMesh):
            raise RuntimeError("train_step: grad_specs places gradients on a "
                               "mesh; call the step under "
                               "sharding_rules(DeviceMesh)")
        mesh, dp, n = r["mesh"], r["dp"], r["dp_size"]
        partial = [Partial() if a in dp else Replicate()
                   for a in mesh.mesh_dim_names]
        out = {}
        for k, g in grads.items():
            share = g / n if n > 1 else g
            out[k] = DTensor.from_local(share, mesh, partial,
                                        run_check=False).redistribute(
                mesh, placements(mesh, grad_specs[k]))
        return out

    def grads_of(model, names, params, batch):
        loss, metrics = M.loss_fn(cfg, model, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        if grad_specs is not None:
            grads = place(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def whole(t):
        return t.full_tensor() if grad_specs is not None else t

    def train_step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        names = list(params)
        if not all(p.requires_grad for p in params.values()):
            raise ValueError("train_step: the model's weights are frozen; "
                             "call models.make_trainable first")
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, names, params, batch)
            grads = {k: whole(g) for k, g in grads.items()}
            loss = metrics["loss"]
        else:
            mb = microbatches
            micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                     for k, v in batch.items()}
            acc: dict = {}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            all_metrics = []
            for i in range(mb):
                loss_i, metrics_i, g = grads_of(
                    model, names, params, {k: v[i] for k, v in micro.items()})
                for k in names:
                    if k not in acc:     # zeros in the gradient's placement
                        acc[k] = torch.zeros_like(g[k], dtype=acc_dt)
                    acc[k].add_((g[k] / mb).to(acc_dt))
                del g
                loss = loss + loss_i / mb
                all_metrics.append(metrics_i)
            grads = {}
            for k in names:
                grads[k] = whole(acc.pop(k).to(params[k].dtype))
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
