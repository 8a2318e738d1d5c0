"""The train, serve and prefill steps (the port of
``repro.train.train_step``).

``make_train_step(cfg, opt_cfg)`` returns ``step(model, opt_state, batch)
-> (model, opt_state, metrics)``: the loss and its gradients by autograd
(each layer of every family recomputed in the backward, attention through
the flash kernel's autograd node), optional gradient accumulation over microbatches,
then AdamW in place. There is no ``jit``: PyTorch runs eagerly, and the
step's tensors stay on the model's device (``metrics`` are 0-d tensors; the
caller decides when to read them back).

A sharded model (``dist.sharding.shard_model``) makes these the sharded
step: its params are DTensors, the batch is placed by ``batch_specs`` (a
batch of whole tensors is placed here), the decode state by
``decode_state_specs``, and the model runs on DTensor activations under
``sharding_rules`` on its mesh. The train step's gradients keep their
params' placements (each microbatch's is redistributed onto them: a
reduce-scatter of a partial sum), so do the accumulator and AdamW's
moments, and no gradient is gathered whole; a microbatch moves only its
own rows (:func:`_microbatches`). The loss and the metrics come back as
plain 0-d tensors (replicated values).
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
    without a mesh (the reference's constraint fails outside one). A
    sharded model's gradients take its params' placements instead."""
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
        if model.mesh is not None:      # onto the params' placements
            grads = {k: g.redistribute(g.device_mesh, params[k].placements)
                     for k, g in grads.items()}
        elif grad_specs is not None:
            grads = place(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def whole(model, t):
        return t.full_tensor() if grad_specs is not None \
            and model.mesh is None else t

    def train_step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        names = list(params)
        if not all(p.requires_grad for p in params.values()):
            raise ValueError("train_step: the model's weights are frozen; "
                             "call models.make_trainable first")
        with M.sharded_pass(model):
            batch = _placed_batch(cfg, model, batch)
            model, opt_state, metrics = run(model, params, names, opt_state,
                                            batch)
        return model, opt_state, {k: _plain(v) for k, v in metrics.items()}

    def run(model, params, names, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, names, params, batch)
            grads = {k: whole(model, g) for k, g in grads.items()}
            loss = metrics["loss"]
        else:
            mb = microbatches
            acc: dict = {}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            all_metrics = []
            for micro in _microbatches(cfg, model, batch, mb):
                loss_i, metrics_i, g = grads_of(model, names, params, micro)
                for k in names:
                    if k not in acc:     # zeros in the gradient's placement
                        acc[k] = torch.zeros_like(g[k], dtype=acc_dt)
                    acc[k].add_((g[k] / mb).to(acc_dt))
                del g
                loss = loss + loss_i / mb
                all_metrics.append(metrics_i)
            grads = {}
            for k in names:
                grads[k] = whole(model, acc.pop(k).to(params[k].dtype))
            metrics = {k: torch.stack([m[k] for m in all_metrics]).mean()
                       for k in all_metrics[0]}
        with torch.autograd.profiler.record_function("adamw_update"):
            _, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, params, reference_ndims(model))
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return model, opt_state, metrics

    return train_step


def _placed_batch(cfg: ModelConfig, model, batch: dict) -> dict:
    """A sharded model's batch as DTensors (whole tensors are placed by
    ``batch_specs``); an unsharded model's as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import shard_batch
    mesh = model.mesh
    if mesh is None:
        return batch
    plain = {k: v for k, v in batch.items() if not isinstance(v, DTensor)}
    return dict(batch, **shard_batch(cfg, plain, mesh)) if plain else batch


def _microbatches(cfg: ModelConfig, model, batch: dict, mb: int):
    """The batch's ``mb`` microbatches, one at a time: microbatch ``i`` is
    rows ``[i B/mb, (i + 1) B/mb)``, as the reference's scan slices it. On
    a sharded model each DTensor value moves only its own rows
    (:func:`_micro_rows`)."""
    if model.mesh is None:
        for i in range(mb):
            yield {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                   for k, v in batch.items()}
        return
    rows = {k: _micro_rows(cfg, v, mb) for k, v in batch.items()}
    for i in range(mb):
        yield {k: get(i) for k, get in rows.items()}


def _micro_rows(cfg: ModelConfig, v, mb: int):
    """``get(i)``: microbatch ``i`` of the DTensor batch value ``v`` (rows
    over the DP axes, as ``batch_specs`` places them), placed as
    ``batch_specs`` places the microbatch. No rank holds more than its own
    rows and one microbatch's:

    * rows not split: each microbatch is a slice of the local rows;
    * the microbatch's rows split over the same D ranks as the batch's: an
      all-to-all for each microbatch sends its rows from the ranks that
      hold them in the batch to the ranks that hold them in the
      microbatch;
    * else (a microbatch too small to split over them all): each rank puts
      its rows of the microbatch in place, zeros elsewhere, a partial sum
      over the batch's ranks that one reduce-scatter or all-reduce places
      as the microbatch is placed."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.dist.sharding import (batch_specs, local_offset,
                                           placements, shards)
    mesh = v.device_mesh
    B, rest = v.shape[0], tuple(v.shape[1:])
    R, D = B // mb, shards(v, 0)
    local = v.to_local()
    shape = (R, *rest)
    stride = tuple(torch.empty(shape, device="meta").stride())
    target = placements(mesh, batch_specs(cfg, {"x": torch.empty(
        shape, device="meta")}, mesh)["x"])

    def wrap(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=stride)

    if D == 1:
        local = local.reshape(mb, R, *rest)
        return lambda i: wrap(local[i], target)
    L = B // D
    r = local_offset(v, 0) // L           # this rank's block of the rows
    dims = [m for m, pl in enumerate(v.placements)
            if getattr(pl, "dim", None) == 0]
    if target == list(v.placements):
        # T-row items: this rank holds items q = r mb + j of the batch;
        # microbatch i's item q = i D + s goes to rank s
        T = R // D
        items = local.reshape(mb, T, *rest)
        names = [mesh.mesh_dim_names[m] for m in dims]
        group = mesh.get_group(dims[0]) if len(dims) == 1 else \
            mesh[tuple(names)]._flatten().get_group()

        def get(i):
            lo, hi = max(r * mb, i * D), min((r + 1) * mb, (i + 1) * D)
            out = [T if s == (i * D + r) // mb else 0 for s in range(D)]
            into = [T if lo <= i * D + s < hi else 0 for s in range(D)]
            part = items[max(lo - r * mb, 0):max(hi - r * mb, 0)]
            return wrap(funcol.wait_tensor(funcol.all_to_all_single(
                part.reshape(-1, *rest).contiguous(), out, into, group)),
                target)

        return get
    partial = [Partial() if m in dims else pl
               for m, pl in enumerate(v.placements)]

    def get(i):
        buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
        lo, hi = max(i * R, r * L), min((i + 1) * R, (r + 1) * L)
        if hi > lo:
            buf[lo - i * R:hi - i * R] = local[lo - r * L:hi - r * L]
        return wrap(buf, partial).redistribute(mesh, target)

    return get


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor metric as a plain tensor (the whole value)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model, state: dict, tokens: torch.Tensor):
        tokens = _placed_batch(cfg, model, {"tokens": tokens})["tokens"]
        return M.decode_step(cfg, model, state, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    @torch.no_grad()
    def prefill_step(model, batch: dict):
        return M.prefill(cfg, model, _placed_batch(cfg, model, batch),
                         max_seq)

    return prefill_step
