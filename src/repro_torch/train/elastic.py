"""Elastic scaling: restore a checkpoint onto a DIFFERENT mesh (the port of
``repro.train.elastic``).

Nothing about the checkpoint format depends on the writing mesh (leaves are
saved whole per key, in the reference's stacked layout), so elasticity is a
restore-time policy:

    new_mesh = make_local_mesh(new_dp, new_tp)      # over the new world
    params, opt_state, step = elastic_restore(cfg, opt_cfg, ckpt_dir, new_mesh)

Each leaf becomes a DTensor on the sharding rules evaluated on the NEW mesh
(divisibility-aware: rules degrade to replication for axes that no longer
divide); each rank reads the leaf and keeps its block. A checkpoint of
either package restores.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig

Pytree = Any


def shard_targets(cfg: ModelConfig, opt_cfg: OptConfig, mesh
                  ) -> dict[str, Pytree]:
    """``{"p": params, "o": opt_state}`` in the reference's layout as meta
    DTensors: each leaf's shape and dtype, with its placements on ``mesh``
    (``param_specs``; the moments take their param's, ``step`` replicates).
    Nothing is allocated."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.specs import params_specs_for
    p_shapes = params_specs_for(cfg)
    mdt = getattr(torch, opt_cfg.moment_dtype)

    def moments(t):
        return torch.empty(t.shape, dtype=mdt, device="meta")

    o_shapes = {"m": shd._zip_map(lambda t, _: moments(t), p_shapes, p_shapes),
                "v": shd._zip_map(lambda t, _: moments(t), p_shapes, p_shapes),
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    p_spec = shd.param_specs(cfg, p_shapes, mesh)
    o_spec = {"m": p_spec, "v": p_spec, "step": shd.P()}

    def attach(t, spec):
        pl = shd.placements(mesh, spec)
        local = torch.empty(shd.local_block(t, mesh, spec).shape,
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return {"p": shd._zip_map(attach, p_shapes, p_spec),
            "o": shd._zip_map(attach, o_shapes, o_spec)}


def elastic_restore(cfg: ModelConfig, opt_cfg: OptConfig, ckpt_dir: str,
                    mesh, step: int | None = None
                    ) -> tuple[Pytree, Pytree, int]:
    """(params, opt_state, step) resharded onto ``mesh`` as DTensors, in
    the reference's layout."""
    step = step if step is not None else (ckpt.latest_step(ckpt_dir) or 0)
    tgt = shard_targets(cfg, opt_cfg, mesh)
    state = ckpt.restore(ckpt_dir, step, target=tgt)
    return state["p"], state["o"], step
