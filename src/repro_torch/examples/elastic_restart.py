"""Elastic restart: checkpoint on one mesh, resume on another (the port of
``examples/elastic_restart.py``).

A run checkpoints, "loses half its pod", and resumes from the same
checkpoint on a reshaped mesh: parameters are resharded by the
divisibility-aware rules onto the new mesh (here a ("data", "model") 1x1
mesh on a one-rank group: NCCL on the card, gloo on the CPU), and the
content is checked bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch._bridge import opt_state_to_reference, to_reference
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import elastic_restore, shard_targets
from repro_torch.train.optimizer import OptConfig, init_opt_state


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def run(device: str | torch.device | None = None, model=None) -> dict:
    """Saves granite-3-2b's smoke model (seeded, or ``model``: a test passes
    the reference's, bridged) and a fresh optimizer state at step 40, then
    restores both onto a 1x1 mesh and compares every param leaf with the
    saved one. Starts a one-rank group when none is running, and destroys
    it again at the end."""
    dev = resolve_device(device)
    cfg = get_smoke("granite-3-2b")
    oc = OptConfig()
    model = init_params(cfg, 0, device=dev) if model is None else model
    opt = init_opt_state(oc, dict(model.named_parameters()))
    params = to_reference(cfg, model)
    started = not dist.is_initialized()
    try:
        with tempfile.TemporaryDirectory() as d:
            print("training 'pod A' saves step 40 ...")
            ckpt.save({"p": params,
                       "o": opt_state_to_reference(cfg, model, opt)}, d, 40)

            # --- pod shrinks: new mesh shape ---------------------------------
            new_mesh = make_local_mesh(1, 1, device_type=dev.type)
            shape = dict(zip(new_mesh.mesh_dim_names, new_mesh.shape))
            print(f"restarting on mesh {shape} ...")
            p2, o2, step = elastic_restore(cfg, oc, d, new_mesh)
            print(f"restored step {step}; resharded {len(_leaves(p2))} param "
                  f"leaves onto the new mesh")

            # verify bit-identical content
            same = all(torch.equal(a.to("cpu"), b.full_tensor().to("cpu"))
                       for a, b in zip(_leaves(params), _leaves(p2)))
            print("content identical after reshard:", same)

            # the targets the restore used (what a production launcher passes)
            some = _leaves(shard_targets(cfg, oc, new_mesh)["p"])[0]
            print("example target sharding:", some.placements)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return {"step": step, "leaves": len(_leaves(p2)), "identical": same}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    assert res["identical"], "the content changed in the reshard"
    return res


if __name__ == "__main__":
    main()
