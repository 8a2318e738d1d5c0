"""Elastic restore (``repro_torch.train.elastic``) against checkpoints of
both packages.

A checkpoint ``{"p": params, "o": AdamW state}`` after one train step is
written by the reference (``repro.train.checkpoint.save``) and by the port
(``repro_torch.train.checkpoint.save`` of the bridged trees), for a dense
(granite) and a moe (deepseek) smoke config, in f32 and in bf16 with bf16
moments. ``elastic_restore`` puts every leaf on the mesh as a DTensor with
the placements ``param_specs`` gives on that mesh:

* on a 1x1 gloo mesh (in this process): every leaf's ``full_tensor`` is the
  stored leaf bit for bit, and ``step`` is the stored step;
* on a 2x1 ("data", "model") gloo mesh (granite bf16 and deepseek f32; 2
  ranks, subprocesses of this file
  on a ``FileStore`` under ``tmp_path``, one timeout per run): each rank's
  local block is its data half of the stored leaf wherever the spec puts
  "data" on a dim, the whole leaf elsewhere, bit for bit, and every rank's
  ``full_tensor`` is the stored leaf.

A ``gpu``-marked test restores onto a one-rank NCCL mesh on the card.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CASES = [("granite-3-2b", "float32"), ("granite-3-2b", "bfloat16"),
         ("deepseek-v3-671b", "float32")]


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _cfg_and_opt(arch, dtype):
    from repro_torch.configs import get_smoke
    from repro_torch.train.optimizer import OptConfig
    moments = "bfloat16" if dtype == "bfloat16" else "float32"
    return (dataclasses.replace(get_smoke(arch), dtype=dtype),
            OptConfig(moment_dtype=moments))


def _words(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as integers (bf16 included)."""
    t = t.detach().cpu().contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()]).numpy()


def _worker_restore(rank, world, store, ckpt_dir, arch, dtype):
    """One rank of the 2x1 restore: every leaf's local block, its placements
    and whether its full_tensor is the stored leaf."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_restore
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        cfg, oc = _cfg_and_opt(arch, dtype)
        p, o, step = elastic_restore(cfg, oc, ckpt_dir, mesh)
        stored = _flat(ckpt.restore(ckpt_dir))
        got = _flat({"p": p, "o": o})
        res = {"step": np.asarray(step)}
        for k, v in got.items():
            key = k.replace("/", "__")
            res[f"block__{key}"] = _words(v.to_local())
            res[f"full__{key}"] = np.asarray(np.array_equal(
                _words(v.full_tensor()), _words(stored[k])))
            res[f"pl__{key}"] = np.asarray(str(list(v.placements)))
        np.savez(Path(ckpt_dir).parent / f"restore.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, store, out_dir = sys.argv[1:6]
    if mode != "restore":
        raise SystemExit(f"unknown mode {mode}")
    _worker_restore(int(rank), int(world), store, *sys.argv[6:9])
    sys.exit(0)

# ==================================================================== tests
import jax  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.specs import params_specs_for  # noqa: E402
from repro_torch.models import make_trainable  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.elastic import elastic_restore, shard_targets  # noqa: E402
from repro_torch.train.optimizer import init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_dist import run_ranks  # noqa: E402


def _batch(vocab, seed=0):
    x = np.random.default_rng(seed).integers(0, vocab, (2, 17)).astype(np.int32)
    return x[:, :-1], x[:, 1:]


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    return jax.jit(lambda k: jax_init_params(jcfg, k))(jax.random.PRNGKey(0))


def _write(pkg: str, arch: str, dtype: str, d: Path, step: int) -> None:
    """One train step's {p, o} saved by ``pkg`` in ``d``."""
    cfg, oc = _cfg_and_opt(arch, dtype)
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    joc = jopt.OptConfig(moment_dtype=oc.moment_dtype)
    params = _jax_params(arch, dtype)
    tokens, labels = _batch(cfg.vocab)
    if pkg == "reference":
        opt = jopt.init_opt_state(joc, params)
        params, opt, _ = jax_train_step(jcfg, joc)(
            params, opt, {"tokens": tokens, "labels": labels})
        jckpt.save({"p": params, "o": opt}, str(d), step)
        return
    model = make_trainable(cfg, _bridge.from_reference(
        cfg, jax.tree.map(np.asarray, params), "cpu"))
    opt = init_opt_state(oc, dict(model.named_parameters()))
    _, opt, _ = make_train_step(cfg, oc)(model, opt, {
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    ckpt.save({"p": _bridge.to_reference(cfg, model),
               "o": _bridge.opt_state_to_reference(cfg, model, opt)},
              str(d), step)


@pytest.fixture
def gloo_mesh():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _want_placements(cfg, oc, mesh) -> dict:
    p_spec = shd.param_specs(cfg, params_specs_for(cfg), mesh)
    want = {f"p/{k}": shd.placements(mesh, v)
            for k, v in _flat(p_spec).items()}
    for k, v in _flat(p_spec).items():
        want[f"o/m/{k}"] = want[f"o/v/{k}"] = shd.placements(mesh, v)
    want["o/step"] = shd.placements(mesh, shd.P())
    return want


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("arch,dtype", CASES)
def test_elastic_restore_on_1x1_is_bit_identical(pkg, arch, dtype, tmp_path,
                                                 gloo_mesh):
    _write(pkg, arch, dtype, tmp_path, 11)
    cfg, oc = _cfg_and_opt(arch, dtype)
    p, o, step = elastic_restore(cfg, oc, str(tmp_path), gloo_mesh)
    assert step == 11
    stored = _flat(ckpt.restore(str(tmp_path)))
    got = _flat({"p": p, "o": o})
    assert set(got) == set(stored)
    want_pl = _want_placements(cfg, oc, gloo_mesh)
    for k, v in got.items():
        assert list(v.placements) == list(want_pl[k]), k
        assert v.dtype == stored[k].dtype, k
        np.testing.assert_array_equal(_words(v.full_tensor()),
                                      _words(stored[k]), err_msg=k)
    assert int(o["step"].full_tensor()) == 1
    # the targets allocate nothing
    tgt = shard_targets(cfg, oc, gloo_mesh)
    assert all(t.to_local().device.type == "meta"
               for t in _flat(tgt["p"]).values())


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("arch,dtype", CASES[1:])
def test_elastic_restore_on_a_2x1_gloo_mesh(pkg, arch, dtype, tmp_path):
    d = tmp_path / "ckpt"
    _write(pkg, arch, dtype, d, 5)
    cfg, oc = _cfg_and_opt(arch, dtype)
    stored = _flat(ckpt.restore(str(d)))
    run_ranks(tmp_path, "restore", 2, str(d), arch, dtype,
              script=Path(__file__))
    outs = [dict(np.load(tmp_path / f"restore.{r}.npz")) for r in (0, 1)]
    mesh = shd.AbstractMesh((2, 1), ("data", "model"))
    p_spec = _flat(shd.param_specs(cfg, params_specs_for(cfg), mesh))
    specs = {f"p/{k}": v for k, v in p_spec.items()}
    specs.update({f"o/{m}/{k}": v for k, v in p_spec.items() for m in "mv"})
    specs["o/step"] = shd.P()
    sharded = 0
    for r, out in enumerate(outs):
        assert int(out["step"]) == 5
        for k, t in stored.items():
            key = k.replace("/", "__")
            assert bool(out[f"full__{key}"]), (r, k)
            block = t
            for dim, entry in enumerate(specs[k]):
                if entry == "data":
                    n = t.shape[dim] // 2
                    block = block.narrow(dim, r * n, n)
                    sharded += 1
                else:                       # "model" has one rank here
                    assert entry in (None, "model"), (k, specs[k])
            np.testing.assert_array_equal(out[f"block__{key}"], _words(block),
                                          err_msg=f"rank {r} {k}")
    assert sharded > 0


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_elastic_restore_onto_a_cuda_mesh(tmp_path):
    """A port checkpoint restored onto a one-rank NCCL mesh on the card:
    every leaf on cuda, bit for bit."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    _write("port", "granite-3-2b", "bfloat16", tmp_path, 3)
    cfg, oc = _cfg_and_opt("granite-3-2b", "bfloat16")
    mesh = make_local_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        p, o, step = elastic_restore(cfg, oc, str(tmp_path), mesh)
        stored = _flat(ckpt.restore(str(tmp_path)))
        for k, v in _flat({"p": p, "o": o}).items():
            assert v.to_local().device.type == "cuda", k
            np.testing.assert_array_equal(_words(v.full_tensor()),
                                          _words(stored[k]), err_msg=k)
        assert step == 3
    finally:
        dist.destroy_process_group()
