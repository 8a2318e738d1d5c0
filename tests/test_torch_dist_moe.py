"""The sharded MoE path and ``grad_specs`` against the reference's.

* ``_moe_ffn_sharded`` on a 1x1 gloo mesh equals ``_moe_ffn_global`` bit
  for bit (out, aux and every gradient), and the reference's sharded path on
  a 1x1 mesh (arctic and deepseek smoke, f32: out and aux at rtol/atol 1e-5,
  as ``tests/test_hints_and_dist.py``; gradients at 1e-4 relative norm per
  leaf).
* On a 2x2 ("data", "model") gloo mesh (4 ranks, subprocesses of this file
  on a ``FileStore`` under ``tmp_path``, one timeout per run) each rank runs
  its data shard of the tokens through ``moe_ffn`` under the rules; out and
  aux equal the reference's ``_moe_ffn_sharded`` on a 2x2 mesh of 4 forced
  host devices (a subprocess with ``XLA_FLAGS``) at 1e-5, and the gradients
  of ``sum(out ** 2) + aux`` (each rank: its tokens' share, aux / dp) at
  1e-4 relative norm: x per data shard, each expert shard on its owner, the
  router and the shared expert summed over the data ranks. The reference's
  ``shard_map(check_vma=False)`` gives the gradients of its one loss (no
  factor of the model-axis size), and so does the port.
* The deepseek smoke train step under 1x1 rules with ``grad_specs`` and 2
  microbatches equals the unmeshed step bit for bit (through the sharded
  MoE path); on 2 gloo data ranks (granite and gemma3 smoke) two
  ``grad_specs`` steps over each rank's rows equal the unmeshed steps over
  the global batches: grad_norm and moments to STEP_TOL, the params'
  updates to GRAD_TOL.
* Every family's loss, gradient, prefill and decode step under 1x1 rules
  equal the unmeshed ones bit for bit.

Tests marked ``gpu`` run the same on a one-rank NCCL mesh on the card; they
decide inside a fixture whether there is one and skip here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ["arctic-480b", "deepseek-v3-671b"]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        cur = out
        parts = k.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = v
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_params(flat_np: dict, device="cpu") -> dict:
    return _nest({k: torch.tensor(v, device=device, requires_grad=True)
                  for k, v in flat_np.items()})


def _moe_inputs(path: Path) -> tuple[dict, np.ndarray]:
    data = dict(np.load(path))
    x = data.pop("x")
    return data, x


# --------------------------------------------------------------- rank entry
def _worker_moe(rank, world, store, out_dir, arch):
    """One rank of the 2x2 run: its data shard of x through ``moe_ffn``
    under the rules; out, aux and the gradients of its share of the loss."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke
    from repro_torch.dist.hints import sharding_rules
    from repro_torch.models import moe
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        flat, x_all = _moe_inputs(Path(out_dir) / "moe_in.npz")
        p = _port_params(flat)
        d = mesh.get_local_rank("data")
        bl = x_all.shape[0] // 2
        x = torch.tensor(x_all[d * bl:(d + 1) * bl], requires_grad=True)
        calls = []
        orig = moe._moe_ffn_sharded
        moe._moe_ffn_sharded = lambda *a: calls.append(1) or orig(*a)
        with sharding_rules(mesh):
            out, aux = moe.moe_ffn(cfg, p, x)
        assert calls, "moe_ffn did not take the sharded path"
        leaves = _flat(p)
        grads = torch.autograd.grad((out * out).sum() + aux / 2,
                                    [x] + list(leaves.values()))
        res = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
               "g_x": grads[0].numpy()}
        res.update({f"g_{k}": g.numpy() for k, g in zip(leaves, grads[1:])})
        np.savez(Path(out_dir) / f"moe.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _jax_moe(out_dir, arch):
    """The reference's sharded path on a 2x2 mesh of 4 host devices (XLA_FLAGS
    set by the caller): out, aux and the gradients of sum(out ** 2) + aux."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro  # noqa: F401 - the jax API shims
    from repro.configs import get_smoke
    from repro.dist.hints import sharding_rules
    from repro.models.moe import moe_ffn
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    flat, x = _moe_inputs(Path(out_dir) / "moe_in.npz")
    p = _nest({k: jnp.asarray(v) for k, v in flat.items()})
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def loss(p, x):
        out, aux = moe_ffn(cfg, p, x)
        return (out * out).sum() + aux

    with mesh, sharding_rules(mesh):
        out, aux = jax.jit(lambda p, x: moe_ffn(cfg, p, x))(p, jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    res = {"out": np.asarray(out), "aux": np.asarray(aux), "g_x": np.asarray(gx)}
    res.update({f"g_{k}": np.asarray(v) for k, v in _flat(gp).items()})
    np.savez(Path(out_dir) / "moe_ref.npz", **res)


GRADSPECS_STEPS = 2
# full learning rate from step 1, so each update is far above STEP_TOL
GRADSPECS_OPT = dict(warmup_steps=1, total_steps=10)


def _gradspecs_batches(cfg):
    """One global batch of 4 rows a step."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (GRADSPECS_STEPS, 4, 17)
                       ).astype(np.int32)
    return [(t[:, :-1], t[:, 1:]) for t in tok]


def _worker_gradspecs(rank, world, store, out_dir, arch):
    """One data rank of a (2, 1) mesh: train steps with grad_specs, each
    over its global batch's rows [rank, 2 + rank] in 2 microbatches, so its
    microbatch i is global row 2 i + rank, one half of the unmeshed
    microbatch i. Saves each step's loss and grad_norm, and the params and
    moments after the last step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke
    from repro_torch.dist.hints import sharding_rules
    from repro_torch.dist.sharding import named_param_specs
    from repro_torch.models import init_params, make_trainable
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        model = make_trainable(cfg, init_params(cfg, 0, device="cpu"))
        oc = OptConfig(**GRADSPECS_OPT)
        opt = init_opt_state(oc, dict(model.named_parameters()))
        rows = [rank, 2 + rank]
        step = make_train_step(cfg, oc, microbatches=2,
                               grad_specs=named_param_specs(cfg, mesh))
        losses, norms = [], []
        for tokens, labels in _gradspecs_batches(cfg):
            batch = {"tokens": torch.from_numpy(tokens[rows]),
                     "labels": torch.from_numpy(labels[rows])}
            with sharding_rules(mesh):
                _, opt, metrics = step(model, opt, batch)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        res = {f"p__{k}": v.detach().numpy()
               for k, v in model.named_parameters()}
        res.update({f"m__{k}": v.numpy() for k, v in opt["m"].items()})
        res.update({f"v__{k}": v.numpy() for k, v in opt["v"].items()})
        res["loss"], res["grad_norm"] = np.array(losses), np.array(norms)
        np.savez(Path(out_dir) / f"gradspecs.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, world, store, out_dir = sys.argv[1:6]
    if mode == "moe":
        _worker_moe(int(rank), int(world), store, out_dir, sys.argv[6])
    elif mode == "gradspecs":
        _worker_gradspecs(int(rank), int(world), store, out_dir, sys.argv[6])
    elif mode == "jaxmoe":
        _jax_moe(out_dir, sys.argv[6])
    else:
        raise SystemExit(f"unknown mode {mode}")
    sys.exit(0)

# ==================================================================== tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from repro.configs import ARCH_NAMES as JAX_ARCHS  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.dist.hints import sharding_rules as jax_rules  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.moe import init_moe as jax_init_moe  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro_torch._bridge import from_reference  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.dist.hints import sharding_rules  # noqa: E402
from repro_torch.dist.sharding import named_param_specs  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import make_trainable, moe  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_dist import run_ranks  # noqa: E402


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _jax_inputs(arch, B=2, S=16, seed=0):
    cfg = _f32(jax_smoke(arch))
    p = jax_init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    flat = {k: np.asarray(v) for k, v in _flat(p).items()}
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)
                                           ).astype(np.float32)
    return flat, x


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.linalg.norm(a))


@pytest.fixture
def gloo_mesh():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _counting_sharded(monkeypatch) -> list:
    calls = []
    orig = moe._moe_ffn_sharded

    def counted(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(moe, "_moe_ffn_sharded", counted)
    return calls


# ------------------------------------------------------------- 1x1 mesh
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_global_bit_for_bit_on_1x1(arch, gloo_mesh,
                                                  monkeypatch):
    cfg = _f32(get_smoke(arch))
    flat, x_np = _jax_inputs(arch)
    p = _port_params(flat)
    leaves = _flat(p)
    x = torch.tensor(x_np, requires_grad=True)
    out_g, aux_g = moe._moe_ffn_global(cfg, p, x)
    g_g = torch.autograd.grad((out_g * out_g).sum() + aux_g,
                              [x] + list(leaves.values()))
    calls = _counting_sharded(monkeypatch)
    with sharding_rules(gloo_mesh):
        out_s, aux_s = moe.moe_ffn(cfg, p, x)
    assert calls == [1]
    g_s = torch.autograd.grad((out_s * out_s).sum() + aux_s,
                              [x] + list(leaves.values()))
    assert torch.equal(out_s, out_g) and torch.equal(aux_s, aux_g)
    for name, a, b in zip(["x"] + list(leaves), g_s, g_g):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_the_references_sharded_on_1x1(arch, gloo_mesh):
    jcfg, cfg = _f32(jax_smoke(arch)), _f32(get_smoke(arch))
    flat, x_np = _jax_inputs(arch)
    jp = _nest({k: jnp.asarray(v) for k, v in flat.items()})
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))

    def jloss(p, x):
        out, aux = jax_moe_ffn(jcfg, p, x)
        return (out * out).sum() + aux

    with jmesh, jax_rules(jmesh):
        out_j, aux_j = jax.jit(lambda p, x: jax_moe_ffn(jcfg, p, x))(
            jp, jnp.asarray(x_np))
        gp_j, gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jp, jnp.asarray(x_np))
    p = _port_params(flat)
    leaves = _flat(p)
    x = torch.tensor(x_np, requires_grad=True)
    with sharding_rules(gloo_mesh):
        out, aux = moe.moe_ffn(cfg, p, x)
    grads = torch.autograd.grad((out * out).sum() + aux,
                                [x] + list(leaves.values()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j),
                               rtol=OUT_TOL)
    want = {"x": np.asarray(gx_j)}
    want.update({k: np.asarray(v) for k, v in _flat(gp_j).items()})
    for name, g in zip(["x"] + list(leaves), grads):
        assert _rel(g.numpy(), want[name]) < GRAD_TOL, name


# ------------------------------------------------------------- 2x2 mesh
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_on_a_2x2_gloo_mesh_equals_the_reference(arch, tmp_path):
    flat, x = _jax_inputs(arch)
    np.savez(tmp_path / "moe_in.npz", x=x, **flat)
    ref = subprocess.run(
        [sys.executable, __file__, "jaxmoe", "0", "1", "-", str(tmp_path),
         arch], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert ref.returncode == 0, ref.stderr
    want = dict(np.load(tmp_path / "moe_ref.npz"))
    outs = [dict(np.load(p)) for p in run_ranks(
        tmp_path, "moe", 4, arch, script=Path(__file__))]
    bl = x.shape[0] // 2
    E = flat["w1"].shape[0]
    sum_data = {}
    for r, o in enumerate(outs):
        d, m = divmod(r, 2)                    # row-major ("data", "model")
        rows = slice(d * bl, (d + 1) * bl)
        np.testing.assert_allclose(o["out"], want["out"][rows], rtol=OUT_TOL,
                                   atol=OUT_TOL)
        np.testing.assert_allclose(o["aux"], want["aux"], rtol=OUT_TOL)
        assert _rel(o["g_x"], want["g_x"][rows]) < GRAD_TOL, r
        # each expert shard on its owner: experts on "model", ff on "data"
        e = slice(m * E // 2, (m + 1) * E // 2)
        for k, ff_dim in (("w1", 2), ("w3", 2), ("w2", 1)):
            f = want[f"g_{k}"].shape[ff_dim] // 2
            idx = [e, slice(None), slice(None)]
            idx[ff_dim] = slice(d * f, (d + 1) * f)
            assert _rel(o[f"g_{k}"][tuple(idx)],
                        want[f"g_{k}"][tuple(idx)]) < GRAD_TOL, (r, k)
            rest = o[f"g_{k}"].copy()
            rest[tuple(idx)] = 0
            assert not rest.any(), (r, k)       # nothing outside its shard
        for k in o:
            if k.startswith("g_") and k not in ("g_x", "g_w1", "g_w3",
                                                "g_w2"):
                # replicated over "model" (every model rank the same) and
                # summed over the data ranks
                np.testing.assert_array_equal(o[k], outs[d * 2][k])
                if m == 0:
                    sum_data[k] = sum_data.get(k, 0) + o[k]
    assert "g_router" in sum_data
    for k, v in sum_data.items():
        assert _rel(v, want[k]) < GRAD_TOL, k


# --------------------------------------------------------- train step
def test_deepseek_train_step_with_grad_specs_equals_unmeshed(gloo_mesh,
                                                             monkeypatch):
    """Two microbatches under 1x1 rules with grad_specs (through the sharded
    MoE path) against the unmeshed step: loss, metrics, params and moments
    bit for bit."""
    cfg = get_smoke("deepseek-v3-671b")
    jcfg = jax_smoke("deepseek-v3-671b")
    np_params = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0)))
    oc = OptConfig()
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    runs = []
    calls = _counting_sharded(monkeypatch)
    for meshed in (False, True):
        model = make_trainable(cfg, from_reference(cfg, np_params, "cpu"))
        opt = init_opt_state(oc, dict(model.named_parameters()))
        if meshed:
            with sharding_rules(gloo_mesh):
                step = make_train_step(cfg, oc, microbatches=2,
                                       grad_specs=named_param_specs(
                                           cfg, gloo_mesh))
                _, opt, metrics = step(model, opt, batch)
        else:
            _, opt, metrics = make_train_step(cfg, oc, microbatches=2)(
                model, opt, batch)
        runs.append((dict(model.named_parameters()), opt, metrics))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(calls) == 2 * 2 * n_moe     # 2 microbatches, + recompute
    (pa, oa, ma), (pb, ob, mb) = runs
    assert set(ma) == set(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(oa["m"][k], ob["m"][k]), k
        assert torch.equal(oa["v"][k], ob["v"][k]), k
    assert int(oa["step"]) == int(ob["step"]) == 1


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b"])
def test_grad_specs_on_two_data_ranks_equal_the_unmeshed_step(arch,
                                                               tmp_path):
    """grad_specs across 2 gloo data ranks (the rank's share of each
    microbatch's gradient reduce-scattered onto its spec, the whole
    gradient gathered for AdamW) against the unmeshed steps over the global
    batches, two steps at the full learning rate: each step's grad_norm
    (the whole gradient's norm, before the clip) within STEP_TOL, both
    moments within STEP_TOL of each leaf's largest magnitude (f32 sums over
    the ranks in another order), each param's update within GRAD_TOL
    relative norm, all the same on both ranks bit for bit; the ranks' losses average to the global one. AdamW's
    update is blind to a constant factor on the gradient; grad_norm and the
    moments are not. Dense families only: a MoE layer over 2 data ranks has
    per-shard capacity and aux, the reference's sharded semantics, so its
    step is another computation than the global one (its 2x2 parity with
    the reference is the test above)."""
    from repro_torch.models import init_params
    step_tol = 2e-5
    cfg = _f32(get_smoke(arch))
    outs = [dict(np.load(p)) for p in run_ranks(
        tmp_path, "gradspecs", 2, arch, script=Path(__file__))]
    model = make_trainable(cfg, init_params(cfg, 0, device="cpu"))
    oc = OptConfig(**GRADSPECS_OPT)
    opt = init_opt_state(oc, dict(model.named_parameters()))
    step = make_train_step(cfg, oc, microbatches=2)
    losses, norms = [], []
    for tokens, labels in _gradspecs_batches(cfg):
        _, opt, metrics = step(model, opt, {"tokens": torch.from_numpy(tokens),
                                            "labels": torch.from_numpy(labels)})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    np.testing.assert_allclose((outs[0]["loss"] + outs[1]["loss"]) / 2,
                               losses, rtol=step_tol)
    for o in outs:
        np.testing.assert_allclose(o["grad_norm"], norms, rtol=step_tol)
    for kind, tree in (("m", opt["m"]), ("v", opt["v"])):
        for k, v in tree.items():
            want = v.numpy()
            got = outs[0][f"{kind}__{k}"]
            np.testing.assert_array_equal(got, outs[1][f"{kind}__{k}"])
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= step_tol * scale, (kind, k)
    # the params by their updates: Adam's m / (sqrt(v) + eps) moves a
    # gradient element near eps by far more than its rounding, so one
    # element may sit off by more than STEP_TOL of its leaf (a zero-centred
    # norm gain); the update's relative norm per leaf is held at GRAD_TOL
    start = dict(make_trainable(cfg, init_params(cfg, 0, device="cpu"))
                 .named_parameters())
    for k, v in model.named_parameters():
        p0 = start[k].detach().numpy()
        got = outs[0][f"p__{k}"]
        np.testing.assert_array_equal(got, outs[1][f"p__{k}"])
        assert _rel(got - p0, v.detach().numpy() - p0) < GRAD_TOL, k


# ------------------------------------------------- every family under rules
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_every_family_under_rules_equals_unmeshed(arch, gloo_mesh):
    """Every hint site on the train, prefill and decode paths under the
    rules of a 1x1 mesh: plain tensors pass through, so the loss, its
    gradient, the prefill logits and a decode step equal the unmeshed run
    bit for bit (a rank mismatch at any site would raise)."""
    from repro_torch.models import model as M
    cfg = _f32(get_smoke(arch))
    model = make_trainable(cfg, M.init_params(cfg, 0, device="cpu"))
    if cfg.family == "vlm":
        with torch.no_grad():
            for xp in model.cross_blocks:
                xp["gate"].fill_(0.5)
                xp["gate_mlp"].fill_(0.5)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = torch.from_numpy(rng.normal(size=(2, n, cfg.d_model))
                                      .astype(np.float32))
    params = [p for _, p in model.named_parameters()]

    def run():
        loss, _ = M.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            logits, state = M.prefill(cfg, model, batch, 24)
            step, _ = M.decode_step(cfg, model, state, tok[:, :1])
        return [loss.detach(), logits, step, *grads]

    want = run()
    calls = []
    orig = moe._moe_ffn_sharded
    moe._moe_ffn_sharded = lambda *a: calls.append(1) or orig(*a)
    try:
        with sharding_rules(gloo_mesh):
            got = run()
    finally:
        moe._moe_ffn_sharded = orig
    assert bool(calls) == (cfg.family == "moe")
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


# ------------------------------------------------------------ on the card
@pytest.fixture
def nccl_mesh():
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_equals_global_on_the_card(arch, nccl_mesh):
    import torch.distributed as dist
    assert dist.get_backend() == "nccl"
    cfg = _f32(get_smoke(arch))
    flat, x_np = _jax_inputs(arch)
    p = _port_params(flat, "cuda")
    x = torch.tensor(x_np, device="cuda", requires_grad=True)
    out_g, aux_g = moe._moe_ffn_global(cfg, p, x)
    with sharding_rules(nccl_mesh):
        out_s, aux_s = moe.moe_ffn(cfg, p, x)
    assert torch.equal(out_s, out_g) and torch.equal(aux_s, aux_g)
    ga = torch.autograd.grad(out_g.sum() + aux_g, [x, p["w1"]])
    gb = torch.autograd.grad(out_s.sum() + aux_s, [x, p["w1"]])
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
