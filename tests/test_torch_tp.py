"""The sharded step (``dist.sharding.shard_model``: DTensor params and
activations, K1 and K2 on each rank's heads, the recurrent scans on each
rank's plain tensors) against the reference's SPMD step.

* On gloo ranks (subprocesses of this file on a ``FileStore`` under the
  test's directory, each run with its own timeout), all ten archs' smoke
  configs in f32 on a ("data", "model") 2x2 mesh, granite on 1x4 (its 2
  kv heads do not divide 4: each rank reads the kv head of its query
  heads; the decode cache's rows are sharded and gathered), minitron on
  1x4 (6 query heads: the query rows take "model", with ``q_offset`` at
  each rank's first row), gemma3-27b on 1x2 (3 kv heads for 3 query heads
  a rank: a group split across ranks), zamba2 on 1x4 (one SSM head and one
  attention head a rank) and rwkv on 1x4 (2 heads do not divide 4: the
  scan's heads replicate, d still splits): the loss, every gradient
  (gathered whole only for the comparison; the step keeps them on their
  params' placements), the prefill logits and one decode step. The
  reference jits ``loss_fn``'s value and gradient, ``make_prefill_step``
  and ``make_serve_step`` with ``in_shardings`` from its spec trees under
  ``sharding_rules``, on a ``jax.sharding.Mesh`` of 4 forced host devices
  (Auto axes), in one subprocess with ``XLA_FLAGS``. Loss and logits within
  OUT_TOL of the largest magnitude, each gradient leaf within GRAD_TOL
  relative error norm.
* On the same ranks, one AdamW step of ``make_train_step`` in
  microbatches on a batch of 4 rows (each microbatch split over the DP
  ranks, or, at 4 microbatches on 2x2, replicated): granite on 2x2 and 1x4,
  gemma3-12b, whisper, llama-3.2-vision, deepseek, zamba2 and rwkv on 2x2,
  against the reference's ``make_train_step`` jitted with the same
  ``in_shardings``: the loss, ``grad_norm`` and ``lr`` within STEP_TOL,
  both moments within STEP_TOL of each leaf's largest magnitude (rwkv's
  within RWKV_STEP_TOL of the reference's unsharded jitted step: its SPMD
  step rounds the ``u`` moment farther from an f64 evaluation than that),
  and each side's params equal, within UPDATE_TOL of each element and of
  one step's size, to the reference's AdamW formula applied to that side's
  own moments. Half of the first row's labels are ignored, so that which
  rows a microbatch holds changes the loss. The params are not compared
  across the two sides element by element: where a gradient is near
  ``eps`` (1e-9 against 1e-8), Adam's ``m / (sqrt(v) + eps)`` turns the
  moments' last-bit differences into an update that differs by percents.
  Every rank's loss, ``grad_norm`` and ``lr`` are equal bit for bit, and no
  partial sum is reduced one mesh dim at a time.
* Per-device matmul FLOPs of the smoke forward on a 2x2 mesh: the port's
  count (``launch.op_analysis`` on meta tensors over a fake 4-rank group,
  rank 0's shards) equals ``repro.launch.hlo_analysis`` of the reference's
  compiled SPMD program, with K1's rows taken at the reference's masked
  square, as in ``test_torch_launch.py``; zamba2's chunked SSD by formula.
* On a one-rank gloo mesh: the sharded step equals the unmeshed one bit
  for bit (five archs), and the SSD's chunk loop and the WKV token loop
  dispatch no DTensor op.
* Tests marked ``gpu``: the sharded step on a one-rank NCCL mesh equals the
  unmeshed step bit for bit (granite, deepseek).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 2e-5
UPDATE_TOL = 1e-6      # a few f32 roundings of the updated param
RUN_TIMEOUT = 600     # seconds for all the runs (~175 s alone, 1 thread each)
B, S, MAX_SEQ = 2, 16, 24
ARCHS = ["granite-3-2b", "minitron-8b", "gemma3-12b", "gemma3-27b",
         "whisper-medium", "llama-3.2-vision-90b", "deepseek-v3-671b",
         "arctic-480b", "zamba2-7b", "rwkv6-1.6b"]
CASES = [(a, 2, 2) for a in ARCHS] + [("granite-3-2b", 1, 4),
                                      ("minitron-8b", 1, 4),
                                      ("gemma3-27b", 1, 2),
                                      ("zamba2-7b", 1, 4),
                                      ("rwkv6-1.6b", 1, 4)]
# (arch, data, model, microbatches) of the train-step cases, on a batch of
# B_TRAIN rows
B_TRAIN = 4
TRAIN_CASES = [("granite-3-2b", 2, 2, 2), ("granite-3-2b", 2, 2, 4),
               ("granite-3-2b", 1, 4, 2), ("gemma3-12b", 2, 2, 2),
               ("whisper-medium", 2, 2, 2),
               ("llama-3.2-vision-90b", 2, 2, 2),
               ("deepseek-v3-671b", 2, 2, 2), ("zamba2-7b", 2, 2, 2),
               ("rwkv6-1.6b", 2, 2, 2)]
TRAIN_OPT = dict(warmup_steps=1, total_steps=10)
# rwkv's leaves: its bridged smoke params are ill-conditioned (a one-ulp
# change moves its f32 gradients by 1.0e-4; test_torch_train_families.py)
RWKV_STEP_TOL = 2e-4


def _tag(arch, data, model) -> str:
    return f"{arch}-{data}x{model}"


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


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


def _train_tag(arch, data, model, mb) -> str:
    return f"{_tag(arch, data, model)}-mb{mb}"


def _inputs(out_dir: Path, tag: str, kind: str = "batch"
            ) -> tuple[dict, dict]:
    params = dict(np.load(out_dir / f"params.{tag.split('-mb')[0]}.npz"))
    batch = dict(np.load(out_dir / f"{kind}.{tag}.npz"))
    return params, batch


def _cases(spec: str):
    """(tag, arch, data, model, microbatches or None) of a case list
    ``arch:data:model[:mb],...``."""
    for case in spec.split(","):
        arch, *dims = case.split(":")
        data, model, mb = (int(d) for d in (dims + [0])[:3])
        tag = _train_tag(arch, data, model, mb) if mb else \
            _tag(arch, data, model)
        yield tag, arch, data, model, mb or None


# --------------------------------------------------------------- rank entry
def _train_port(cfg, model, mesh, batch, mb, out_dir, tag) -> dict:
    """One AdamW step of ``make_train_step`` in ``mb`` microbatches on the
    sharded ``model``: loss, grad_norm, and the params and moments whole,
    by the reference's keys. The moments are DTensors on their params'
    placements. Every rank saves its own loss, grad_norm and lr."""
    import torch.distributed as dist

    from repro_torch import _bridge
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    import torch.distributed.tensor._redistribute as redistribute
    oc = OptConfig(**TRAIN_OPT)
    named = dict(model.named_parameters())
    opt = init_opt_state(oc, named)
    # DTensor's notice of a reduction run one mesh dim at a time
    sequential = []
    warn = "_warn_flatten_optimization_not_possible"
    if hasattr(redistribute, warn):
        setattr(redistribute, warn, lambda *a, **k: sequential.append(a))
    _, opt, metrics = make_train_step(cfg, oc, microbatches=mb)(
        model, opt, batch)
    res = {k: metrics[k].numpy() for k in ("loss", "grad_norm", "lr")}
    np.savez(out_dir / f"metrics.{tag}.{dist.get_rank()}.npz",
             sequential=len(sequential), **res)
    for kind, tree in (("p", named), ("m", opt["m"]), ("v", opt["v"])):
        whole = {}
        for k, t in tree.items():
            assert t.placements == named[k].placements, (kind, k)
            whole[k] = t.detach().full_tensor()
        res.update({f"{kind}/{k}": v.numpy() for k, v in _bridge._flat(
            _bridge._stack(whole, "cpu")).items()})
    return res


def _worker_port(rank, world, store, out_dir, cases):
    """One gloo rank: every case's sharded loss and gradients, prefill and
    decode step, or its train step; rank 0 saves them whole."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import _bridge
    from repro_torch.configs import get_smoke
    from repro_torch.dist.sharding import shard_batch, shard_model
    from repro_torch.models import model as M
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out_dir = Path(out_dir)
    try:
        for tag, arch, data, model_ax, mb in _cases(cases):
            mesh = init_device_mesh("cpu", (data, model_ax),
                                    mesh_dim_names=("data", "model"))
            cfg = _f32(get_smoke(arch))
            params, batch = _inputs(out_dir, tag,
                                    "tbatch" if mb else "batch")
            model = M.make_trainable(cfg, _bridge.from_reference(
                cfg, _nest(params), "cpu"))
            shard_model(cfg, model, mesh)
            if mb:
                res = _train_port(cfg, model, mesh, {
                    k: torch.from_numpy(v) for k, v in batch.items()}, mb,
                    out_dir, tag)
                if rank == 0:
                    np.savez(out_dir / f"port.{tag}.npz", **res)
                continue
            named = dict(model.named_parameters())
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            with M.sharded_pass(model):
                loss, _ = M.loss_fn(cfg, model, shard_batch(cfg, b, mesh))
                grads = torch.autograd.grad(loss, list(named.values()))
            whole = {}
            for (k, p), g in zip(named.items(), grads):
                g = g.redistribute(mesh, p.placements)
                assert g.placements == p.placements, k
                assert g.to_local().shape == p.to_local().shape, k
                whole[k] = g.full_tensor()
            logits, state = make_prefill_step(cfg, MAX_SEQ)(model, b)
            step, _ = make_serve_step(cfg)(model, state, b["tokens"][:, :1])
            res = {"loss": loss.detach().full_tensor().numpy(),
                   "logits": logits.full_tensor().numpy(),
                   "step": step.full_tensor().numpy()}
            if rank == 0:
                res.update({f"g/{k}": v.numpy() for k, v in _bridge._flat(
                    _bridge._stack(whole, "cpu")).items()})
                np.savez(out_dir / f"port.{tag}.npz", **res)
    finally:
        dist.destroy_process_group()


def _reference(out_dir, cases, part):
    """The reference's SPMD steps for every case, in one process with 4
    forced host devices: value and gradient of ``loss_fn``, the prefill
    logits, one decode step, and the per-device dot FLOPs of the compiled
    forward."""
    import jax
    from jax.sharding import Mesh

    import repro  # noqa: F401 - the jax API shims
    from repro.configs import get_smoke
    from repro.dist import sharding as jshd
    from repro.dist.hints import sharding_rules
    from repro.launch import hlo_analysis
    from repro.models import model as RM
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import (make_prefill_step, make_serve_step,
                                        make_train_step)
    out_dir = Path(out_dir)
    flops = {}
    for tag, arch, data, model_ax, mb in _cases(cases):
        cfg = _f32(get_smoke(arch))
        params, batch = _inputs(out_dir, tag, "tbatch" if mb else "batch")
        params = jax.tree.map(jax.numpy.asarray, _nest(params))
        batch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        mesh = Mesh(np.array(jax.devices()[:data * model_ax]).reshape(
            data, model_ax), ("data", "model"))
        with mesh:
            psp = jshd.named(mesh, jshd.param_specs(cfg, params, mesh))
            bsp = jshd.named(mesh, jshd.batch_specs(cfg, batch, mesh))
            if mb:
                oc = OptConfig(**TRAIN_OPT)
                opt = init_opt_state(oc, params)
                osp = {"m": psp, "v": psp,
                       "step": jax.sharding.NamedSharding(
                           mesh, jax.sharding.PartitionSpec())}
                with sharding_rules(mesh):
                    step = jax.jit(make_train_step(cfg, oc, microbatches=mb),
                                   in_shardings=(psp, osp, bsp)).lower(
                        params, opt, batch)
                new, new_opt, metrics = step.compile()(params, opt, batch)
                res = {k: np.asarray(metrics[k])
                       for k in ("loss", "grad_norm", "lr")}
                for kind, tree in (("p", new), ("m", new_opt["m"]),
                                   ("v", new_opt["v"])):
                    res.update({f"{kind}/{k}": np.asarray(v)
                                for k, v in _flat(tree).items()})
                np.savez(out_dir / f"ref.{tag}.npz", **res)
                if cfg.family == "rwkv":     # its moments' yardstick
                    _, plain, _ = jax.jit(make_train_step(
                        cfg, oc, microbatches=mb))(params, opt, batch)
                    np.savez(out_dir / f"ref_plain.{tag}.npz", **{
                        f"{kind}/{k}": np.asarray(v) for kind in ("m", "v")
                        for k, v in _flat(plain[kind]).items()})
                continue
            with sharding_rules(mesh):
                grad = jax.jit(jax.value_and_grad(
                    lambda p, b: RM.loss_fn(cfg, p, b)[0]),
                    in_shardings=(psp, bsp)).lower(params, batch)
                fwd = jax.jit(lambda p, b: RM.loss_fn(cfg, p, b)[0],
                              in_shardings=(psp, bsp)).lower(params, batch)
                pre = jax.jit(make_prefill_step(cfg, MAX_SEQ),
                              in_shardings=(psp, bsp)).lower(params, batch)
            loss, g = grad.compile()(params, batch)
            flops[tag] = hlo_analysis.analyze(
                fwd.compile().as_text())["dot_flops"]
            logits, state = pre.compile()(params, batch)
            tok = batch["tokens"][:, :1]
            ssp = jshd.named(mesh, jshd.decode_state_specs(cfg, state, mesh))
            tsp = jshd.named(mesh, jshd.batch_specs(cfg, {"t": tok},
                                                    mesh))["t"]
            state, tok = jax.device_put(state, ssp), jax.device_put(tok, tsp)
            with sharding_rules(mesh):
                dec = jax.jit(make_serve_step(cfg),
                              in_shardings=(psp, ssp, tsp)).lower(
                    params, state, tok)
            step, _ = dec.compile()(params, state, tok)
        res = {"loss": np.asarray(loss), "logits": np.asarray(logits),
               "step": np.asarray(step)}
        res.update({f"g/{k}": np.asarray(v) for k, v in _flat(g).items()})
        np.savez(out_dir / f"ref.{tag}.npz", **res)
    (out_dir / f"ref_flops.{part}.json").write_text(json.dumps(flops))


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "port":
        _worker_port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5], sys.argv[6])
    elif mode == "ref":
        _reference(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        raise SystemExit(f"unknown mode {mode}")
    sys.exit(0)

# ==================================================================== tests
import torch.distributed as dist  # noqa: E402

from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.dist.sharding import shard_model  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch.mesh import init_fake_group  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402


def _case_inputs(out_dir: Path, arch: str, data: int, model: int) -> None:
    """Seeded params (the port's init, in the reference's layout) and a
    batch for one case; the vlm gates opened so the cross layers count."""
    cfg = _f32(get_smoke(arch))
    m = M.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":
        with torch.no_grad():
            for xp in m.cross_blocks:
                xp["gate"].fill_(0.5)
                xp["gate_mlp"].fill_(0.5)
    tag = _tag(arch, data, model)
    np.savez(out_dir / f"params.{tag}.npz", **{
        k: v.numpy() for k, v in _bridge._flat(
            _bridge.to_reference(cfg, m, "cpu")).items()})
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    np.savez(out_dir / f"batch.{tag}.npz", **batch)


def _train_inputs(out_dir: Path, arch: str, data: int, model: int,
                  mb: int) -> None:
    """A seeded batch of B_TRAIN rows for one train-step case (its params
    are its mesh case's), half of the first row's labels ignored."""
    cfg = _f32(get_smoke(arch))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, (B_TRAIN, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][0, :S // 2] = -1
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = rng.normal(size=(B_TRAIN, n, cfg.d_model)).astype(
            np.float32)
    np.savez(out_dir / f"tbatch.{_train_tag(arch, data, model, mb)}.npz",
             **batch)


def _spawn(args, log: Path, env: dict) -> tuple:
    f = open(log, "w")
    return subprocess.Popen([sys.executable, __file__, *args], stdout=f,
                            stderr=subprocess.STDOUT, env=env, cwd=ROOT), f


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case run once: the reference's two processes (the mesh cases,
    the train cases), 4 gloo ranks for the 2x2 and 1x4 cases and 2 for the
    1x2 case, all started together."""
    out = tmp_path_factory.mktemp("tp")
    for case in CASES:
        _case_inputs(out, *case)
    for case in TRAIN_CASES:
        _train_inputs(out, *case)
    spec = {w: ",".join([f"{a}:{d}:{m}" for a, d, m in CASES if d * m == w]
                        + [f"{a}:{d}:{m}:{mb}" for a, d, m, mb in TRAIN_CASES
                           if d * m == w])
            for w in (4, 2)}
    spec = {w: c for w, c in spec.items() if c}
    # one thread a process: 8 processes share the host with other workers;
    # the reference's compiles are the longest run, so its mesh cases and
    # its train cases run in two processes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    parts = (",".join(f"{a}:{d}:{m}" for a, d, m in CASES),
             ",".join(f"{a}:{d}:{m}:{mb}" for a, d, m, mb in TRAIN_CASES))
    procs = [_spawn(["ref", str(out), cases, str(i)], out / f"ref{i}.log",
                    dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                         "count=4"))
             for i, cases in enumerate(parts)]
    for world, cases in spec.items():
        store = out / f"store{world}"
        procs += [_spawn(["port", str(r), str(world), str(store), str(out),
                          cases], out / f"port{world}.{r}.log", env)
                  for r in range(world)]
    deadline = time.monotonic() + RUN_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait()
        pytest.fail(f"sharded runs still going after {RUN_TIMEOUT}s")
    finally:
        for _, f in procs:
            f.close()
    for (p, f) in procs:
        assert p.returncode == 0, Path(f.name).read_text()[-4000:]
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.linalg.norm(a))


@pytest.mark.parametrize("arch, data, model", CASES,
                         ids=[_tag(*c) for c in CASES])
def test_sharded_step_equals_the_references_spmd_step(runs, arch, data,
                                                      model):
    tag = _tag(arch, data, model)
    got = dict(np.load(runs / f"port.{tag}.npz"))
    want = dict(np.load(runs / f"ref.{tag}.npz"))
    vocab = get_smoke(arch).vocab          # padded columns hold -1e30
    for k in ("loss", "logits", "step"):
        if k != "loss":
            got[k], want[k] = got[k][..., :vocab], want[k][..., :vocab]
        scale = float(np.abs(want[k]).max())
        assert np.abs(got[k] - want[k]).max() <= OUT_TOL * scale, k
    grads = {k for k in want if k.startswith("g/")}
    assert grads == {k for k in got if k.startswith("g/")}
    for k in grads:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("arch, data, model, mb", TRAIN_CASES,
                         ids=[_train_tag(*c) for c in TRAIN_CASES])
def test_sharded_train_step_equals_the_references_spmd_step(runs, arch, data,
                                                            model, mb):
    tag = _train_tag(arch, data, model, mb)
    got = dict(np.load(runs / f"port.{tag}.npz"))
    want = dict(np.load(runs / f"ref.{tag}.npz"))
    assert set(got) == set(want)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL)
    p0, _ = _inputs(runs, tag, "tbatch")
    rwkv = get_smoke(arch).family == "rwkv"
    tol = RWKV_STEP_TOL if rwkv else STEP_TOL
    moments = dict(np.load(runs / f"ref_plain.{tag}.npz")) if rwkv else want
    for k in want:
        if k.startswith(("m/", "v/")):
            scale = max(float(np.abs(moments[k]).max()), 1e-30)
            assert np.abs(got[k] - moments[k]).max() <= tol * scale, k
    for side in (got, want):
        for k, p in p0.items():
            np.testing.assert_allclose(side[f"p/{k}"],
                                       _adamw_first_step(side, k, p),
                                       rtol=UPDATE_TOL,
                                       atol=UPDATE_TOL * side["lr"],
                                       err_msg=k)


@pytest.mark.parametrize("arch, data, model, mb", TRAIN_CASES,
                         ids=[_train_tag(*c) for c in TRAIN_CASES])
def test_replicated_metrics_are_equal_bit_for_bit_on_every_rank(
        runs, arch, data, model, mb):
    """The loss, grad_norm and lr each rank returns are one value: partial
    sums over the 2-D mesh (replicated params' gradients, the global norm)
    are reduced in one collective over all its ranks, never in two
    sequential all-reduces, which may round differently on different
    ranks (DTensor's notice of one is counted on every rank)."""
    tag = _train_tag(arch, data, model, mb)
    ranks = [dict(np.load(runs / f"metrics.{tag}.{r}.npz"))
             for r in range(data * model)]
    assert all(int(r["sequential"]) == 0 for r in ranks)
    for k in ("loss", "grad_norm", "lr"):
        assert all(r[k].tobytes() == ranks[0][k].tobytes()
                   for r in ranks), k


def _adamw_first_step(res: dict, k: str, p: np.ndarray) -> np.ndarray:
    """The reference's AdamW (``repro.train.optimizer.adamw_update``) at
    step 1 on the param ``p``, from the moments ``res`` holds for it (the
    clipped gradient is already in them), in f32."""
    oc = OptConfig(**TRAIN_OPT)
    b1, b2 = (np.float32(b) for b in oc.betas)
    f32 = np.float32
    mhat = res[f"m/{k}"] / (f32(1) - b1)
    vhat = res[f"v/{k}"] / (f32(1) - b2)
    wd = f32(oc.weight_decay) * f32(p.ndim >= 2)
    delta = mhat / (np.sqrt(vhat) + f32(oc.eps)) + wd * p
    return p - f32(res["lr"]) * delta


# ------------------------------------------------------- per-device FLOPs
def _port_flops_2x2(arch: str) -> tuple[float, float]:
    """rank 0's dot FLOPs of the sharded smoke forward on a 2x2 mesh (meta
    tensors, a fake 4-rank group), K1 at the masked square, and those of
    them in the chunked SSD's scan (``models.ssm._ssd_scan``)."""
    from torch.distributed.device_mesh import DeviceMesh
    cfg = _f32(get_smoke(arch))
    assert not dist.is_initialized()
    init_fake_group(4)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        model = shard_model(cfg, M.init_params(cfg, 0, device="meta"), mesh)
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                       device="meta")}
        batch["labels"] = torch.empty_like(batch["tokens"])
        key = M._EXTRAS.get(cfg.family)
        if key is not None:
            n = cfg.n_frames if key == "frames" else cfg.n_patches
            batch[key] = torch.empty((B, n, cfg.d_model), device="meta")
        from repro_torch.train.train_step import _placed_batch
        with torch.no_grad(), M.sharded_pass(model):
            a = op_analysis.analyze(M.loss_fn, cfg, model,
                                    _placed_batch(cfg, model, batch),
                                    params=model)
    finally:
        dist.destroy_process_group()
    kernel = square = ssd = 0.0
    for flops, n, op, where, shapes in a["dots"]:
        if op == "K1 flash_attention":
            (b, sq, hq, hd), (_, sk, _, _), (_, _, _, dv) = shapes
            dv = cfg.mla.v_head_dim if cfg.mla is not None else dv
            kernel += flops
            square += n * 2.0 * b * hq * sq * sk * (hd + dv)
        if where == "models.ssm:_ssd_scan":
            ssd += flops
    assert (kernel > 0) == (cfg.family != "rwkv")
    return a["dot_flops"] - kernel + square, ssd


def _ssd_work(cfg, rows: int, heads: int, bc_cut: int = 1,
              increment: bool = True) -> float:
    """The chunked SSD's products on ``rows`` batch rows and ``heads``
    heads, every Mamba2 layer, one forward: C B^T (its N cut into
    ``bc_cut`` blocks), the intra-chunk term, each chunk's state increment
    (``increment``) and the carried state's term."""
    from repro_torch.models.ssm import CHUNK, ssm_dims
    _, _, P, N = ssm_dims(cfg)
    Q = min(CHUNK, S)
    nc = -(-S // Q)
    layer = 2.0 * rows * nc * (Q * Q * N / bc_cut + heads * Q * Q * P
                               + heads * Q * P * N * (1 + increment))
    return cfg.n_layers * layer


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_dot_flops_equal_the_reference_hlo(runs, arch):
    """Equal to the reference's count. zamba2's chunked SSD is spelled with
    other products: the reference's compiled program cuts C B^T's N over
    "model" (B and C stay whole on the port's ranks) and drops the state
    increment a loss does not read (the port computes it). There the port's
    SSD products are those of each rank's rows and heads, and every other
    product equals the reference's."""
    want = json.loads((runs / "ref_flops.0.json").read_text())[
        _tag(arch, 2, 2)]
    got, ssd = _port_flops_2x2(arch)
    cfg = get_smoke(arch)
    if cfg.family != "hybrid":
        assert ssd == 0
        assert got == want
        return
    from repro_torch.models.ssm import ssm_dims
    rows, heads = B // 2, ssm_dims(cfg)[1] // 2
    assert ssd == _ssd_work(cfg, rows, heads)
    assert got - ssd == want - _ssd_work(cfg, rows, heads, bc_cut=2,
                                         increment=False)


# ------------------------------------------------ 1x1: equal to unmeshed
def _steps(cfg, model, batch, tok):
    """An AdamW step in 2 microbatches, a prefill and a decode step; every
    output whole, with the kernels' launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step,
                                              make_train_step)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    flash_attention.launches = decode_attention.launches = 0
    oc = OptConfig(warmup_steps=1, total_steps=10)
    opt = init_opt_state(oc, dict(model.named_parameters()))
    step = make_train_step(cfg, oc, microbatches=2)
    _, opt, metrics = step(model, opt, batch)
    outs = [metrics["loss"], metrics["grad_norm"]]
    logits, state = make_prefill_step(cfg, MAX_SEQ)(model, batch)
    dec, _ = make_serve_step(cfg)(model, state, tok)
    outs += [whole(logits), whole(dec)]
    outs += [whole(p.detach()) for p in model.parameters()]
    outs += [whole(m) for m in opt["m"].values()]
    return outs, (flash_attention.launches, decode_attention.launches)


def _equal_to_unmeshed(arch, device, mesh, dtype="float32"):
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, S + 1))
                           .astype(np.int32)).to(device)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = torch.from_numpy(rng.normal(size=(4, n, cfg.d_model))
                                      .astype(np.float32)).to(
            device, getattr(torch, dtype))
    runs = []
    for sharded in (False, True):
        model = M.make_trainable(cfg, M.init_params(cfg, 0, device=device))
        if cfg.family == "vlm":
            with torch.no_grad():
                for xp in model.cross_blocks:
                    xp["gate"].fill_(0.5)
                    xp["gate_mlp"].fill_(0.5)
        if sharded:
            shard_model(cfg, model, mesh)
            assert all(type(p.data).__name__ == "DTensor"
                       for p in model.parameters())
        runs.append(_steps(cfg, model, batch, tok[:, :1]))
    (a, la), (b, lb) = runs
    assert la == lb
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert type(y).__name__ != "DTensor" and torch.equal(x, y), i
    return la


@pytest.fixture
def gloo_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-3-2b", "llama-3.2-vision-90b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "rwkv6-1.6b"])
def test_sharded_step_on_1x1_equals_unmeshed_bit_for_bit(arch, gloo_mesh):
    """On a one-rank gloo mesh every placement holds the whole tensor: a
    train step (loss, grad_norm, params, moments), a prefill and a decode
    step equal the unmeshed ones bit for bit (dense, cross attention,
    MLA and the sharded MoE, the chunked SSD and the WKV scan)."""
    _equal_to_unmeshed(arch, "cpu", gloo_mesh)


@pytest.mark.parametrize("arch, module, scan", [
    ("zamba2-7b", "ssm", "_ssd_scan"), ("rwkv6-1.6b", "rwkv", "_wkv_scan")])
def test_recurrent_scans_dispatch_no_dtensor_op(arch, module, scan,
                                                gloo_mesh, monkeypatch):
    """The SSD's chunk loop and the WKV token loop run on each rank's
    plain tensors: on the sharded path (a 1x1 gloo mesh: a train step, a
    prefill, a decode step) no op dispatched inside them has a DTensor
    argument, while ops with DTensor arguments run around them."""
    import importlib

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    mod = importlib.import_module(f"repro_torch.models.{module}")
    inside, seen = [0], {"in": [0, 0], "out": [0, 0]}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            leaves, _ = tree_flatten((args, kwargs))
            where = seen["in" if inside[0] else "out"]
            where[any(isinstance(t, DTensor) for t in leaves)] += 1
            return func(*args, **(kwargs or {}))

    def counted(*a, **k):
        assert not any(isinstance(t, DTensor) for t in a if t is not None)
        inside[0] += 1
        try:
            return orig(*a, **k)
        finally:
            inside[0] -= 1

    orig = getattr(mod, scan)
    monkeypatch.setattr(mod, scan, counted)
    cfg = _f32(get_smoke(arch))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, S + 1)).astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    model = shard_model(cfg, M.make_trainable(cfg, M.init_params(
        cfg, 0, device="cpu")), gloo_mesh)
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import (make_prefill_step,
                                              make_serve_step,
                                              make_train_step)
    oc = OptConfig(**TRAIN_OPT)
    with Count():
        make_train_step(cfg, oc)(model, init_opt_state(
            oc, dict(model.named_parameters())), batch)
        _, state = make_prefill_step(cfg, MAX_SEQ)(model, batch)
        make_serve_step(cfg)(model, state, tok[:, :1])
    assert seen["in"][0] > 0 and seen["in"][1] == 0, seen
    assert seen["out"][1] > 0, seen


@pytest.fixture
def nccl_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    assert not dist.is_initialized()
    mesh = make_local_mesh(1, 1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_on_the_card_equals_unmeshed(arch, dtype, nccl_mesh):
    """The same on a one-rank NCCL mesh on the card, with K1 and K2
    launched as often as unmeshed (the kernels ran under local_map; MLA's
    decode launches no K2)."""
    assert dist.get_backend() == "nccl"
    k1, k2 = _equal_to_unmeshed(arch, "cuda", nccl_mesh, dtype)
    mla = get_smoke(arch).mla is not None      # MLA decodes in torch matmuls
    assert k1 > 0 and (k2 > 0) != mla
