"""The port's dry run, op analysis and per-cell profiler
(``repro_torch.launch.dryrun``, ``op_analysis``, ``profile_cell``) against
the reference's ``repro.launch``.

The reference's dry run compiles on 512 forced host devices and sets
``XLA_FLAGS`` when it is imported, so its cell list and recipes are read in
a subprocess. Its compile fails on this jax (``make_mesh`` makes Explicit
axes), so the port is held to it where it does not compile: the cells, the
recipes, and the bytes per device that the reference's spec trees give each
cell's arguments and outputs, built on a jax ``AbstractMesh``. The FLOP
count of a smoke forward is held to the reference's own analysis of its
compiled HLO (no mesh, so it compiles here), to itself across devices (meta
and CPU) and to the model's formula. Tests marked ``gpu`` decide inside a
fixture whether there is a card and skip here.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.dist import sharding as jshd
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro.models import model as RM
from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.kernels import attention_op
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import dryrun, op_analysis, profile_cell
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
CELLS = list(dryrun.cells())
CELL_TIMEOUT = 300                    # seconds a dry-run cell may take here


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")


# ------------------------------------------------------------ cells, recipes
REF_RECIPES = """
import json
from repro.launch import dryrun as D
from repro.configs import ARCH_NAMES, SHAPES, get_config, shapes_for
out = {"cells": [list(c) for c in D.cells()], "mb": {}, "moment": {}}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    out["moment"][arch] = D.opt_config_for(cfg).moment_dtype
    for shape in SHAPES.values():
        mb, acc = D.microbatches_for(cfg, shape)
        out["mb"][f"{arch}/{shape.name}"] = [
            mb, None if acc is None else str(acc.dtype if hasattr(acc, "dtype")
                                             else acc)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_recipes():
    out = subprocess.run([sys.executable, "-c", REF_RECIPES],
                         capture_output=True, text=True, timeout=600,
                         env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_equal_the_reference(ref_recipes):
    assert [list(c) for c in dryrun.cells()] == ref_recipes["cells"]
    assert len(CELLS) == 68
    assert list(dryrun.cells("granite-3-2b", mesh_filter="pod1")) == [
        ("granite-3-2b", s, "pod1")
        for s in ("train_4k", "prefill_32k", "decode_32k")]


def test_recipes_equal_the_reference(ref_recipes):
    for key, (mb, acc) in ref_recipes["mb"].items():
        arch, shape = key.split("/")
        cfg = get_config(arch)
        got_mb, got_acc = dryrun.microbatches_for(cfg, SHAPES[shape])
        assert got_mb == mb, key
        assert (None if got_acc is None
                else str(got_acc).removeprefix("torch.")) == acc, key
        assert dryrun.opt_config_for(cfg).moment_dtype == \
            ref_recipes["moment"][arch]


# --------------------------------------------------------------- the bytes
def _jleaves(tree):
    return jax.tree.leaves(tree)


def _jspec_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _jbytes(tree, specs, mesh, dtype=None) -> int:
    """Bytes one device holds of a ShapeDtypeStruct tree under a
    PartitionSpec tree on a jax AbstractMesh."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    for leaf, spec in zip(_jleaves(tree), _jspec_leaves(specs)):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for d, e in zip(leaf.shape, entries):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            k = 1
            for a in axes:
                k *= sizes[a]
            assert d % k == 0
            n *= d // k
        total += n * np.dtype(dtype or leaf.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jspecs.params_specs_for(jax_config(arch))


def _ref_cell_bytes(arch, shape_name, mesh_kind) -> tuple[dict, dict]:
    cfg = jax_config(arch)
    shape = JAX_SHAPES[shape_name]
    mesh = JaxAbstractMesh(*dryrun.MESHES[mesh_kind])
    p = _ref_params(arch)
    p_spec = jshd.param_specs(cfg, p, mesh)
    args = {"params": _jbytes(p, p_spec, mesh)}
    if shape.kind == "train":
        moment = {"float32": np.float32, "bfloat16": jnp.bfloat16}[
            dryrun.opt_config_for(get_config(arch)).moment_dtype]
        args["opt_state"] = 2 * _jbytes(p, p_spec, mesh, moment) + 4
        batch = jspecs.batch_specs_for(cfg, shape)
        args["batch"] = _jbytes(batch, jshd.batch_specs(cfg, batch, mesh),
                                mesh)
        return args, {"params": args["params"],
                      "opt_state": args["opt_state"]}
    state, tokens = jspecs.decode_specs_for(cfg, shape)
    if shape.kind == "prefill":
        batch = jspecs.batch_specs_for(cfg, shape)
        args["batch"] = _jbytes(batch, jshd.batch_specs(cfg, batch, mesh),
                                mesh)
    else:
        args["state"] = _jbytes(state, jshd.decode_state_specs(
            cfg, state, mesh), mesh)
        args["tokens"] = _jbytes({"t": tokens}, jshd.batch_specs(
            cfg, {"t": tokens}, mesh), mesh)
    B = shape.global_batch
    logits = jax.eval_shape(lambda p: RM._head(cfg, p, jnp.zeros(
        (B, 1, cfg.d_model), jnp.dtype(cfg.dtype))), p)
    outs = {"logits": _jbytes({"l": logits}, jshd.batch_specs(
        cfg, {"l": logits}, mesh), mesh),
        "state": _jbytes(state, jshd.decode_state_specs(cfg, state, mesh),
                         mesh)}
    return args, outs


@pytest.mark.parametrize("arch, shape, mesh", CELLS,
                         ids=["/".join(c) for c in CELLS])
def test_bytes_per_device_equal_the_reference_spec_trees(arch, shape, mesh):
    """Per-device argument and output bytes of every cell: the port's spec
    trees on its AbstractMesh against the reference's on jax's."""
    got = dryrun.cell_bytes(get_config(arch), SHAPES[shape],
                            dryrun.abstract_mesh(mesh))
    want_args, want_outs = _ref_cell_bytes(arch, shape, mesh)
    assert got["argument_bytes"] == want_args
    assert got["output_bytes"] == want_outs
    assert got["argument_size_in_bytes"] == sum(want_args.values())
    assert got["output_size_in_bytes"] == sum(want_outs.values())


def test_data_rank_batch_follows_batch_specs():
    m1, m2 = dryrun.abstract_mesh("pod1"), dryrun.abstract_mesh("pod2")
    g = get_config("granite-3-2b")
    assert dryrun.data_rank_batch(g, SHAPES["train_4k"], m1) == 16
    assert dryrun.data_rank_batch(g, SHAPES["train_4k"], m2) == 8
    assert dryrun.data_rank_batch(g, SHAPES["prefill_32k"], m1) == 2
    assert dryrun.data_rank_batch(g, SHAPES["decode_32k"], m2) == 4
    # long_500k's batch of 1 does not divide: replicated
    r = get_config("rwkv6-1.6b")
    assert dryrun.data_rank_batch(r, SHAPES["long_500k"], m2) == 1


# ------------------------------------------------------------ op analysis
def _seeded_batch(cfg, B, S, dev):
    x = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
    x = torch.from_numpy(x.astype(np.int32)).to(dev)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = torch.ones((B, n, cfg.d_model), device=dev)
    return batch


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b",
                                  "whisper-medium"])
def test_dot_flops_are_the_same_on_meta_and_cpu(arch):
    """The smoke forward's count: the same on ``meta`` and ``cpu`` (the
    plain attention's masked square is not counted, the kernel's work is),
    and granite's equals ``forward_flops``; gemma3 has windows, whisper
    cross attention."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    B, S = 2, 48
    counts = {}
    for dev in ("cpu", "meta"):
        model = M.init_params(cfg, 0, device=dev)
        with torch.no_grad():
            a = op_analysis.analyze(M.loss_fn, cfg, model,
                                    _seeded_batch(cfg, B, S, dev),
                                    params=model)
        counts[dev] = a["dot_flops"]
        assert any(op == "K1 flash_attention" for _, _, op, _, _ in a["dots"])
    assert counts["cpu"] == counts["meta"] > 0
    if arch == "granite-3-2b":
        assert counts["meta"] == op_analysis.forward_flops(cfg, B, S)


def _ref_hlo_dot_flops(arch: str, B: int, S: int) -> float:
    """``repro.launch.hlo_analysis``'s ``dot_flops`` of the reference's
    jitted smoke ``loss_fn`` (f32), on the batch ``_seeded_batch`` makes."""
    cfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
    x = x.astype(np.int32)
    batch = {"tokens": jnp.asarray(x[:, :-1]), "labels": jnp.asarray(x[:, 1:])}
    key = M._EXTRAS.get(cfg.family)
    if key is not None:
        n = cfg.n_frames if key == "frames" else cfg.n_patches
        batch[key] = jnp.ones((B, n, cfg.d_model), jnp.float32)
    text = jax.jit(lambda p, b: RM.loss_fn(cfg, p, b)).lower(
        params, batch).compile().as_text()
    return hlo_analysis.analyze(text)["dot_flops"]


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b",
                                  "whisper-medium", "llama-3.2-vision-90b",
                                  "deepseek-v3-671b", "rwkv6-1.6b"])
def test_dot_flops_equal_the_reference_hlo(arch):
    """The port's count of a smoke forward on meta tensors, held to the
    reference's while-aware count of the same forward's compiled HLO. The
    reference's plain attention computes the masked square, so the port's
    K1 rows are replaced by that square, ``2 * B * Hq * Sq * Sk * (hd + dv)``
    a call, with dv at the reference's V width (MLA's V is padded to the
    query width for K1 in the port). Every other matmul is the same op on
    both sides. zamba2 is left out: its chunked SSD is spelled with other
    products (at one chunk the port multiplies C by the zero initial state
    in 8 ``bmm``s, the reference's HLO has no such dot)."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    B, S = 2, 48
    model = M.init_params(cfg, 0, device="meta")
    with torch.no_grad():
        a = op_analysis.analyze(M.loss_fn, cfg, model,
                                _seeded_batch(cfg, B, S, "meta"), params=model)
    kernel = square = 0.0
    for flops, n, op, _, shapes in a["dots"]:
        if op == "K1 flash_attention":
            (b, sq, hq, hd), (_, sk, _, _), (_, _, _, dv) = shapes
            dv = cfg.mla.v_head_dim if cfg.mla is not None else dv
            kernel += flops
            square += n * 2.0 * b * hq * sq * sk * (hd + dv)
        assert not op.startswith("K2")
    assert (kernel > 0) == (cfg.family != "rwkv")
    assert a["dot_flops"] - kernel + square == _ref_hlo_dot_flops(arch, B, S)


def test_op_counter_sees_attention_from_any_caller():
    """The kernel ops report to the counter at their source: a call from
    outside the models counts K1's causal work (not the plain version's
    masked square that runs on the CPU), and nothing observes the ops
    after the counter exits."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 4, 16),
                                                    np.float32))
               for _ in range(3))
    a = op_analysis.analyze(lambda: attention_op(q, k, v, causal=True))
    ops, _ = op_analysis.flash_work((1, 32, 32, 4, 4, 16, True, 0, 0), 4)
    assert a["dot_flops"] == ops == 2.0 * 4 * 32 * 32 * 33 / 2
    assert [op for _, _, op, _, _ in a["dots"]] == ["K1 flash_attention"]
    assert kernel_ops.observer() is None


def test_op_counter_counts_a_matmul_and_a_gloo_all_gather(tmp_path):
    """A known matmul's 2 m n k, and a one-rank gloo all_gather's result
    bytes, each once."""
    from repro_torch.dist import collectives
    x, w = torch.randn(4, 6), torch.randn(6, 5)
    a = op_analysis.analyze(lambda: x @ w)
    assert a["dot_flops"] == 2 * 4 * 6 * 5
    assert a["result_bytes"] == 4 * 5 * 4
    assert a["collective_count"] == 0
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t = torch.randn(3, 7)
        a = op_analysis.analyze(collectives.all_gather, t, 0,
                                dist.group.WORLD)
        assert torch.equal(a["out"], t)
    finally:
        dist.destroy_process_group()
    assert a["collective_bytes"]["all-gather"] == 3 * 7 * 4
    assert a["collective_count"] == 1
    assert a["collective_total"] == 3 * 7 * 4
    assert a["dot_flops"] == 0
    assert "all-gather" in op_analysis.top_collectives(a)[0]


def _flash_pairs_loop(case):
    """The visible (q, k) pairs, one query row at a time."""
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    pairs = 0
    for i in range(Sq):
        qp = off + i
        hi = min(Sk - 1, qp) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
    return pairs


@pytest.mark.parametrize("case", [
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 300, 4, 4, 72, True, 0, 200),
    (2, 256, 256, 4, 2, 64, True, 64, 0),
    (1, 96, 160, 2, 2, 48, False, 0, 0),
    (1, 64, 300, 8, 2, 64, True, 37, 236),
    (1, 40, 30, 2, 1, 16, True, 5, 100),       # rows past the keys
    (2, 32768, 32768, 32, 8, 64, True, 0, 0),  # prefill_32k
])
def test_flash_work_counts_the_visible_pairs(case):
    B, Sq, Sk, Hq, Hkv, hd, causal, window, off = case
    ops, nbytes = op_analysis.flash_work(case, 2, 48)
    assert ops == 2.0 * B * Hq * (hd + 48) * _flash_pairs_loop(case)
    assert nbytes == 2 * (B * Sq * Hq * (hd + 48) + B * Sk * Hkv * (hd + 48))


def test_decode_work_counts_live_rows():
    ops, nbytes = op_analysis.decode_work((3, 100, 8, 2, 16, 0),
                                          [1, 50, 500], 2)
    assert ops == 4.0 * 8 * 16 * (1 + 50 + 100)
    ops_w, _ = op_analysis.decode_work((3, 100, 8, 2, 16, 20),
                                       [1, 50, 500], 2)
    assert ops_w == 4.0 * 8 * 16 * (1 + 20 + 20)
    assert nbytes == 2 * (2 * 2 * 16 * 151 + 2 * 3 * 8 * 16) + 4 * 3


def test_decode_on_meta_needs_live_rows():
    cfg = get_smoke("granite-3-2b")
    model = M.init_params(cfg, device="meta")
    state = M.init_decode_state(cfg, 2, 32, device="meta")
    tok = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="live_rows"):
        op_analysis.analyze(M.decode_step, cfg, model, state, tok)
    a = op_analysis.analyze(M.decode_step, cfg, model, state, tok,
                            live_rows=32)
    k2 = [r for r in a["dots"] if r[2] == "K2 decode_attention"]
    assert sum(n for _, n, _, _, _ in k2) == cfg.n_layers
    assert sum(fl for fl, _, _, _, _ in k2) == \
        cfg.n_layers * 4.0 * cfg.n_heads * cfg.hd * 2 * 32


# ------------------------------------------------------- the meta wrappers
def test_kernel_wrappers_on_meta_launch_nothing():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                     flash_attention)
    n1, n2 = flash_attention.launches, decode_attention.launches
    q = torch.empty((2, 8, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    o = flash_attention(q, kv, kv)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    qd = torch.empty((2, 4, 64), dtype=torch.bfloat16, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    o = decode_attention(qd, kv, kv, lens)
    assert (o.shape, o.dtype, o.device.type) == (qd.shape, qd.dtype, "meta")
    qg, kg, vg = (torch.empty(t.shape, dtype=t.dtype, device="meta",
                              requires_grad=True) for t in (q, kv, kv))
    out = FlashAttentionFunction.apply(qg, kg, vg, True, 0, 0, None)
    dq, dk, dv = torch.autograd.grad(out.sum(), (qg, kg, vg))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, kv.shape, kv.shape)
    assert (flash_attention.launches, decode_attention.launches) == (n1, n2)


# ------------------------------------------------------------- the dry run
def test_import_sets_no_environment_and_starts_no_group():
    code = ("import os, torch.distributed as dist\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.profile_cell\n"
            "assert dict(os.environ) == before\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = _env()
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("arch, shape, mesh, batch", [
    ("granite-3-2b", "decode_32k", "pod1", 8),
    ("rwkv6-1.6b", "long_500k", "pod2", 1),
])
def test_dry_run_cell_is_ok_at_full_size(tmp_path, arch, shape, mesh, batch):
    """The CLI on one cell at published width and depth (meta tensors, a
    fake group of 512 ranks), in a subprocess with a time limit; then again
    with --skip-done, which runs nothing."""
    out = tmp_path / "dry.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out)]
    p = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=CELL_TIMEOUT, env=_env(), cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "done: 1 ok, 0 failed" in p.stdout
    (rec,) = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert rec["ok"], rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"]) == \
        (arch, shape, mesh, "decode")
    assert rec["n_devices"] == (256 if mesh == "pod1" else 512)
    tp = arch == "granite-3-2b"           # rwkv has no sharded step
    assert rec["tp_on_activations"] is tp
    assert rec["fits_note"].startswith("one device's" if tp
                                       else "upper bound")
    assert rec["batch_per_data_rank"] == batch
    assert rec["microbatches"] == 1 and rec["live_rows"] == \
        SHAPES[shape].seq_len
    want = dryrun.cell_bytes(get_config(arch), SHAPES[shape],
                             dryrun.abstract_mesh(mesh))
    for k, v in want.items():
        assert rec[k] == v
    assert rec["dot_flops_per_data_rank"] > 0
    assert rec["result_bytes_per_data_rank"] > 0
    assert rec["activation_peak_bytes"] > 0 and rec["fits_h100_80gb"]
    if tp:
        # one device of the sharded step: its shards of the arguments, a
        # sixteenth of the model axis' work at most, the cache rows gathered
        assert rec["device_argument_bytes"] == rec["argument_size_in_bytes"]
        assert 0 < rec["dot_flops_per_device"] \
            < rec["dot_flops_per_data_rank"] / 8
        assert 0 < rec["result_bytes_per_device"]
        assert rec["collectives"]["all-gather"] > 0
    else:
        assert "dot_flops_per_device" not in rec
        assert rec["collective_count"] == 0    # one data rank, no grads
    p = subprocess.run(cmd + ["--skip-done"], capture_output=True, text=True,
                       timeout=CELL_TIMEOUT, env=_env(), cwd=ROOT)
    assert p.returncode == 0 and "done: 0 ok, 0 failed" in p.stdout
    assert len(out.read_text().splitlines()) == 1


def test_run_cell_records_a_failure():
    """A cell that fails is recorded with ok false and its error, and
    leaves no process group behind."""
    rec = dryrun.run_cell("granite-3-2b", "no_such_shape", "pod1")
    assert rec["ok"] is False and "KeyError" in rec["error"]
    assert not dist.is_initialized()


# --------------------------------------------------------- the profiler
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_profile_cell_on_the_cpu_matches_the_meta_count(shape, capsys):
    """``profile_cell --device cpu`` runs granite's smoke cell; its
    dispatched matmul FLOPs equal those of the same cell on meta tensors
    (the card's hard check against the dry run, rehearsed)."""
    res = profile_cell.main(["--device", "cpu", "--arch", "granite-3-2b",
                             "--shape", shape, "--top", "3"])
    out = capsys.readouterr().out
    assert "reduced" in out and "top dots" in out
    assert res["finite"] and res["dot_flops"] > 0
    assert res["launches"] == {"flash_attention": 0, "decode_attention": 0}
    cfg, sh, B, reduced = profile_cell.cell_config(
        "granite-3-2b", shape, device="cpu")
    assert B == res["batch"] and reduced == res["reduced"]
    cell = dryrun.cell_step(cfg, sh, B, device="meta",
                            microbatches=res["microbatches"])
    a = op_analysis.analyze(cell.run, params=cell.model,
                            live_rows=cell.live_rows)
    assert a["dot_flops"] == res["dot_flops"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_profile_cell_on_the_card_matches_the_meta_count(shape):
    """Two layers of each granite cell on the card: the count equals the
    meta run's (a train step's recompute calls K1 again inside the CUDA
    backward's threads, where the counter must still see it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    res = profile_cell.profile_cell("granite-3-2b", shape, layers=2,
                                    device="cuda", top=3)
    cfg, sh, B, _ = profile_cell.cell_config("granite-3-2b", shape, layers=2)
    cell = dryrun.cell_step(cfg, sh, B, device="meta",
                            microbatches=res["microbatches"])
    a = op_analysis.analyze(cell.run, params=cell.model,
                            live_rows=cell.live_rows)
    assert a["dot_flops"] == res["dot_flops"]
    want = {"train_4k": (4 * res["microbatches"], 0), "prefill_32k": (2, 0),
            "decode_32k": (0, 2)}[shape]
    assert (res["launches"]["flash_attention"],
            res["launches"]["decode_attention"]) == want
