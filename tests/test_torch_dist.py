"""The port's ``dist/`` layer and ``launch/mesh.py`` / ``launch/specs.py``
against the reference's.

* Spec rules: ``param_specs``, ``batch_specs`` and ``decode_state_specs`` on
  every arch's published config, on the port's ``AbstractMesh`` against the
  reference's ``jax.sharding.AbstractMesh`` of the same axes — (16, 16),
  (2, 16, 16), (1, 1), (2, 2), (4, 1) — equal entry for entry;
  ``launch/specs.py``'s meta trees equal the reference's ``ShapeDtypeStruct``
  trees in paths, shapes and dtypes for every arch and shape.
* ``hints.resolve`` equals the spec the reference's ``hint`` constrains to
  (captured by replacing ``jax.lax.with_sharding_constraint``) for the role
  tuples of every model call site, on many shapes, with and without
  ``seq_parallel``; both raise ``AssertionError`` on a rank mismatch.
* ``quantize_int8`` is bit-identical (q and the bits of scale), zeros and
  constants included; single-rank ``compressed_psum`` / ``wrap_grads`` give
  the reference's means bit for bit under a compiled 1-device
  ``shard_map(check_vma=False)``, and its residuals up to the one rounding
  XLA's CPU loop fuses in some lanes and not in others (``_check_residual``).
* Multi-rank runs start their ranks as subprocesses of this file on gloo
  with a ``FileStore`` under ``tmp_path``, each run with its own timeout:
  2 and 4 ranks hold the properties of ``tests/test_compression.py`` (the
  EF invariant, the 80-step mean unbiased, EF-SGD converging) and every
  rank's mean is the same bits; on 2x2 and 2x2x2 meshes every rank's block
  under ``placements`` is the block JAX's ``NamedSharding`` gives the device
  at that coordinate (computed in a subprocess with 8 forced host devices),
  the ``("model", "data")`` orders included.
* ``make_production_mesh`` builds the 16x16 and 2x16x16 meshes on a
  ``fake`` group and refuses a group below 256 ranks.
"""

import functools
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
RANK_TIMEOUT = 180            # seconds for one multi-rank run, ranks included


# --------------------------------------------------------- multi-rank runs
def run_ranks(tmp_path: Path, mode: str, world: int, *args: str,
              env_extra: dict | None = None, timeout: float = RANK_TIMEOUT,
              script: Path | None = None) -> list[Path]:
    """Run ``script`` (this file) as ``world`` gloo ranks in ``mode``; each
    rank writes ``<tmp_path>/<mode>.<rank>.npz``. Every rank is killed at
    the deadline and the test fails; a rank's non-zero exit fails it too."""
    script = script or Path(__file__)
    store = tmp_path / f"{mode}.store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **(env_extra or {}))
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"{mode}.{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), mode, str(r), str(world), str(store),
             str(tmp_path), *args], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{mode} x{world}: ranks still running after {timeout}s")
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"{mode}.{r}.log").read_text()
    return [tmp_path / f"{mode}.{r}.npz" for r in range(world)]


def _init_gloo(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


# ------------------------------------------------------ placements: blocks
BLOCK_CASES = {
    # mesh shape, axis names, tensor shape, specs (tuples = several axes)
    "2x2": ((2, 2), ("data", "model"), (8, 4), [
        [["model", "data"], None], [["data", "model"], None],
        ["data", "model"], ["model", "data"], [None, ["model", "data"]],
        ["model", None], [None, "data"], [None, None]]),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), (16, 4), [
        [["model", "pod", "data"], None], [["pod", "data"], "model"],
        [["model", "data"], None], [["data", "pod"], None],
        [["model", "data", "pod"], None], ["pod", ["model", "data"]]]),
}


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _jax_blocks(out: Path) -> None:
    """Each device's slice of the BLOCK_CASES tensors under JAX's
    NamedSharding, devices in mesh (row-major) order: needs 8 host
    devices (XLA_FLAGS set by the caller)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    res = {}
    for name, (mshape, axes, tshape, specs) in BLOCK_CASES.items():
        n = int(np.prod(mshape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(mshape), axes)
        res[name] = []
        for entries in specs:
            idx = NamedSharding(mesh, PartitionSpec(*_spec(entries))
                                ).devices_indices_map(tshape)
            res[name].append([[[s.start or 0, s.stop if s.stop is not None
                                else tshape[i]] for i, s in enumerate(idx[d])]
                              for d in mesh.devices.flat])
    out.write_text(json.dumps(res))


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxblocks")
    out = subprocess.run(
        [sys.executable, __file__, "jaxblocks", "0", "1", "-", str(d)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=RANK_TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads((d / "blocks.json").read_text())


def _worker_blocks(rank, world, store, out_dir, case):
    """This rank's block of each BLOCK_CASES spec three ways: DTensor's own
    ``distribute_tensor`` on ``placements``, ``distribute`` and
    ``local_block``; and ``full_tensor`` of ``distribute``'s DTensor."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding as shd
    _init_gloo(rank, world, store)
    try:
        mshape, axes, tshape, specs = BLOCK_CASES[case]
        mesh = init_device_mesh("cpu", mshape, mesh_dim_names=axes)
        x = torch.arange(int(np.prod(tshape)), dtype=torch.float32
                         ).reshape(tshape)
        res = {}
        for i, entries in enumerate(specs):
            spec = shd.P(*_spec(entries))
            res[f"dtensor{i}"] = distribute_tensor(
                x, mesh, shd.placements(mesh, spec)).to_local().numpy()
            placed = shd.distribute({"x": x}, mesh, {"x": spec})["x"]
            res[f"distribute{i}"] = placed.to_local().numpy()
            res[f"full{i}"] = placed.full_tensor().numpy()
            res[f"block{i}"] = shd.local_block(x, mesh, spec).numpy()
        np.savez(Path(out_dir) / f"blocks.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ compression ranks
EF_STEPS, SGD_STEPS = 80, 200


def _worker_compress(rank, world, store, out_dir):
    """The properties of tests/test_compression.py over ``world`` ranks,
    each rank with its own gradients."""
    import torch.distributed as dist

    from repro_torch.dist import compression as comp
    _init_gloo(rank, world, store)
    try:
        group = dist.group.WORLD
        rng = np.random.default_rng(100 + rank)
        res = {}
        x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        mean, err = comp.compressed_psum(x, group, torch.zeros_like(x))
        res.update(x=x.numpy(), mean=mean.numpy(), err=err.numpy())
        # 80 steps of the same gradient: the accumulated means -> true mean
        g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
        e, acc = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(EF_STEPS):
            m, e = comp.compressed_psum(g, group, e)
            acc += m
        res.update(g=g.numpy(), acc=acc.numpy())
        # EF-SGD on sum_r ||w - w*_r||^2 / world: w -> mean_r w*_r
        w_star = torch.from_numpy(np.random.default_rng(3 + rank).normal(
            size=(32,)).astype(np.float32))
        w, e = torch.zeros(32), torch.zeros(32)
        for _ in range(SGD_STEPS):
            gc, e = comp.compressed_psum(2 * (w - w_star), group, e)
            w = w - 0.05 * gc
        res.update(w=w.numpy(), w_star=w_star.numpy())
        # a pytree and degenerate leaves
        tree = {"a": torch.ones(8), "b": {"c": torch.full((4,), -2.0)},
                "z": torch.zeros(5), "l": [torch.full((3,), -3.5)]}
        means, errs = comp.wrap_grads(tree, group, None)
        res.update(tree_a=means["a"].numpy(), tree_c=means["b"]["c"].numpy(),
                   tree_z=means["z"].numpy(), tree_l=means["l"][0].numpy(),
                   err_z=errs["z"].numpy())
        assert set(errs) == set(tree) and isinstance(errs["l"], list)
        np.savez(Path(out_dir) / f"compress.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# ==================================================================== tests
if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as JP

    from repro.configs import ARCH_NAMES as JAX_ARCHS
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_config
    from repro.dist import compression as jcomp
    from repro.dist import hints as jhints
    from repro.dist import sharding as jshd
    from repro.launch import specs as jspecs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist import compression as comp
    from repro_torch.dist import hints
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs as tspecs

    MESHES = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
              ((4, 1), ("data", "model")), ((1, 4), ("data", "model"))]


def _jflat(tree, leaf=None) -> dict:
    """A reference tree as {path: leaf}; dict keys and sequence indices
    joined by "/"."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)
    out = {}
    for path, v in flat:
        out["/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                     for k in path)] = v
    return out


def _tflat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _jspecs(tree) -> dict:
    return {k: tuple(v) for k, v in
            _jflat(tree, leaf=lambda x: isinstance(x, JP)).items()}


def _tspecs(tree) -> dict:
    return {k: tuple(v) for k, v in _tflat(tree).items()}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jspecs.params_specs_for(jax_config(arch))


# --------------------------------------------------------------- spec rules
@pytest.mark.parametrize("arch", JAX_ARCHS if __name__ != "__main__" else [])
def test_param_specs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    j_shapes, t_shapes = _jax_params(arch), tspecs.params_specs_for(cfg)
    for shape, names in MESHES:
        want = _jspecs(jshd.param_specs(jcfg, j_shapes,
                                        JaxAbstractMesh(shape, names)))
        got = _tspecs(shd.param_specs(cfg, t_shapes,
                                      shd.AbstractMesh(shape, names)))
        assert got == want, (arch, shape)
    # by the port's parameter names (what shard_model places): the
    # reference's stacked leaf's spec, stacked dims dropped, on every mesh
    from repro_torch._bridge import reference_key
    for shape, names in MESHES:
        want = _jspecs(jshd.param_specs(jcfg, j_shapes,
                                        JaxAbstractMesh(shape, names)))
        named = shd.named_param_specs(cfg, shd.AbstractMesh(shape, names))
        assert {reference_key(n)[0] for n in named} == set(want), arch
        for name, spec in named.items():
            key, idx = reference_key(name)
            assert want[key] == (None,) * len(idx) + tuple(spec), \
                (name, shape)


@pytest.mark.parametrize("arch", JAX_ARCHS if __name__ != "__main__" else [])
def test_batch_and_decode_state_specs_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for sname, shape in SHAPES.items():
        jb = jspecs.batch_specs_for(jcfg, JAX_SHAPES[sname])
        tb = tspecs.batch_specs_for(cfg, shape)
        js, _ = jspecs.decode_specs_for(jcfg, JAX_SHAPES[sname])
        ts, _ = tspecs.decode_specs_for(cfg, shape)
        for mshape, names in MESHES:
            jm, tm = JaxAbstractMesh(mshape, names), shd.AbstractMesh(mshape,
                                                                      names)
            assert _tspecs(shd.batch_specs(cfg, tb, tm)) == \
                _jspecs(jshd.batch_specs(jcfg, jb, jm)), (arch, sname, mshape)
            assert _tspecs(shd.decode_state_specs(cfg, ts, tm)) == \
                _jspecs(jshd.decode_state_specs(jcfg, js, jm)), \
                (arch, sname, mshape)


@pytest.mark.parametrize("arch", JAX_ARCHS if __name__ != "__main__" else [])
def test_launch_specs_trees_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for sname, shape in SHAPES.items():
        want = _jflat(jspecs.input_specs(jcfg, JAX_SHAPES[sname]))
        got = _tflat(tspecs.input_specs(cfg, shape))
        assert set(got) == set(want), (arch, sname,
                                       sorted(set(got) ^ set(want))[:8])
        for k, t in got.items():
            assert t.device.type == "meta", k
            assert tuple(t.shape) == tuple(want[k].shape), (arch, sname, k)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (arch, sname, k)


def test_check_and_fit_match_the_references_edges():
    for shape, names in MESHES:
        jm, tm = JaxAbstractMesh(shape, names), shd.AbstractMesh(shape, names)
        for dims in [(10, 48), (3, 7), (2, 64), (32, 32), (32, 32, 32),
                     (64, 64), (512, 16, 8)]:
            for spec in [("data", "model"), (("pod", "data"), None),
                         ("model", "model"), ("data",), ("model", "data"),
                         (("model", "data"), "pod"), ("nope", "data")]:
                assert tuple(shd._check(tm, dims, spec)) == \
                    tuple(jshd._check(jm, dims, spec)), (shape, dims, spec)
    assert shd.axis_size(shd.AbstractMesh((2, 16, 16), ("pod", "data",
                                                         "model")),
                         ("pod", "data")) == 32


# -------------------------------------------------------------------- hints
# the role tuples of every hint site of the models (both packages)
SITE_ROLES = [
    ("dp", None, None), ("dp", None, "tp"), ("dp", "sp_seq", None),
    ("dp", "sq", "tp", None), ("dp", "sp", "tp", None),
    ("dp", "tp", "sq", None), ("dp", "tp", None, None),
    ("dp", None, None, None), ("dp", "seq", None, None),
    ("dp", None, None, "seq"), ("dp", "tp"), ("tp", "dp", None),
    ("dp", None), ("dp", "tp", None), ("dp", None, "tp"),
    ("dp", "tp", "seq"),
]
DIMS = (1, 3, 16, 32, 56, 512)


def _jax_hint_spec(mesh, shape, roles, seq_parallel):
    got = []
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = \
        lambda x, s: (got.append(tuple(s.spec)), x)[1]
    try:
        with jhints.sharding_rules(mesh, seq_parallel=seq_parallel):
            jhints.hint(jax.ShapeDtypeStruct(shape, jnp.float32), *roles)
    finally:
        jax.lax.with_sharding_constraint = orig
    return got[0] if got else None


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_resolve_equals_the_references_hint(seq_parallel):
    import itertools
    n = 0
    for mshape, names in MESHES:
        jm, tm = JaxAbstractMesh(mshape, names), shd.AbstractMesh(mshape,
                                                                  names)
        for roles in SITE_ROLES:
            for shape in itertools.product(DIMS, repeat=len(roles)):
                want = _jax_hint_spec(jm, shape, roles, seq_parallel)
                with hints.sharding_rules(tm, seq_parallel=seq_parallel):
                    got = hints.resolve(shape, *roles)
                assert (None if got is None else tuple(got)) == want, \
                    (mshape, roles, shape)
                n += 1
    assert n > 10_000


def test_hint_rank_check_and_identity():
    x = torch.ones(4, 8)
    assert hints.hint(x, "dp") is x             # no rules: not even a look
    assert hints.resolve((4, 8), "dp") is None
    for m_j, m_t in [(JaxAbstractMesh((16, 16), ("data", "model")),
                      shd.AbstractMesh((16, 16), ("data", "model")))]:
        with jhints.sharding_rules(m_j):
            with pytest.raises(AssertionError):
                jhints.hint(jnp.ones((4, 8)), "dp")
        with hints.sharding_rules(m_t):
            with pytest.raises(AssertionError):
                hints.hint(x, "dp")
            with pytest.raises(AssertionError):
                hints.resolve((4, 8), "dp", "tp", None)
            assert hints.hint(x, "dp", "tp") is x    # a plain tensor passes
            assert not hints.tp_divides(56) and hints.tp_divides(64)
    assert hints.get_rules() is None and hints.tp_divides(56)
    m = shd.AbstractMesh((1, 1), ("data", "model"))
    with hints.sharding_rules(m) as outer:
        with hints.sharding_rules(m, seq_parallel=True) as inner:
            assert hints.get_rules() is inner and inner["seq_parallel"]
        assert hints.get_rules() is outer
    assert hints.get_rules() is None


def test_tp_divides_sets_the_plain_attentions_query_chunk(monkeypatch):
    """Under rules whose model axis does not divide the heads, the plain
    attention runs one seq-sharded piece instead of its chunk loop (the
    reference's ``q_chunk = max(q_chunk, Sq)``); the result is the same."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 8, 16, generator=g)
    k = torch.randn(1, 64, 2, 16, generator=g)
    pos = torch.arange(64)[None]
    chunks = []
    orig = layers._mask_bias
    monkeypatch.setattr(layers, "_mask_bias",
                        lambda *a, **kw: chunks.append(1) or orig(*a, **kw))

    def run():
        chunks.clear()
        out = layers.attention(q, k, k, q_pos=pos, k_pos=pos, q_chunk=16)
        return out, len(chunks)

    base, n0 = run()
    with hints.sharding_rules(shd.AbstractMesh((1, 16), ("data", "model"))):
        one, n1 = run()                        # 8 heads on 16: no TP
    with hints.sharding_rules(shd.AbstractMesh((1, 4), ("data", "model"))):
        four, n4 = run()                       # 8 heads on 4: chunks stay
    assert (n0, n1, n4) == (4, 1, 4)
    torch.testing.assert_close(one, base, rtol=1e-6, atol=1e-6)
    assert torch.equal(four, base)


def test_hint_redistributes_a_dtensor_on_a_one_rank_mesh(gloo_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.arange(32.).reshape(4, 8), gloo_mesh,
                          [Replicate(), Replicate()])
    with hints.sharding_rules(gloo_mesh):
        y = hints.hint(x, "dp", "tp")
    assert y.placements == (Shard(0), Shard(1))
    assert torch.equal(y.full_tensor(), x.full_tensor())


# -------------------------------------------------------------- compression
def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


QUANT_CASES = {
    "normal": lambda r: r.normal(size=(256,)),
    "wide": lambda r: r.normal(size=(64, 33)) * np.logspace(-20, 20, 33),
    "tiny": lambda r: r.normal(size=(100,)) * 1e-20,
    "halves": lambda r: np.arange(-254, 255) / 2.0,    # scale 1: ties
    "zeros": lambda r: np.zeros((8,)),
    "constant": lambda r: np.full((16,), -3.5),
    "one": lambda r: np.array([7.25]),
    "scalar": lambda r: np.array(2.5),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_bit_identical(case, dtype):
    from repro_torch._bridge import to_torch
    x = np.asarray(QUANT_CASES[case](np.random.default_rng(0)), np.float32)
    jx = jnp.asarray(x).astype(dtype)
    q_j, s_j = jcomp.quantize_int8(jx)
    q_t, s_t = comp.quantize_int8(to_torch(np.asarray(jx), "cpu"))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(_bits(s_t.numpy()), _bits(s_j))
    np.testing.assert_array_equal(
        _bits(comp.dequantize_int8(q_t, s_t).numpy()),
        _bits(jcomp.dequantize_int8(q_j, s_j)))
    if case == "zeros":
        assert float(s_t) == 0.0 and not q_t.any()


def test_a_subnormal_scale_is_kept_where_xla_flushes_it():
    """The one known difference: XLA on the CPU flushes subnormal floats to
    zero, so a tensor whose largest magnitude / 127 is subnormal gets scale 0
    and q 0 there (the error feedback carries the whole value); torch keeps
    the subnormal scale and quantizes. Both keep value + err == x. (So the
    bit-identity cases stay above 1e-37: XLA flushes a subnormal residual
    too.)"""
    x = np.random.default_rng(0).normal(size=(100,)).astype(np.float32) * 1e-38
    q_j, s_j = jcomp.quantize_int8(jnp.asarray(x))
    q_t, s_t = comp.quantize_int8(torch.from_numpy(x))
    assert float(s_j) == 0.0 and not np.asarray(q_j).any()
    assert 0.0 < float(s_t) < np.finfo(np.float32).tiny and q_t.any()
    deq = comp.dequantize_int8(q_t, s_t).numpy()
    assert np.abs(deq - x).max() <= float(s_t) / 2


def test_compression_ratio_equals_the_references():
    for shapes in [[(1024, 1024)], [(3,), (5, 7)], [(2, 3, 4)]]:
        j = {str(i): jnp.zeros(s) for i, s in enumerate(shapes)}
        t = {str(i): torch.zeros(s) for i, s in enumerate(shapes)}
        assert comp.compression_ratio(t) == jcomp.compression_ratio(j)
    tb = {"w": torch.zeros((64, 64), dtype=torch.bfloat16)}
    assert comp.compression_ratio(tb) == jcomp.compression_ratio(
        {"w": jnp.zeros((64, 64), jnp.bfloat16)})


@pytest.fixture
def gloo_mesh():
    """A 1x1 ("data", "model") mesh over a one-rank gloo group on an
    in-process store; the group is destroyed afterwards."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = tmesh.make_local_mesh(1, 1, device_type="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _jax_psum():
    mesh = JaxMesh(np.array(jax.devices()[:1]), ("d",))
    return jax.jit(jax.shard_map(
        lambda a, e: jcomp.compressed_psum(a, "d", e), mesh=mesh,
        in_specs=JP(), out_specs=JP(), check_vma=False))


def _check_residual(et, ej, x, err):
    """The port's residual is ``x + err - q * scale`` rounded once (what a
    fused multiply-subtract gives); the reference's compiled residual is
    that in the lanes XLA's CPU loop fuses and the product rounded first in
    the others (a loop's scalar remainder), so each of its elements is one
    of the two roundings."""
    c = torch.from_numpy(np.asarray(x + err, np.float32))
    q, s = comp._quantize(c, c.abs().max() * comp._INV_127)
    fused = (c.double() - q.double() * s.double()).float().numpy()
    unfused = (c - q.float() * s).numpy()
    np.testing.assert_array_equal(_bits(et), _bits(fused))
    ej = _bits(ej)
    assert np.all((ej == _bits(fused)) | (ej == _bits(unfused)))


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_single_rank_compressed_psum_is_bit_identical(case, gloo_mesh):
    rng = np.random.default_rng(1)
    x = np.asarray(QUANT_CASES[case](rng), np.float32)
    err0 = np.asarray(rng.normal(size=x.shape) * 1e-3, np.float32)
    psum = _jax_psum()
    with hints.sharding_rules(gloo_mesh):
        for err in (np.zeros_like(x), err0):
            mj, ej = psum(jnp.asarray(x), jnp.asarray(err))
            mt, et = comp.compressed_psum(torch.from_numpy(x), "data",
                                          torch.from_numpy(err))
            np.testing.assert_array_equal(_bits(mt.numpy()), _bits(mj))
            _check_residual(et.numpy(), ej, x, err)
            np.testing.assert_allclose(mt.numpy() + et.numpy(), x + err,
                                       rtol=1e-6, atol=1e-6)
    # the EF state carries over steps as the reference's does
    xt, e_t, e_j = torch.from_numpy(x), None, jnp.zeros(x.shape, jnp.float32)
    for _ in range(5):
        with hints.sharding_rules(gloo_mesh):
            mt, e_t = comp.compressed_psum(xt, "model", e_t)
        mj, e_j = psum(jnp.asarray(x), e_j)
        np.testing.assert_array_equal(_bits(mt.numpy()), _bits(mj))


def test_single_rank_wrap_grads_is_bit_identical(gloo_mesh):
    """Means bit for bit, residuals per ``_check_residual``."""
    rng = np.random.default_rng(2)
    leaves = {"a": rng.normal(size=(8,)), "b/c": rng.normal(size=(4, 3)),
              "z": np.zeros((5,))}
    jt = {"a": jnp.asarray(leaves["a"], jnp.float32),
          "b": {"c": jnp.asarray(leaves["b/c"], jnp.float32)},
          "z": jnp.zeros((5,), jnp.float32)}
    tt = {"a": torch.tensor(leaves["a"], dtype=torch.float32),
          "b": {"c": torch.tensor(leaves["b/c"], dtype=torch.float32)},
          "z": torch.zeros(5)}
    mesh = JaxMesh(np.array(jax.devices()[:1]), ("d",))
    # compiled, as the reference's collective runs in training (an eager
    # shard_map evaluates op by op: its scale is a true division by 127 and
    # its residual a rounded product, each a last bit off the compiled one)
    jm, je = jax.jit(jax.shard_map(lambda g: jcomp.wrap_grads(g, "d", None),
                                   mesh=mesh, in_specs=JP(), out_specs=JP(),
                                   check_vma=False))(jt)
    tm, te = comp.wrap_grads(tt, gloo_mesh.get_group("data"), None)
    for k, v in _jflat(jm).items():
        np.testing.assert_array_equal(_bits(_tflat(tm)[k].numpy()), _bits(v))
    for k, v in _jflat(je).items():
        _check_residual(_tflat(te)[k].numpy(), v, np.asarray(_jflat(jt)[k]),
                        np.zeros(v.shape, np.float32))
    with pytest.raises(RuntimeError, match="sharding_rules"):
        comp.compressed_psum(tt["a"], "data", None)


@pytest.mark.gpu
def test_compressed_psum_over_nccl_equals_the_cpus():
    """On a one-rank NCCL group on the card: the same bits as on the CPU
    (division, round-half-even and the f64 residual are exact IEEE ops)."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
    err = torch.from_numpy((rng.normal(size=(4096,)) * 1e-3).astype(
        np.float32))
    mesh = tmesh.make_local_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        with hints.sharding_rules(mesh):
            m_c, e_c = comp.compressed_psum(x.cuda(), "data", err.cuda())
    finally:
        dist.destroy_process_group()
    cpu = tmesh.make_local_mesh(1, 1, device_type="cpu")
    try:
        with hints.sharding_rules(cpu):
            m, e = comp.compressed_psum(x, "data", err)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(_bits(m_c.cpu().numpy()), _bits(m.numpy()))
    np.testing.assert_array_equal(_bits(e_c.cpu().numpy()), _bits(e.numpy()))


@pytest.mark.parametrize("world", [2, 4])
def test_multi_rank_compression_properties(world, tmp_path):
    outs = [dict(np.load(p)) for p in run_ranks(tmp_path, "compress", world)]
    xs = np.stack([o["x"] for o in outs])
    errs = np.stack([o["err"] for o in outs])
    for o in outs[1:]:                    # every rank's mean: the same bits
        for k in ("mean", "acc", "w", "tree_a", "tree_c", "tree_z",
                  "tree_l"):
            np.testing.assert_array_equal(_bits(o[k]), _bits(outs[0][k]))
    # EF invariant over the ranks: mean + mean_r err_r == mean_r x_r
    np.testing.assert_allclose(outs[0]["mean"] + errs.mean(0), xs.mean(0),
                               rtol=1e-6, atol=1e-6)
    # the accumulated means are unbiased
    g_mean = np.stack([o["g"] for o in outs]).mean(0)
    np.testing.assert_allclose(outs[0]["acc"] / EF_STEPS, g_mean,
                               rtol=5e-3, atol=5e-3)
    # EF-SGD converges to the minimiser of the ranks' mean loss
    w_opt = np.stack([o["w_star"] for o in outs]).mean(0)
    assert np.linalg.norm(outs[0]["w"] - w_opt) < 1e-2
    np.testing.assert_allclose(outs[0]["tree_a"], 1.0, rtol=1e-2)
    np.testing.assert_allclose(outs[0]["tree_c"], -2.0, rtol=1e-2)
    np.testing.assert_array_equal(outs[0]["tree_z"], 0.0)
    np.testing.assert_array_equal(outs[0]["tree_l"], -3.5)
    for o in outs:
        np.testing.assert_array_equal(o["err_z"], 0.0)


# ---------------------------------------------------------------- placements
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_placements_give_each_rank_jaxs_block(case, jax_blocks, tmp_path):
    mshape, axes, tshape, specs = BLOCK_CASES[case]
    world = int(np.prod(mshape))
    outs = [dict(np.load(p)) for p in run_ranks(tmp_path, "blocks", world,
                                                case)]
    x = np.arange(int(np.prod(tshape)), dtype=np.float32).reshape(tshape)
    for i in range(len(specs)):
        for r, o in enumerate(outs):
            sl = tuple(slice(a, b) for a, b in jax_blocks[case][i][r])
            for how in ("dtensor", "distribute", "block"):
                np.testing.assert_array_equal(o[f"{how}{i}"], x[sl],
                                              err_msg=f"{specs[i]} rank {r} "
                                                      f"{how}")
            np.testing.assert_array_equal(o[f"full{i}"], x)


def test_placements_spell_the_strided_order():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    m = shd.AbstractMesh((2, 4), ("data", "model"))
    assert shd.placements(m, shd.P(("model", "data"), None)) == \
        [_StridedShard(0, split_factor=4), Shard(0)]
    assert shd.placements(m, shd.P(("data", "model"), None)) == \
        [Shard(0), Shard(0)]
    assert shd.placements(m, shd.P(None, "model")) == [Replicate(), Shard(1)]


# ------------------------------------------------------------------- meshes
def test_production_meshes_on_a_fake_group():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    tmesh.init_fake_group(512)
    try:
        m1 = tmesh.make_production_mesh()
        m2 = tmesh.make_production_mesh(multi_pod=True)
        assert (tuple(m1.shape), m1.mesh_dim_names) == ((16, 16),
                                                        ("data", "model"))
        assert (tuple(m2.shape), m2.mesh_dim_names) == (
            (2, 16, 16), ("pod", "data", "model"))
        assert shd.dp_axes(m2) == ("pod", "data") and shd.tp_axis(m1) == \
            "model"
        with hints.sharding_rules(m2) as r:
            assert (r["dp_size"], r["tp_size"]) == (32, 16)
        cfg = get_config("deepseek-v3-671b")
        specs = shd.named_param_specs(cfg, m1)
        assert specs["moe_blocks.0.moe.w1"] == ("model", None, "data")
    finally:
        dist.destroy_process_group()
    tmesh.init_fake_group(128)
    try:
        with pytest.raises(RuntimeError, match="needs 256 ranks, found 128"):
            tmesh.make_production_mesh()
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="needs 1 ranks"):
            tmesh.make_local_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_local_mesh_starts_a_one_rank_group_and_refuses_more():
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="none is initialised"):
        tmesh.make_local_mesh(2, 1, device_type="cpu")
    mesh = tmesh.make_local_mesh(1, 1, device_type="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == ((1, 1),
                                                            ("data", "model"))
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_local_mesh()
        assert not dist.is_initialized()


# ------------------------------------------------------------ rank entry
if __name__ == "__main__":
    mode, rank, world, store, out_dir = sys.argv[1:6]
    if mode == "jaxblocks":
        _jax_blocks(Path(out_dir) / "blocks.json")
    elif mode == "blocks":
        _worker_blocks(int(rank), int(world), store, out_dir, sys.argv[6])
    elif mode == "compress":
        _worker_compress(int(rank), int(world), store, out_dir)
    else:
        raise SystemExit(f"unknown mode {mode}")
