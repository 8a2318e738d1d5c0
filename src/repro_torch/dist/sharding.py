"""Divisibility-aware sharding rules for the production meshes (the port of
``repro.dist.sharding``), and their torch half: DTensor placements.

Axis semantics (``launch/mesh.py``): ``pod`` = cross-pod DP, ``data`` =
in-pod DP + FSDP, ``model`` = TP/EP. Every rule goes through :func:`_check`,
which drops any mesh axis that does not divide its dim, so assignments
degrade to replication instead of failing. The rules are the reference's,
copied unchanged; they read leaf paths in the reference's stacked layout
(``moe_blocks/moe/w1`` is ``(L, E, d, ff)``).

A spec is a :class:`P`: one entry per dim, each ``None``, a mesh axis name
or a tuple of names (major to minor). Every function takes either a
``torch.distributed.device_mesh.DeviceMesh`` or an :class:`AbstractMesh`
(axis sizes without a process group), so the 16x16 and 2x16x16 rules run on
one CPU.

:func:`placements` maps a spec onto a DeviceMesh's DTensor placements, and
:func:`distribute` places whole tensors as DTensors, each rank keeping the
block that JAX's ``NamedSharding`` gives the device at its coordinate: a
dim sharded over ``("model", "data")`` on a ``("data", "model")`` mesh is cut
model-major, which DTensor spells ``_StridedShard`` on ``data``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.configs.base import ModelConfig

Pytree = Any

_DP_NAMES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per dim (``None``, an axis, or a tuple
    of axes major to minor); the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis sizes and names without devices or a process group."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]) -> None:
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


# ----------------------------------------------------------------- mesh intro
def mesh_axes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, ax) -> int:
    """Size of one mesh axis or the product over a tuple of axes."""
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= axis_size(mesh, a)
        return n
    return mesh_axes(mesh)[ax]


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes in major-to-minor order (pod before data)."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in _DP_NAMES if a in names)


def tp_axis(mesh) -> str | None:
    return "model" if "model" in tuple(mesh.mesh_dim_names) else None


# -------------------------------------------------------------- divisibility
def _fit(mesh, dim: int, candidates, used: set) -> str | tuple | None:
    """Greedily assign unused mesh axes to ``dim`` while the product divides.

    Returns a single axis name, a tuple of names, or None (replicate)."""
    if candidates is None:
        return None
    if not isinstance(candidates, (tuple, list)):
        candidates = (candidates,)
    sizes = mesh_axes(mesh)
    kept: list[str] = []
    prod = 1
    for a in candidates:
        if a is None or a in used or a not in sizes:
            continue                 # unknown axis: degrade, don't KeyError
        size = sizes[a]
        if size > 0 and dim % (prod * size) == 0:
            kept.append(a)
            prod *= size
            used.add(a)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def _check(mesh, shape: Sequence[int], spec) -> P:
    """Validate a proposed spec against ``shape``: indivisible axes are
    dropped (replicated), and no mesh axis is used twice."""
    entries = tuple(spec)
    entries = entries + (None,) * (len(shape) - len(entries))
    used: set = set()
    return P(*[_fit(mesh, dim, ax, used) for dim, ax in zip(shape, entries)])


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ------------------------------------------------------------ tree plumbing
def _map_with_names(fn, tree: Pytree, names: tuple = ()) -> Pytree:
    """``fn(dict-key names, leaf)`` over nested dicts, lists and tuples; the
    names are the dict keys on the leaf's path (``jax.tree_util.DictKey``s,
    sequence indices left out), as the reference's rules read them."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(list(names), tree)


def _zip_map(fn, tree: Pytree, other: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_zip_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)


# ------------------------------------------------------------- param specs
# (in, out) matrices: shard the contraction dim on "data" (FSDP) and the
# output dim on "model" (TP). Row-parallel outputs (wo, w2) are the reverse.
_COL = ("data", "model")
_ROW = ("model", "data")

# Expert-stacked weights (E, d, ff) / (E, ff, d): experts on "model" (EP),
# FSDP on ff — d is the first product's contraction dim and stays whole.
_EXPERT_RULES = {
    "w1": ("model", None, "data"),
    "w3": ("model", None, "data"),
    "w2": ("model", "data", None),
}

_MATRIX_RULES = {
    # embeddings: vocab on model (TP logits), d on data
    "tok": ("model", "data"),
    "head": ("data", "model"),
    # attention / projections
    "wq": _COL, "wk": _COL, "wv": _COL, "wg": _COL, "wr": _COL,
    "wo": _ROW,
    # MLA low-rank factors
    "wq_a": _COL, "wq_b": _COL, "wkv_a": _COL, "wkv_b": _COL,
    # MLPs
    "w1": _COL, "w3": _COL, "w2": _ROW,
    # mamba2
    "in_proj": _COL, "out_proj": _ROW, "conv_w": (None, "model"),
    # rwkv loras
    "tm_w1": _COL, "w_w1": _COL, "w_w2": _ROW, "tm_w2": (None, None, "data"),
    # deepseek MTP fuse projection
    "proj": _COL,
    # router stays replicated (tiny, f32, read by every token)
    "router": (None, None),
}


def _param_template(names: list[str], leaf) -> tuple:
    name = names[-1] if names else ""
    if name in _EXPERT_RULES and "moe" in names and "shared" not in names:
        return _EXPERT_RULES[name]
    if name == "wv" and "cm" in names:        # rwkv channel-mix output proj
        return _ROW
    if leaf.ndim >= 2 and name in _MATRIX_RULES:
        return _MATRIX_RULES[name]
    return ()                                  # vectors / norms: replicate


def param_specs(cfg: ModelConfig, shapes: Pytree, mesh) -> Pytree:
    """Spec tree matching a param (shape) tree in the reference's layout.

    Templates are right-aligned: leading stacked-layer/group dims replicate.
    Every assignment is divisibility-checked against ``mesh``."""

    def spec_for(names, leaf):
        tpl = _param_template(names, leaf)
        full = (None,) * (leaf.ndim - len(tpl)) + tuple(tpl)
        return _check(mesh, leaf.shape, full)

    return _map_with_names(spec_for, shapes)


def named_param_specs(cfg: ModelConfig, mesh) -> dict[str, P]:
    """:func:`param_specs` for the port's parameters, by
    ``named_parameters()`` name. The rules run on a meta-device tree in the
    reference's stacked layout (``_bridge.to_reference``), and each name
    takes its stacked leaf's spec without the stacked dims
    (``_bridge.reference_key``), which every rule leaves replicated."""
    from repro_torch import _bridge
    from repro_torch.models import model as M
    meta = M.init_params(cfg, device="meta")
    flat = _bridge._flat(param_specs(cfg, _bridge.to_reference(cfg, meta),
                                     mesh))
    out = {}
    for name, _ in meta.named_parameters():
        key, idx = _bridge.reference_key(name)
        spec = flat[key]
        if any(e is not None for e in spec[:len(idx)]):
            raise ValueError(f"{name}: a stacked dim of {key} is sharded "
                             f"({spec})")
        out[name] = P(*spec[len(idx):])
    return out


# ------------------------------------------------------------- batch specs
def batch_specs(cfg: ModelConfig, batch: Pytree, mesh) -> Pytree:
    """Inputs shard their leading (global-batch) dim over all DP axes; an
    indivisible batch (e.g. long_500k's batch=1) replicates."""

    def spec_for(names, leaf):
        tpl = (_dp_entry(mesh),) + (None,) * (leaf.ndim - 1)
        return _check(mesh, leaf.shape, tpl)

    return _map_with_names(spec_for, batch)


# ------------------------------------------------------- decode-state specs
def _cache_spec(mesh, shape, *, b_dim: int | None, s_dim: int | None,
                h_dim: int | None) -> P:
    """The decode-cache rule, in priority order:

      1. heads (or the channel dim standing in for them) take "model" if they
         divide it — heads-local attention, no cross-chip KV traffic;
      2. batch takes the DP axes;
      3. the sequence dim sweeps up whatever is left ("model" first — the
         kv<model GQA fallback — then unused DP axes when batch=1).
    """
    used: set = set()
    out: list = [None] * len(shape)
    tp = tp_axis(mesh)
    if h_dim is not None and tp is not None:
        out[h_dim] = _fit(mesh, shape[h_dim], (tp,), used)
    if b_dim is not None:
        out[b_dim] = _fit(mesh, shape[b_dim], dp_axes(mesh), used)
    if s_dim is not None:
        rest = ((tp,) if tp else ()) + dp_axes(mesh)
        out[s_dim] = _fit(mesh, shape[s_dim], rest, used)
    return P(*out)


def decode_state_specs(cfg: ModelConfig, state: Pytree, mesh) -> Pytree:
    """Specs for a decode-state tree (any family's ``init_decode_state``)."""

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        nd = leaf.ndim
        if name == "pos" or nd == 1:
            return _check(mesh, leaf.shape, (_dp_entry(mesh),))
        if name in ("k", "v", "attn_k", "attn_v", "xk", "xv"):
            # (L, B, S, Hkv, hd) — vlm stacks an extra group dim in front
            return _cache_spec(mesh, leaf.shape, b_dim=nd - 4, s_dim=nd - 3,
                               h_dim=nd - 2)
        if name in ("moe_cache", "dense_cache"):
            if nd == 4:            # MLA latent cache (L, B, S, c)
                return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=2,
                                   h_dim=None)
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=2, h_dim=3)
        if name == "wkv":          # rwkv state (L, B, H, K, K): heads split
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=None, h_dim=2)
        if name == "ssm":          # mamba2 state (n, B, H, P, N)
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=None, h_dim=2)
        if name == "conv":         # conv window (n, B, w, ch): ch on model
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=None, h_dim=3)
        if name in ("tm_x", "cm_x"):   # rwkv shift state (L, B, d)
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=None, h_dim=2)
        if nd >= 2:                # unknown state: shard batch-ish dim only
            return _cache_spec(mesh, leaf.shape, b_dim=1, s_dim=None,
                               h_dim=None)
        return P(*([None] * nd))

    return _map_with_names(spec_for, state)


# ------------------------------------------------------ DTensor placements
def placements(mesh, spec) -> list:
    """DTensor placements on ``mesh`` (a DeviceMesh) for ``spec``: one per
    mesh dim, ``Replicate`` where the spec does not name the axis. A dim
    sharded over several axes is cut major to minor in the spec's order;
    where a more-major axis of the spec comes later in the mesh, the axis
    takes ``_StridedShard`` with the product of those axes' sizes as its
    split factor (DTensor otherwise orders blocks by mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        for j, a in enumerate(axes):
            k = names.index(a)
            sf = 1
            for b in axes[:j]:
                if names.index(b) > k:
                    sf *= sizes[b]
            out[k] = Shard(dim) if sf == 1 else _StridedShard(dim,
                                                              split_factor=sf)
    return out


def local_block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    sharded dim is cut into the product of its axes' sizes and the block
    index is the rank's coordinates read major to minor in the spec's
    order, as JAX lays out a ``NamedSharding``."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_axes(mesh)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        if n == 1:
            continue                    # one block: the tensor itself
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def _contiguous_strides(shape) -> tuple[int, ...]:
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= s
    return tuple(reversed(out))


def distribute(tree: Pytree, mesh, specs: Pytree) -> Pytree:
    """Place a tree of whole tensors (the same on every rank) as DTensors on
    ``mesh`` by a matching spec tree: each rank keeps its own block (no
    communication) under :func:`placements`."""
    from torch.distributed.tensor import DTensor

    def place(t, spec):
        spec = P(*spec) + P(*([None] * (t.ndim - len(spec))))
        return DTensor.from_local(local_block(t, mesh, spec).contiguous(),
                                  mesh, placements(mesh, spec),
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous_strides(t.shape))

    return _zip_map(place, tree, specs)


# ------------------------------------------------------------ sharded step
# families whose step runs on DTensors; zamba2's and rwkv's scans have no
# hint sites and stay on each rank's plain tensors
SHARDED_FAMILIES = ("dense", "localglobal", "encdec", "vlm", "moe")


def mesh_of(t) -> Any:
    """A DTensor's DeviceMesh, else None."""
    from torch.distributed.tensor import DTensor
    return t.device_mesh if isinstance(t, DTensor) else None


def shard_model(cfg: ModelConfig, model: torch.nn.Module, mesh
                ) -> torch.nn.Module:
    """Swap every parameter of ``model`` for a DTensor on ``mesh`` placed by
    :func:`named_param_specs` (each rank keeps its block: no
    communication), in place; returns ``model``. Its steps then run on
    DTensor activations (``models.model``). Buffers stay plain tensors."""
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family has "
                                  "no sharded step")
    specs = named_param_specs(cfg, mesh)
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        owner._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad)
    return model


def shard_batch(cfg: ModelConfig, batch: Pytree, mesh) -> Pytree:
    """A batch of whole tensors as DTensors placed by :func:`batch_specs`."""
    return distribute(batch, mesh, batch_specs(cfg, batch, mesh))


def shard_state(cfg: ModelConfig, state: Pytree, mesh) -> Pytree:
    """A decode state of whole tensors as DTensors placed by
    :func:`decode_state_specs`."""
    return distribute(state, mesh, decode_state_specs(cfg, state, mesh))


def zeros_state(cfg: ModelConfig, template: Pytree, mesh, device) -> Pytree:
    """Zeros on ``device`` in the layout of ``template`` (a decode state on
    the meta device), each leaf a DTensor placed by
    :func:`decode_state_specs` whose rank allocates only its block."""
    from torch.distributed.tensor import DTensor

    def place(t, spec):
        spec = P(*spec) + P(*([None] * (t.ndim - len(spec))))
        local = local_block(t, mesh, spec)
        return DTensor.from_local(
            torch.zeros(local.shape, dtype=t.dtype, device=device), mesh,
            placements(mesh, spec), run_check=False, shape=t.shape,
            stride=_contiguous_strides(t.shape))

    return _zip_map(place, template,
                    decode_state_specs(cfg, template, mesh))


def local_offset(t, dim: int) -> int:
    """Where this rank's block of the DTensor ``t`` starts along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(offset[dim])


def shards(x, dim: int) -> int:
    """Into how many blocks the DTensor ``x``'s ``dim`` is cut."""
    n = 1
    for size, pl in zip(x.device_mesh.shape, x.placements):
        if getattr(pl, "dim", None) == dim:
            n *= size
    return n


def gather_dim(x, dim: int):
    """The DTensor ``x`` with ``dim`` whole on every rank (its other
    placements kept); ``x`` itself where ``dim`` is not split."""
    from torch.distributed.tensor import Replicate
    if shards(x, dim) == 1:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if getattr(pl, "dim", None) == dim else pl
        for pl in x.placements])


def local_along(like, x, dims) -> torch.Tensor:
    """The DTensor ``x`` redistributed to ``like``'s placements on its
    ``dims`` and replicated on every other mesh dim, as a local tensor:
    the part of ``x`` that meets this rank's block of ``like`` there."""
    from torch.distributed.tensor import Replicate
    pl = [p if getattr(p, "dim", None) in dims else Replicate()
          for p in like.placements]
    return x.redistribute(like.device_mesh, pl).to_local()


def attention_layout(mesh, B: int, Hq: int, Hkv: int, Sq: int | None):
    """Where an attention op's dims go so that each rank computes its part
    alone: (q's spec entries for batch, rows, heads; K/V's heads entry).
    The batch on the DP axes, the query heads on "model" where they divide
    it, the query rows (``Sq`` given: the flash op) on what is left where
    they divide; K/V's heads on "model" only beside the query heads and
    where they divide."""
    used: set = set()
    tp = tp_axis(mesh)
    b = _fit(mesh, B, dp_axes(mesh), used)
    h = _fit(mesh, Hq, (tp,), used) if tp else None
    s = None
    if Sq is not None:
        s = _fit(mesh, Sq, ((tp,) if tp else ()) + dp_axes(mesh), used)
    kvh = h if h is not None and Hkv % axis_size(mesh, h) == 0 else None
    return b, s, h, kvh
