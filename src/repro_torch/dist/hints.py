"""Logical-axis sharding hints (the port of ``repro.dist.hints``).

Model code annotates tensors with *roles* ("dp", "tp", "seq", …) instead of
mesh axes; :func:`sharding_rules` binds roles to a mesh for the duration of
a pass, and :func:`hint` resolves them. Outside a rules context every hint
returns its argument itself, so the same model functions run unmeshed.

Roles:
  "dp"                        batch-like dims -> all DP axes (pod, data)
  "tp"                        head/ff/vocab dims -> "model"
  "seq" / "sp" / "sq"         sequence dims -> whatever axes are still free
                              ("model" first, then the DP axes)
  "sp_seq"                    Megatron-SP residual activations; inert unless
                              ``sharding_rules(mesh, seq_parallel=True)``

:func:`resolve` is the reference's two-pass resolution as a pure function of
a shape: primary roles claim their axes first, sequence roles then sweep up
what is left, each axis at most once and only where it divides the dim.

PyTorch runs eagerly and has no compiler to constrain: under rules,
:func:`hint` redistributes a DTensor to the resolved placements (and its
gradient likewise) and passes a plain tensor through unchanged (its rank is
still checked).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.dist import sharding as shd

_SEQ_ROLES = ("seq", "sp", "sq", "sp_seq")

_ACTIVE: dict[str, Any] | None = None


def _make_rules(mesh, seq_parallel: bool = False) -> dict[str, Any]:
    dp = shd.dp_axes(mesh)
    tp = shd.tp_axis(mesh)
    sizes = shd.mesh_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    return {
        "mesh": mesh,
        "dp": dp,
        "tp": tp,
        "dp_size": dp_size,
        "tp_size": sizes.get("model", 1),
        "seq_parallel": seq_parallel,
    }


@contextlib.contextmanager
def sharding_rules(mesh, *, seq_parallel: bool = False):
    """Bind logical roles to ``mesh`` (a DeviceMesh, or an AbstractMesh for
    spec rules alone) for the enclosed code.

    ``seq_parallel`` opts in to Megatron-style sequence parallelism: the
    "sp_seq" role on residual activations stays inert unless enabled (the
    structural sequence roles "seq"/"sp"/"sq" are always live)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _make_rules(mesh, seq_parallel)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def get_rules() -> dict[str, Any] | None:
    """The active role->axis binding, or None outside a rules context."""
    return _ACTIVE


def tp_divides(dim: int) -> bool:
    """Can ``dim`` shard over the TP axis? Vacuously true without rules."""
    r = _ACTIVE
    if r is None or r["tp"] is None:
        return True
    return dim % r["tp_size"] == 0


def resolve(shape, *roles) -> shd.P | None:
    """The spec :func:`hint` constrains a tensor of ``shape`` to under the
    active rules, or None where it constrains nothing (no rules, or every
    dim replicated). Raises ``AssertionError`` on a rank mismatch under
    rules, as the reference's ``hint`` does."""
    r = _ACTIVE
    if r is None:
        return None
    assert len(roles) == len(shape), \
        f"hint(): {len(roles)} roles for rank-{len(shape)} tensor {tuple(shape)}"
    mesh = r["mesh"]
    used: set = set()
    entries: list = [None] * len(shape)
    for i, role in enumerate(roles):
        if role == "dp":
            entries[i] = shd._fit(mesh, shape[i], r["dp"], used)
        elif role == "tp" and r["tp"] is not None:
            entries[i] = shd._fit(mesh, shape[i], (r["tp"],), used)
    for i, role in enumerate(roles):
        if role == "sp_seq" and not r["seq_parallel"]:
            continue                       # Megatron-SP residuals are opt-in
        if role in _SEQ_ROLES:
            rest = ((r["tp"],) if r["tp"] else ()) + r["dp"]
            entries[i] = shd._fit(mesh, shape[i], rest, used)
    if all(e is None for e in entries):
        return None
    return shd.P(*entries)


def hint(x, *roles):
    """Constrain ``x``'s placement by per-dim roles (one role per dim).

    ``x`` itself outside a :func:`sharding_rules` context (not even the
    rank is looked at). Under rules the rank must match; a DTensor is
    redistributed to ``placements(mesh, resolve(x.shape, *roles))``, and a
    plain tensor is returned unchanged."""
    r = _ACTIVE
    if r is None:
        return x
    spec = resolve(x.shape, *roles)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _Constrain.apply(x, tuple(shd.placements(x.device_mesh, spec)))
    return x


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its cotangent
    constrained the same way, as XLA transposes a sharding constraint
    (DTensor's own redistribute returns the cotangent to the input's
    placements: a partial sum's, which the next matmul's backward then
    cannot split)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None
