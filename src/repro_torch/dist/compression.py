"""int8 error-feedback gradient compression for data-parallel collectives
(the port of ``repro.dist.compression``).

Gradients are quantized to int8 (4x fewer bytes on the wire than f32)
before the reduction, and the per-rank quantization residual is fed back
into the next step's gradient (error feedback / EF-SGD, Seide et al. 2014;
Karimireddy et al. 2019). EF keeps the *accumulated* update unbiased.

:func:`compressed_psum` runs over a process group: the mesh dim
``axis_name`` of the active rules' DeviceMesh, or a group passed as the
axis. The wire carries the int8 payload and one f32 scale per rank (two
all_gathers); each rank dequantizes and sums the gathered payload in rank
order, so every rank's mean is bitwise the same.
"""

from __future__ import annotations

from typing import Any

import torch

Pytree = Any


# ------------------------------------------------------------- quantization
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32 scalar).

    Round-half-to-even onto the int8 grid, so the roundtrip error is bounded
    by scale/2 per element. A zero tensor gets scale 0 and q == 0."""
    return _quantize(x.float(), x.float().abs().max() / 127.0)


# XLA compiles the reference's ``max / 127.0`` inside its collective into a
# product with the f32 reciprocal of 127 (its algebraic simplifier rewrites a
# division by a constant); the collective's scale is computed the same way
# here, so that its payload and means are the reference's bit for bit
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _quantize(xf: torch.Tensor, scale: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    scale = scale.float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _leaves(tree: Pytree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def compression_ratio(tree: Pytree) -> float:
    """Wire-bytes ratio: original dtype bytes vs int8 payload + f32 scale."""
    leaves = _leaves(tree)
    orig = sum(t.numel() * t.element_size() for t in leaves)
    comp = sum(t.numel() + 4 for t in leaves)     # int8 + per-tensor scale
    return orig / comp


# ------------------------------------------------------- compressed psum/EF
def _group(axis_name):
    """The process group of ``axis_name``: a mesh dim of the active rules'
    DeviceMesh, or a process group given as the axis."""
    if not isinstance(axis_name, str):
        return axis_name
    from repro_torch.dist.hints import get_rules
    r = get_rules()
    if r is None:
        raise RuntimeError(f"compressed_psum over {axis_name!r} needs an "
                           "active sharding_rules(mesh) or a process group")
    return r["mesh"].get_group(axis_name)


def compressed_psum(x: torch.Tensor, axis_name, err: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``x`` over the ranks of ``axis_name`` through an
    int8-compressed collective, with error feedback.

    Returns ``(mean, new_err)``: ``mean`` in ``x.dtype`` (the same bits on
    every rank), ``new_err`` this rank's f32 residual to feed into the next
    call. Invariant (per rank): ``dequantized + new_err == x + err``, which
    keeps the accumulated means unbiased over steps."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import all_gather
    group = _group(axis_name)
    if err is None:
        err = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    comp = x.float() + err                      # error-compensated gradient
    q, scale = _quantize(comp, comp.abs().max() * _INV_127.to(comp.device))
    # the residual rounded once, as the reference's fused multiply-subtract
    # gives it: q * scale is exact in f64 (8 + 24 bits) and so is comp minus
    # it, so the f32 cast is the only rounding
    new_err = (comp.double() - q.double() * scale.double()).float()
    n = dist.get_world_size(group)
    # the wire: this rank's int8 payload and its one f32 scale
    q_all = all_gather(q.reshape(1, -1), 0, group).reshape(
        (n,) + tuple(x.shape))
    s_all = all_gather(scale.reshape(1), 0, group)
    deq_all = q_all.float() * s_all.reshape((n,) + (1,) * x.ndim)
    mean = deq_all.sum(dim=0) / n
    return mean.to(x.dtype), new_err


def _map2(fn, tree: Pytree, err: Pytree | None) -> tuple[Pytree, Pytree]:
    if isinstance(tree, dict):
        pairs = {k: _map2(fn, v, None if err is None else err[k])
                 for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [_map2(fn, v, None if err is None else err[i])
                 for i, v in enumerate(tree)]
        return (type(tree)(p[0] for p in pairs),
                type(tree)(p[1] for p in pairs))
    return fn(tree, err)


def wrap_grads(grads: Pytree, axis_name, err: Pytree | None
               ) -> tuple[Pytree, Pytree]:
    """Per-leaf :func:`compressed_psum` over a gradient tree (the train
    step's ``{name: tensor}``, or nested dicts and lists).

    ``err`` is the error-feedback state of the previous step (None on step
    0 -> zeros). Returns ``(mean_grads, new_err)``, both of ``grads``'
    structure."""
    return _map2(lambda g, e: compressed_psum(g, axis_name, e), grads, err)
