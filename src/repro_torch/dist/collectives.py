"""The collectives of the sharded paths, on process groups (NCCL on the
card, gloo on the CPU), and the autograd rules the sharded MoE needs.

Each call waits for its result. The autograd nodes give the gradients of
one loss computed SPMD: a value replicated over the model ranks counts once
(Megatron's ``f`` and ``g``), and over the data ranks every rank's loss is a
share of the total.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol

# the ``*_single`` spellings replace ``*_tensor`` (same arguments) in newer
# torch; older releases have only the latter
_all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_reduce_scatter = getattr(funcol, "reduce_scatter_single",
                          funcol.reduce_scatter_tensor)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", group))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order."""
    return funcol.wait_tensor(_all_gather(x.contiguous(), dim, group))


def reduce_scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks, each rank keeping its block along ``dim``."""
    return funcol.wait_tensor(_reduce_scatter(x.contiguous(), "sum", dim,
                                              group))


class SumToModel(torch.autograd.Function):
    """Sum over the model ranks, gradient passed through: the experts'
    partial outputs combine into one output replicated over "model", whose
    cotangent is every rank's (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class FromModel(torch.autograd.Function):
    """Identity forward, gradient summed over the model ranks: a value
    replicated over "model" that feeds each rank's own experts collects all
    ranks' contributions (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class GatherData(torch.autograd.Function):
    """The FSDP all_gather of a weight shard along ``dim``; its gradient is
    the reduce-scatter (sum) of the gathered weight's."""

    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.dim, ctx.group), None, None


def _mean_over(x: torch.Tensor, groups, n: int) -> torch.Tensor:
    for grp in groups:
        x = all_reduce_sum(x, grp)
    return x / n


class MeanOverRanks(torch.autograd.Function):
    """Mean over the DP ranks (one group per DP axis); the gradient is the
    same mean of the cotangents, as the sum of every rank's loss needs."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.groups, ctx.n = groups, n
        return _mean_over(x, groups, n)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g, ctx.groups, ctx.n), None, None
