"""Collectives over one axis of the mesh, with the gradients that JAX's
``shard_map`` gives ``lax.psum`` and ``lax.pmax`` (no counterpart file in the
JAX package).

Which backward a sum needs depends on who reads its result:

- ``psum``: the result is read alike by every rank of the axis (a lookup's
  rows, summed over 'model', feed the same loss on every model rank), so
  every rank already holds the whole cotangent, and the backward is the
  identity. ``torch.distributed.nn.functional.all_reduce`` would all-reduce
  it again, and each input's gradient would come out n times too large.
- ``replicated_input``: the forward is the identity, and the backward sums
  the cotangents over the axis. An input that every rank of the axis holds
  alike (CP's query and weights) collects there the partial gradients of
  the ranks' shards.
- ``psum(replicated_input(x))`` is the sum whose backward sums too: the batch
  moments over 'data' (``ops.mlp.BatchNorm``), read by ranks whose losses
  differ.
- ``pmax``: a maximum, with no gradient (the softmax shift).

A group of None stands for an axis of size 1: every function is then the
identity.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


def all_reduce_(x: torch.Tensor, group: Optional[Any], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a tensor outside autograd; returns it."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def psum(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Σ of ``x`` over the axis; identity backward."""
    if group is None:
        return x
    return _Psum.apply(x, group)


def replicated_input(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """``x`` itself; the backward sums the cotangent over the axis."""
    if group is None:
        return x
    return _ReplicatedInput.apply(x, group)


def pmax(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Elementwise max of ``x`` over the axis, without a gradient."""
    return all_reduce_(x.detach().clone(), group, dist.ReduceOp.MAX)


def gather_rows(local: torch.Tensor, group: Optional[Any], index: int, n: int) -> torch.Tensor:
    """The whole (n·R, ...) tensor from each rank's (R, ...) block, the
    block of the rank at ``index`` at rows [index·R, (index+1)·R), on every
    rank of the axis, outside autograd. A sum of zero-padded blocks, so it
    needs only ``all_reduce`` (which gloo has for CUDA tensors) and is
    exact."""
    if group is None:
        return local.detach().clone()
    r = local.shape[0]
    whole = local.new_zeros((n * r,) + tuple(local.shape[1:]))
    whole[index * r : (index + 1) * r] = local.detach()
    return all_reduce_(whole, group)
