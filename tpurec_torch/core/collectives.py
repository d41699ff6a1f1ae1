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
- ``all_gather``: the whole tensor from each rank's block along one axis,
  read alike by every rank (a tensor-parallel layer's sharded activation
  before a layer that needs it whole), so the backward keeps the rank's
  own block of the cotangent. Before a use that differs by rank (a slice
  of its own), wrap it in ``replicated_input``, whose backward then sums.
  Never over 'data': there every rank's loss differs.
- ``gather_batch``: the global batch's rows from each data rank's block,
  read differently by every rank (its own rows against the whole batch:
  the in-batch softmax's columns, DIEN's rolled negatives, DMR's
  auxiliary softmax), so the backward sums the cotangent over 'data' and
  keeps the rank's own block (a reduce-scatter): rank j's rows take the
  cotangent of every rank's loss.
- ``data_mean_share``: a mean over the global batch normalised by a count
  (a masked mean), as this rank's share of it, which the average of the
  gradients over 'data' turns into the global batch's value.

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


def gather_rows(local: torch.Tensor, group: Optional[Any], index: int, n: int,
                dim: int = 0) -> torch.Tensor:
    """The whole tensor, n·R long on ``dim``, from each rank's block R long
    there, the block of the rank at ``index`` at [index·R, (index+1)·R), on
    every rank of the axis, outside autograd. A sum of zero-padded blocks,
    so it needs only ``all_reduce`` (which gloo has for CUDA tensors) and is
    exact."""
    if group is None:
        return local.detach().clone()
    r = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = n * r
    whole = local.new_zeros(shape)
    whole.narrow(dim, index * r, r).copy_(local.detach())
    return all_reduce_(whole, group)


def local_share(whole: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's share over ``mesh``'s 'model' axis of ``whole`` on
    ``dim`` (the inverse of ``gather_rows`` over the axis), a copy."""
    k = whole.shape[dim] // mesh.n_model
    return whole.narrow(dim, mesh.model_index * k, k).clone()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n, dim):
        ctx.index, ctx.dim, ctx.r = index, dim, x.shape[dim]
        return gather_rows(x, group, index, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.r, ctx.r), None, None, None, None


def all_gather(x: torch.Tensor, group: Optional[Any], index: int, n: int,
               dim: int = -1) -> torch.Tensor:
    """``gather_rows`` along ``dim`` with a gradient: the backward keeps this
    rank's block of the cotangent. Right only where every rank of the axis
    computes the same thing from the result (the 'model' axis of a
    tensor-parallel layer); over 'data' use ``gather_batch``."""
    if group is None:
        return x
    return _AllGather.apply(x, group, index, n, dim % x.dim())


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group, ctx.index, ctx.r = group, index, x.shape[0]
        return gather_rows(x, group, index, n)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter from all_reduce, which gloo has for CUDA tensors
        whole = all_reduce_(g.contiguous().clone(), ctx.group)
        return whole.narrow(0, ctx.index * ctx.r, ctx.r), None, None, None


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of ``x`` (n_data·R rows from each data rank's
    R, in data order) on every data rank, with a gradient: the backward sums
    the cotangent over 'data' and keeps this rank's block, since each rank
    reads the result with its own loss. Right only over 'data'; a
    tensor-parallel layer's gather is ``all_gather``. ``mesh`` None (one
    data rank, or a replicated batch, which every rank holds whole): the
    identity."""
    if mesh is None or mesh.data_group is None:
        return x
    return _GatherBatch.apply(x, mesh.data_group, mesh.data_index, mesh.n_data)


def data_mean_share(total: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """``total / max(count, 1)`` over the global batch, as this rank's share
    of it: ``n_data · total / max(Σ count over 'data', 1)`` from this rank's
    ``total`` and ``count``, so that the mean of the shares over 'data' (the
    gradient average's) is the global value. ``mesh`` None (one data rank,
    or a replicated batch, whose local sums are already global): the plain
    quotient."""
    if mesh is None or mesh.data_group is None:
        return total / count.clamp_min(1.0)
    whole = all_reduce_(count.detach().clone(), mesh.data_group)
    return mesh.n_data * total / whole.clamp_min(1.0)
