"""Sorted-stream embedding gradient, gather and the fused engine's Adam
(counterpart of ``tpurec/ops/pallas/embedding_update.py``).

The fused embedding engine sorts the step's ids once (``make_scatter_plan``)
and builds each table's dense (V, D) aggregated gradient from the id-sorted
stream of per-occurrence gradients (``fused_scatter_add``), then applies
Adam to the whole table (``adam_update_``): every row's moments decay, as
dense Adam's do, while no table-shaped gradient goes through autograd.

Kernels of this module (CUDA C++ for ``sm_90a`` in
``tpurec_torch/csrc/embedding_update.cu``, built and loaded by
``tpurec_torch.ops.kernels``):

- ``fused_scatter_add``: replaces ``fused_scatter_add``
  (``tpurec/ops/pallas/embedding_update.py:231``);
- ``gather_rows_sorted``: replaces ``gather_rows_sorted`` (``:419``).

Each follows the rules of ``tpurec_torch.ops.kernels``: a plain version
(``scatter_add_plain``, ``gather_rows_plain``) computes the same function, the
wrapper takes it only for CPU tensors, launches the kernel or raises for CUDA
tensors, counts its launches in ``<wrapper>.launches`` and records no
backward (the engine runs it on gradients after ``backward()``).

What the JAX module has for the TPU only is not carried over: the packed
(V/k, 128) views, the sentinel-padded chunks and ``block_rows`` of the plan,
the ``lax.cond`` fallback when a chunk straddles more than two tiles, and
``pick_block_rows``. ``packed_take``, ``packed_scatter_add`` and
``packed_count_rows`` keep their names and their math (a take, an
``index_add_``, a count).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence, Tuple

import torch

from tpurec_torch.core import trace
from tpurec_torch.embedding.sparse import bias_correction
from tpurec_torch.ops import kernels


class ScatterPlan(NamedTuple):
    """The step's ids in ascending order: one sort, shared by every table of
    the id space and by the gather and the scatter."""

    sids: torch.Tensor  # (N,) int32, ascending
    order: torch.Tensor  # (N,) int64: ids[order] == sids
    n: int  # N
    num_rows: int  # table rows V


def make_scatter_plan(ids: torch.Tensor, num_rows: int) -> ScatterPlan:
    """One stable sort of the flattened ids: equal ids keep their order, as
    ``lax.sort((ids, iota))`` keeps it."""
    flat = ids.reshape(-1).to(torch.int32)
    sids, order = torch.sort(flat, stable=True)
    return ScatterPlan(sids, order, flat.shape[0], num_rows)


# ---------------------------------------------------------------------------
# plain math (what the JAX module's references compute)
def scatter_add_plain(num_rows: int, sids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """(V, D) fp32: ``G[sids[j]] += grads[j]``, zeros elsewhere, as
    ``scatter_add_reference``; ids outside [0, V) are dropped, as the kernel
    drops them. On the CPU ``index_add_`` sums in index order; on CUDA it
    sums with atomics, in an order that changes from run to run."""
    grads = grads.reshape(sids.shape[0], grads.shape[-1])
    keep = (sids >= 0) & (sids < num_rows)
    out = torch.zeros(num_rows, grads.shape[1], dtype=torch.float32, device=grads.device)
    return out.index_add_(0, sids[keep], grads[keep].to(torch.float32))


def gather_rows_plain(table: torch.Tensor, sids: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32: ``table[sids]``."""
    return table.to(torch.float32).index_select(0, sids)


def adam_update_(
    table: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    step: int,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """optax Adam on whole tensors (``adam_update``), IN PLACE: ``m`` and
    ``v`` take the new moments and ``table`` the new weights; returns the
    three. ``step`` counts from 1; the bias corrections are fp32, as JAX
    computes them. The one Adam of the port, ``ChainOptimizer``'s, on a list
    of one: ``kernels.adam_update_fused`` (its kernel on CUDA tensors)."""
    with torch.no_grad():
        kernels.adam_update_fused(
            [table], [g], [m], [v], lr=lr, bc1=bias_correction(b1, step),
            bc2=bias_correction(b2, step), b1=b1, b2=b2, eps=eps,
        )
    return table, m, v


def scatter_adam_reference(table, m, v, ids, grads, step, lr, b1=0.9, b2=0.999, eps=1e-7):
    """Dense-parity Adam from unsorted ``(ids, grads)``: the plain aggregated
    gradient, then ``adam_update_`` (in place)."""
    g = scatter_add_plain(table.shape[0], ids.reshape(-1), grads.reshape(-1, table.shape[-1]))
    return adam_update_(table, m, v, g, step, lr, b1, b2, eps)


# ---------------------------------------------------------------------------
# kernel #9: the aggregated gradient of a sorted stream
def fused_scatter_add(
    table_rows: int, d: int, plan: ScatterPlan, grads_sorted: torch.Tensor
) -> torch.Tensor:
    """Dense (V, D) fp32 aggregated gradient of the sorted stream:
    ``G[plan.sids[j]] += grads_sorted[j]``, zeros on rows no id touches.

    CPU tensors take ``scatter_add_plain``. CUDA tensors launch the kernel of
    ``csrc/embedding_update.cu`` once: zero blocks write zeros on the rows no
    id touches, while tile blocks sum the stream, one warp a slice of
    ``scatter_slice_rows(d)`` rows with the lanes across rows and columns
    (all 32 lanes load at any D), runs summed by a segmented scan in a fixed
    order and written to G where they end inside a tile of
    ``scatter_tile_rows(d)`` rows; a run that crosses tiles is finished by
    the tile where it ends, which adds the other tiles' partials in a fixed
    order once they are marked ready. No float atomics: two calls give the
    same bits. It
    takes int32 ``sids``, fp32 grads of shape (N, ``d``) and ids in [0,
    ``table_rows``) (others are dropped), and raises on anything else. It
    records no backward and refuses inputs that require grad under grad
    mode."""
    grads = grads_sorted.reshape(plan.n, d)
    if grads.device.type == "cpu":
        return scatter_add_plain(table_rows, plan.sids, grads)
    kernels._refuse_grad("fused_scatter_add", grads)
    kernels._require_cuda("fused_scatter_add", grads)
    dev = grads.device
    kernels._require_cuda_f32("fused_scatter_add", dev, grads=grads)
    _require_ids("fused_scatter_add", dev, plan)
    lib = kernels._library("embedding_update")
    out = torch.empty(table_rows, d, device=dev, dtype=torch.float32)
    # the partials of runs that cross slices and tiles
    scratch = torch.empty(
        lib.embedding_scatter_scratch_floats(plan.n, d), device=dev, dtype=torch.float32
    )
    grads = grads.contiguous()
    if grads.data_ptr() % 16:
        grads = grads.clone()  # 16-byte loads: the summation order is D's alone
    with torch.cuda.device(dev):
        err = lib.embedding_fused_scatter_add(
            plan.sids.data_ptr(), grads.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            # a new random mark each call: the kernel's tile blocks mark their
            # partials ready with it in scratch that is not cleared
            plan.n, d, table_rows, int.from_bytes(os.urandom(8), "little"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels._check_launch(lib, err, "fused_scatter_add")
    fused_scatter_add.launches += 1
    return out


fused_scatter_add.launches = 0


def scatter_slice_rows(d: int) -> int:
    """Rows of the sorted stream that one warp of a CUDA tile block sums at
    width ``d`` (builds and loads the kernel): a run that crosses a multiple
    of it leaves a partial per slice, folded by its block."""
    return kernels._library("embedding_update").embedding_scatter_slice_rows(d)


def scatter_tile_rows(d: int) -> int:
    """Rows of the sorted stream per tile block of the CUDA kernel at width
    ``d`` (builds and loads the kernel): a run that crosses a multiple of it
    is finished from the tiles' partials by the tile where it ends."""
    return kernels._library("embedding_update").embedding_scatter_tile_rows(d)


def _require_ids(what: str, device: torch.device, plan: ScatterPlan) -> None:
    sids = plan.sids
    if sids.device != device:
        raise ValueError(f"{what}: sids are on {sids.device}, expected {device}")
    if sids.dtype != torch.int32 or sids.dim() != 1 or sids.shape[0] != plan.n:
        raise TypeError(
            f"{what}: sids must be ({plan.n},) int32, got {tuple(sids.shape)} {sids.dtype}"
        )
    if not sids.is_contiguous():
        raise ValueError(f"{what}: sids must be contiguous")


def scatter_adam_sorted(table, m, v, plan, grads_sorted, step, lr, b1=0.9, b2=0.999, eps=1e-7):
    """Dense-parity Adam for one (V, D) table (in place): the aggregated
    gradient of the sorted stream, then ``adam_update_`` (the spans
    ``engine.scatter`` and ``engine.adam``)."""
    v_rows, d = table.shape
    with trace.span("engine.scatter"):
        g = fused_scatter_add(v_rows, d, plan, grads_sorted.reshape(-1, d))
    with trace.span("engine.adam"):
        return adam_update_(table, m, v, g, step, lr, b1, b2, eps)


def scatter_adam_grouped(tables, ms, vs, plan, grads_sorted, step, lr, b1=0.9, b2=0.999, eps=1e-7):
    """Every table of one id space, sharing the plan's one sort (in place);
    returns the lists of tables, first and second moments."""
    outs = [
        scatter_adam_sorted(t, m, v, plan, g, step, lr, b1, b2, eps)
        for t, m, v, g in zip(tables, ms, vs, grads_sorted)
    ]
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]


def fused_scatter_adam(table, m, v, ids, grads, step, lr, b1=0.9, b2=0.999, eps=1e-7):
    """Unsorted ``(ids, grads)`` → plan → sorted stream → ``scatter_adam_sorted``."""
    d = table.shape[-1]
    plan = make_scatter_plan(ids, table.shape[0])
    gs = grads.reshape(-1, d).index_select(0, plan.order)
    return scatter_adam_sorted(table, m, v, plan, gs, step, lr, b1, b2, eps)


# ---------------------------------------------------------------------------
# kernel #10: rows of the sorted stream
def gather_rows_sorted(table: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """``rows[j] = table[plan.sids[j]]``, (N, D) fp32.

    CPU tensors take ``gather_rows_plain``. CUDA tensors launch the kernel of
    ``csrc/embedding_update.cu`` (one block per slice of the stream, 16-byte
    copies when D allows), which takes an fp32 (V, D) table and int32 ids in
    [0, V) (others give zero rows) and raises on anything else. It records
    no backward."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, plan.sids)
    kernels._refuse_grad("gather_rows_sorted", table)
    kernels._require_cuda("gather_rows_sorted", table)
    dev = table.device
    kernels._require_cuda_f32("gather_rows_sorted", dev, table=table)
    if table.dim() != 2:
        raise ValueError(f"gather_rows_sorted: expected a (V, D) table, got {tuple(table.shape)}")
    _require_ids("gather_rows_sorted", dev, plan)
    v_rows, d = table.shape
    lib = kernels._library("embedding_update")
    table = table.contiguous()
    out = torch.empty(plan.n, d, device=dev, dtype=torch.float32)
    vec4 = int(d % 4 == 0 and table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = lib.embedding_gather_rows(
            plan.sids.data_ptr(), table.data_ptr(), out.data_ptr(), plan.n, d, v_rows, vec4,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels._check_launch(lib, err, "gather_rows_sorted")
    gather_rows_sorted.launches += 1
    return out


gather_rows_sorted.launches = 0


def gather_rows_grouped(tables: Sequence[torch.Tensor], plan: ScatterPlan) -> List[torch.Tensor]:
    """Every table of one id space, sharing the plan's one sort."""
    return [gather_rows_sorted(t, plan) for t in tables]


# ---------------------------------------------------------------------------
# back to the original order
class _Unpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows_sorted, order):
        ctx.save_for_backward(order)
        # the inverse permutation without a scatter: sort the (unique) order
        inv = torch.sort(order).indices
        return rows_sorted.index_select(0, inv)

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        return g.index_select(0, order), None


def unpermute_rows(rows_sorted: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """Rows of the sorted stream back in the original id order; the backward
    is a gather by ``plan.order``, never a scatter (``_unpermute``)."""
    return _Unpermute.apply(rows_sorted, plan.order)


# ---------------------------------------------------------------------------
# the math of the JAX module's packed-view helpers
def packed_take(table2d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``rows[j] = table2d[ids[j]]`` (the JAX version takes through the
    (V/k, 128) packed view, a TPU gather workaround)."""
    return table2d.index_select(0, ids.reshape(-1))


def packed_scatter_add(v_rows: int, ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """Dense (V, D) aggregated gradient from UNSORTED ids: one
    ``index_add_`` (on CUDA it sums with atomics, as XLA's scatter does)."""
    ids = ids.reshape(-1)
    grads = grads.reshape(ids.shape[0], grads.shape[-1]).to(torch.float32)
    out = torch.zeros(v_rows, grads.shape[1], dtype=torch.float32, device=grads.device)
    return out.index_add_(0, ids, grads)


def packed_count_rows(v_rows: int, ids: torch.Tensor) -> torch.Tensor:
    """(V, 1) fp32 occurrence count of each row."""
    ids = ids.reshape(-1)
    ones = torch.ones(ids.shape[0], 1, dtype=torch.float32, device=ids.device)
    return torch.zeros(v_rows, 1, dtype=torch.float32, device=ids.device).index_add_(0, ids, ones)
