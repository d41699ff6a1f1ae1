"""Embedding-table helpers (counterpart of ``tpurec/embedding/ops.py``).

On a mesh a table's rows are split over 'model': model rank m holds rows
[m·V_loc, (m+1)·V_loc) of the ``pad_vocab(V, n_model)``-row table
(``local_rows``), and ``row_sharded_lookup`` sums the ranks' rows."""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from tpurec_torch.core.collectives import all_reduce_, psum

if TYPE_CHECKING:
    from tpurec_torch.core.mesh import MeshContext


def pad_vocab(vocab_size: int, n_model: int = 1, lane: int = 128) -> int:
    """Table row count: ``vocab_size + 1`` rounded up to a multiple of
    ``n_model * lane``. The same count as the JAX package, so weights move
    between the two packages row for row; the spare last row is the JAX
    sparse engine's scatter target for padded duplicate ids."""
    m = n_model * lane
    return ((vocab_size + 1 + m - 1) // m) * m


def used_id_l2(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ of squared rows over the *unique* ids of one lookup, on the
    table as given (the fp32 table), as ``tpurec/embedding/ops.py:used_id_l2``:
    the ids are sorted and repeats masked, so no host sync (``torch.unique``
    would need one for its dynamic shape)."""
    flat = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    rows = table[flat]
    sq = (rows * rows).sum(dim=-1)
    return 0.5 * torch.where(first, sq, 0.0).sum()


class _ContiguousTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, ids):
        ctx.save_for_backward(ids)
        ctx.rows_shape = rows.shape
        out = rows.index_select(0, ids.reshape(-1))
        return out.reshape(ids.shape + rows.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = g.new_zeros(ctx.rows_shape)
        # every looked-up row is written once: a permuted copy, no sum
        d.index_copy_(0, ids.reshape(-1), g.reshape((-1,) + tuple(ctx.rows_shape[1:])))
        return d, None


def contiguous_take(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``rows[ids]`` with a backward that sums nothing (counterpart of
    ``tpurec/embedding/ops.py:contiguous_take``).

    Contract (the fused engine's position rewrite makes it hold; not
    checked): for ids reshaped to (B, k), every column j is the contiguous
    run ``ids[0, j] + arange(B)``, and the columns are disjoint. The JAX VJP
    writes each column's gradient into its run with k slice updates; here
    one ``index_copy_`` writes the same k runs without reading their starts
    back to the host, every looked-up row exactly once. It is never the
    sort-and-sum of ``embedding_dense_backward``."""
    return _ContiguousTake.apply(rows, ids)


# scratch rows a padded lookup's backward spreads the padding id's
# positions over (``padded_lookup``): runs of at most n / 65,536 ids
PADDING_SPREAD = 1 << 16


class _PaddedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, padding_index):
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.padding_index = table.shape[0], padding_index
        return F.embedding(ids, table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n_rows, pad = ctx.n_rows, ctx.padding_index
        flat = ids.reshape(-1)
        spare = torch.arange(flat.numel(), device=flat.device).bitwise_and_(PADDING_SPREAD - 1)
        spread = torch.where(flat == pad, spare.add_(n_rows), flat)
        d = torch.ops.aten.embedding_dense_backward(
            g.reshape(flat.numel(), -1), spread, n_rows + PADDING_SPREAD, -1, False)
        d[pad] += d[n_rows:].sum(dim=0)
        return d[:n_rows], None, None


def padded_lookup(table: torch.Tensor, ids: torch.Tensor, padding_index: int) -> torch.Tensor:
    """``F.embedding(ids, table)`` over a padded series, with the same
    gradient, summed in another order: the backward sorts the ids and sums
    each id's run in one thread a feature (``embedding_dense_backward``), so
    the padding id's run, 20–93 % of a series' ids, would be the step's
    longest serial sum. Its positions go to ``PADDING_SPREAD`` scratch rows
    past the table instead, round robin, and the scratch rows' sum is added
    to the padding row."""
    return _PaddedLookup.apply(table, ids, padding_index)


def local_rows(whole: torch.Tensor, mesh: "MeshContext") -> torch.Tensor:
    """This rank's rows of a whole (V, ...) table: rows [m·V/n, (m+1)·V/n)
    for model index m of n. V must divide by n (pad the table)."""
    n = mesh.n_model
    if whole.shape[0] % n != 0:
        raise ValueError(f"vocab {whole.shape[0]} not divisible by model axis {n}")
    v_local = whole.shape[0] // n
    return whole[mesh.model_index * v_local : (mesh.model_index + 1) * v_local]


def _owned(ids: torch.Tensor, v_local: int, mesh: "MeshContext"):
    """(local row of each id, clamped to 0 where not owned; owned mask)."""
    local = ids - mesh.model_index * v_local
    ok = (local >= 0) & (local < v_local)
    return torch.where(ok, local, 0), ok


def row_sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh: "MeshContext") -> torch.Tensor:
    """Rows of a row-sharded (V, ...) table for (...) ids, from this rank's
    (V/n_model, ...) block ``table`` (``tpurec/embedding/ops.py:36-79``):
    each rank takes the ids it owns, zeros the rest, and one sum over
    'model' assembles the rows. The sum's backward is the identity, so each
    rank's block takes the gradient of its own rows only."""
    idx, ok = _owned(ids, table.shape[0], mesh)
    emb = F.embedding(idx, table) if table.dim() == 2 else table[idx]
    emb = torch.where(ok.reshape(ok.shape + (1,) * (emb.dim() - ok.dim())), emb, 0.0)
    return psum(emb, mesh.model_group)


def sharded_used_id_l2(table: torch.Tensor, ids: torch.Tensor, mesh: "MeshContext") -> torch.Tensor:
    """``used_id_l2`` of a lookup on a mesh, in table space: each row the
    global batch touches counts once (the occurrence counts of this rank's
    rows summed over 'data'), and the rank's partial sums are summed over
    'model' (identity backward). The term is the same on every rank, and
    its gradient, ``touched · row``, lands on the rank's own rows."""
    idx, ok = _owned(ids.reshape(-1), table.shape[0], mesh)
    count = torch.zeros(table.shape[0], device=table.device)
    count.index_add_(0, idx, ok.to(torch.float32))
    touched = all_reduce_(count, mesh.data_group) > 0
    sq = table.reshape(table.shape[0], -1).square().sum(-1)
    return psum(0.5 * torch.where(touched, sq, 0.0).sum(), mesh.model_group)


def data_used_id_l2(rows: torch.Tensor, ids: torch.Tensor, mesh: "MeshContext") -> torch.Tensor:
    """``used_id_l2`` of a lookup into rows that every data rank holds alike
    (the lazy-sparse engine's unique rows on a data axis) by ids that are
    this rank's block of the global batch's: each row the global batch
    touches counts once (the occurrence counts summed over 'data'), so the
    term is the same on every rank."""
    count = torch.zeros(rows.shape[0], device=rows.device)
    count.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=rows.device))
    touched = all_reduce_(count, mesh.data_group) > 0
    sq = rows.reshape(rows.shape[0], -1).square().sum(-1)
    return 0.5 * torch.where(touched, sq, 0.0).sum()
