"""Embedding-table helpers (counterpart of ``tpurec/embedding/ops.py``)."""

from __future__ import annotations

import torch


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
