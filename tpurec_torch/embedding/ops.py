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
