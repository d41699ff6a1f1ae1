"""Embedding modules over the shared offset-encoded id space (counterpart of
``tpurec/embedding/modules.py``).

One ``SharedEmbedding`` table serves every categorical feature through its
global offset id. Its table is always the module's ``embedding`` parameter,
so ``state_dict``, export, ``load_servable`` and restore see one layout in
every engine. The dense engine, eval and serving look ids up in it.

The lazy-sparse and fused engines (``tpurec_torch.train.trainer``) gather the
rows a step touches themselves and hand them to the modules with
``sparse_rows(model, rows, layout)`` (the counterpart of the JAX
``'sparse_rows'`` collection); the batch's ids are then positions in those
rows. In the ``'unique'`` layout a lookup is a take from the rows (and
records its used-id L2 term on them); in the ``'direct'`` layout it is
``contiguous_take`` and the trainer computes the used-id L2 itself. The
trainer leaves the tables out of the optimizer and updates them in place
(the counterpart of the JAX ``'tables'`` collection). The JAX package's
packed and ``shard_map`` lookups are TPU and mesh features of later slices.

The used-id L2 term: the JAX package ``sow``s ``used_id_l2`` of each lookup
call into the ``'regularization'`` collection when the trainer makes it
mutable (``tpurec/embedding/modules.py:183-192``), and sums the collection.
Here the trainer opens ``record_used_id_l2(model)`` around its forward: it
hands every ``SharedEmbedding`` of the model one list, and each lookup made
in training mode appends its term to it.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.ops import contiguous_take, pad_vocab, used_id_l2
from tpurec_torch.initializers import uniform_


INIT_SCALE = 0.05  # tables are drawn from U(-0.05, 0.05), as in the JAX package


class SharedEmbedding(nn.Module):
    """(V_pad, D) fp32 table ``embedding``, V_pad = ``pad_vocab(vocab_size)``;
    lookups come out in ``dtype`` (None = the table's fp32)."""

    def __init__(self, vocab_size: int, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(pad_vocab(vocab_size), dim))
        # the list of an open ``record_used_id_l2``, else None
        self.used_id_l2_terms: Optional[List[torch.Tensor]] = None
        # the rows of an open ``sparse_rows`` and their layout, else None
        self.sparse_rows: Optional[torch.Tensor] = None
        self.sparse_layout = "unique"

    def init_weights(self, generator: torch.Generator) -> None:
        uniform_(self.embedding, INIT_SCALE, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.sparse_rows
        if rows is not None and self.sparse_layout == "direct":
            out = contiguous_take(rows, ids)
        else:
            table = self.embedding if rows is None else rows
            out = F.embedding(ids, table)
            if self.used_id_l2_terms is not None and self.training:
                self.used_id_l2_terms.append(used_id_l2(table, ids))
        return out if self.dtype is None else out.to(self.dtype)


def embedding_tables(model: nn.Module) -> List[SharedEmbedding]:
    """Every ``SharedEmbedding`` of ``model``, in module order."""
    return [m for m in model.modules() if isinstance(m, SharedEmbedding)]


@contextlib.contextmanager
def sparse_rows(model: nn.Module, rows: Sequence[torch.Tensor], layout: str):
    """In the body, the i-th table of ``embedding_tables(model)`` looks ids up
    in ``rows[i]`` with ``layout`` (``'unique'`` or ``'direct'``)."""
    if layout not in ("unique", "direct"):
        raise ValueError(f"unknown sparse layout {layout!r}")
    tables = embedding_tables(model)
    if len(rows) != len(tables):
        raise ValueError(f"{len(rows)} row blocks for {len(tables)} tables")
    for table, r in zip(tables, rows):
        table.sparse_rows, table.sparse_layout = r, layout
    try:
        yield
    finally:
        for table in tables:
            table.sparse_rows, table.sparse_layout = None, "unique"


@contextlib.contextmanager
def record_used_id_l2(model: nn.Module):
    """Collect, in the body, the used-id L2 term of every lookup that a
    ``SharedEmbedding`` of ``model`` makes in training mode; yields the list
    the terms are appended to (one per call)."""
    tables = embedding_tables(model)
    terms: List[torch.Tensor] = []
    for table in tables:
        table.used_id_l2_terms = terms
    try:
        yield terms
    finally:
        for table in tables:
            table.used_id_l2_terms = None


class LinearEmbedding(nn.Module):
    """(V_pad, 1) order-1 weight table (the FM 'w-embedding'); returns the
    scores with the last dim squeezed. Param path ``w/embedding`` under the
    owner's name, as in the JAX package."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.w = SharedEmbedding(vocab_size, 1)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w(ids).squeeze(-1)
