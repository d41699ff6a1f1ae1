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
packed lookup is a TPU gather strategy the port does not need.

On a mesh of more than one device (``place``, called by ``build_model``) a
table holds this rank's rows of the ``pad_vocab(V, n_model)``-row table, and
the dense engine looks ids up with ``row_sharded_lookup``; its used-id L2
term counts the rows the global batch touches (``sharded_used_id_l2``; in
the lazy-sparse engine, whose unique rows every rank holds,
``data_used_id_l2``). The JAX package's two strategies, ``'gspmd'`` and
``'shard_map'``, compute the same rows: the port has one.

``FieldAwareEmbedding`` (FFM's and ONN's (V_pad, F, D) table) takes part in
all of this as a table: ``embedding_tables`` and ``sparse_rows`` list it
beside the ``SharedEmbedding``s, and its rows are (U, F, D) or (N, F, D).

The used-id L2 term: the JAX package ``sow``s ``used_id_l2`` of each lookup
call into the ``'regularization'`` collection when the trainer makes it
mutable (``tpurec/embedding/modules.py:183-192``), and sums the collection.
Here the trainer opens ``record_used_id_l2(model)`` around its forward: it
hands every ``SharedEmbedding`` of the model one list, and each lookup made
in training mode appends its term to it. A ``FieldAwareEmbedding`` records
none, as its JAX counterpart sows none; the fused engine's ``'permute'``
term, which sums over every table's rows, does count it there and here.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.core.collectives import gather_rows
from tpurec_torch.embedding.ops import (
    contiguous_take,
    data_used_id_l2,
    local_rows,
    pad_vocab,
    padded_lookup,
    row_sharded_lookup,
    sharded_used_id_l2,
    used_id_l2,
)
from tpurec_torch.initializers import uniform_


INIT_SCALE = 0.05  # tables are drawn from U(-0.05, 0.05), as in the JAX package


class EmbeddingTable(nn.Module):
    """Table ``embedding`` of shape (V_pad, *row_shape), V_pad =
    ``pad_vocab(vocab_size)``, held in ``param_dtype`` (fp32 by default)
    and drawn from U(±``init_scale``) (0.05 by default); a lookup of (...)
    ids gives (..., *row_shape) in ``dtype`` (None = the table's dtype).
    The lookup of every table: from the table, or from the rows of an open
    ``sparse_rows`` in their layout. No config sets ``init_scale`` or
    ``param_dtype`` (nor in the JAX package), so the trainer's engines
    always hold fp32 tables."""

    def __init__(self, vocab_size: int, row_shape: Tuple[int, ...],
                 dtype: Optional[torch.dtype] = None, init_scale: float = INIT_SCALE,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.row_shape = tuple(row_shape)
        self.init_scale = init_scale
        self.embedding = nn.Parameter(
            torch.empty(pad_vocab(vocab_size), *row_shape, dtype=param_dtype)
        )
        # the MeshContext of a mesh of more than one device, else None
        self.mesh = None
        # the list of an open ``record_used_id_l2`` (``SharedEmbedding``s
        # only), else None
        self.used_id_l2_terms: Optional[List[torch.Tensor]] = None
        # the rows of an open ``sparse_rows`` and their layout, else None
        self.sparse_rows: Optional[torch.Tensor] = None
        self.sparse_layout = "unique"

    def place(self, mesh) -> None:
        """Take part in ``mesh`` (more than one device): with n_model > 1 the
        table becomes this rank's V_pad / n_model rows, V_pad =
        ``pad_vocab(vocab_size, n_model)``. Call before ``init_weights``,
        which draws the one-device table's rows (so the model's other
        weights draw what they draw on one device) and leaves the rows past
        them, padding past the vocabulary, zero."""
        self.mesh = mesh
        if mesh.n_model > 1:
            rows = pad_vocab(self.vocab_size, mesh.n_model) // mesh.n_model
            self.embedding = nn.Parameter(self.embedding.new_empty(rows, *self.row_shape))

    @property
    def row_offset(self) -> int:
        """The global row of this rank's first row."""
        return 0 if self.mesh is None else self.mesh.model_index * self.embedding.shape[0]

    def init_weights(self, generator: torch.Generator) -> None:
        if self.mesh is None or self.mesh.n_model == 1:
            uniform_(self.embedding, self.init_scale, generator)
            return
        # every rank draws the one-device table, so the rest of the draws
        # agree with one device's; the mesh's extra padding rows are zeros
        whole = self.embedding.new_zeros(
            self.embedding.shape[0] * self.mesh.n_model, *self.row_shape
        )
        uniform_(whole[: pad_vocab(self.vocab_size)], self.init_scale, generator)
        with torch.no_grad():
            self.embedding.copy_(local_rows(whole, self.mesh))

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole table of a (V_loc, ...) tensor of this table's rows (the
        table, a moment, a row-wise optimizer's (V_loc,) state), gathered
        over 'model' on every rank of the axis."""
        if self.mesh is None:
            return local.detach()
        m = self.mesh
        return gather_rows(local, m.model_group, m.model_index, m.n_model)

    def fit(self, current: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        """``current`` (this rank's rows of the table or of a moment) with the
        rows that ``whole`` has taken from it: whole tables of another mesh
        differ only in padding rows past the vocabulary (``pad_vocab``), and
        rows that ``whole`` lacks keep their values. Raises ``ValueError``
        when ``whole`` is not this table on any mesh."""
        n_rows = whole.shape[0]
        if tuple(whole.shape[1:]) != tuple(current.shape[1:]) or not any(
            pad_vocab(self.vocab_size, n) == n_rows for n in range(1, n_rows // 128 + 1)
        ):
            raise ValueError(
                f"a {tuple(whole.shape)} table is not the {self.vocab_size}-id table "
                f"with rows {tuple(current.shape[1:])} on any mesh"
            )
        out = current.detach().clone()
        lo = self.row_offset
        hi = min(lo + current.shape[0], whole.shape[0])
        if hi > lo:
            out[: hi - lo] = whole[lo:hi].to(out)
        return out

    def forward(self, ids: torch.Tensor, padding_index: Optional[int] = None) -> torch.Tensor:
        """The rows of ``ids``; ``padding_index`` names the padding id of a
        padded series, whose many repeats the dense backward then spreads
        (``padded_lookup``)."""
        rows = self.sparse_rows
        if rows is not None and self.sparse_layout == "direct":
            out = contiguous_take(rows, ids)
        else:
            table = self.embedding if rows is None else rows
            mesh = self.mesh if rows is None else None  # the dense engine on a mesh
            if mesh is not None and mesh.n_model > 1:
                out = row_sharded_lookup(table, ids, mesh)
            else:
                # a (V, F, D) table is indexed: on the H100 its backward
                # (``index_put_``) took less device time than
                # ``embedding_dense_backward`` over the (V, F·D) view (PERF.md §5)
                if table.dim() != 2:
                    out = table[ids]
                elif padding_index is not None and table.requires_grad and torch.is_grad_enabled():
                    out = padded_lookup(table, ids, padding_index)
                else:
                    out = F.embedding(ids, table)
            if self.used_id_l2_terms is not None and self.training:
                if mesh is not None:
                    term = sharded_used_id_l2(table, ids, mesh)
                elif rows is not None and self.mesh is not None and self.mesh.n_data > 1:
                    term = data_used_id_l2(table, ids, self.mesh)  # lazy-sparse on 'data'
                else:
                    term = used_id_l2(table, ids)
                self.used_id_l2_terms.append(term)
        return out if self.dtype is None else out.to(self.dtype)


class SharedEmbedding(EmbeddingTable):
    """(V_pad, D) table over the shared id space; its lookups record the
    used-id L2 term."""

    def __init__(self, vocab_size: int, dim: int, dtype: Optional[torch.dtype] = None,
                 init_scale: float = INIT_SCALE, param_dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, (dim,), dtype, init_scale, param_dtype)


class FieldAwareEmbedding(EmbeddingTable):
    """(V_pad, F, D) table: one embedding per (id, target field) pair, FFM's
    and ONN's layout; lookups give (..., F, D). Records no used-id L2 term
    (``tpurec/embedding/modules.py:223-275``)."""

    def __init__(self, vocab_size: int, num_fields: int, dim: int,
                 dtype: Optional[torch.dtype] = None, init_scale: float = INIT_SCALE,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, (num_fields, dim), dtype, init_scale, param_dtype)


def embedding_tables(model: nn.Module) -> List[EmbeddingTable]:
    """Every table of ``model`` (``SharedEmbedding`` and
    ``FieldAwareEmbedding``), in module order."""
    return [m for m in model.modules() if isinstance(m, EmbeddingTable)]


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
    tables = [m for m in model.modules() if isinstance(m, SharedEmbedding)]
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

    def __init__(self, vocab_size: int, init_scale: float = INIT_SCALE,
                 param_dtype: torch.dtype = torch.float32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.w = SharedEmbedding(vocab_size, 1, dtype, init_scale, param_dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w(ids).squeeze(-1)
