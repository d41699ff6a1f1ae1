"""Embedding modules over the shared offset-encoded id space (counterpart of
``tpurec/embedding/modules.py``).

One ``SharedEmbedding`` table serves every categorical feature through its
global offset id. This is the dense single-device lookup that serving and the
dense training engine run; the JAX package's sparse, packed and ``shard_map``
branches are features of later slices.

The used-id L2 term: the JAX package ``sow``s ``used_id_l2`` of each lookup
call into the ``'regularization'`` collection when the trainer makes it
mutable (``tpurec/embedding/modules.py:183-192``), and sums the collection.
Here the trainer opens ``record_used_id_l2(model)`` around its forward: it
hands every ``SharedEmbedding`` of the model one list, and each lookup made
in training mode appends its term to it.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.ops import pad_vocab, used_id_l2
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

    def init_weights(self, generator: torch.Generator) -> None:
        uniform_(self.embedding, INIT_SCALE, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.embedding)
        if self.used_id_l2_terms is not None and self.training:
            self.used_id_l2_terms.append(used_id_l2(self.embedding, ids))
        return out if self.dtype is None else out.to(self.dtype)


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

    def __init__(self, vocab_size: int):
        super().__init__()
        self.w = SharedEmbedding(vocab_size, 1)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w(ids).squeeze(-1)
