"""Collaborative filtering: MatrixCF and NCF (counterpart of
``tpurec/models/matrixcf.py``). Both read the ``user_id`` and ``item_id``
columns of the shared id space; child modules keep the flax names."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.models.base import Inputs, Outputs, binary_output, cosine_similarity
from tpurec_torch.ops.mlp import MLP, Dense


class MatrixCF(nn.Module):
    """One table ``emb`` shared by users and items; the output is their
    cosine mapped to [0, 1]. There is no ``logit``, so ``bce`` trains on the
    clipped output, as in the JAX package."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 16,
        user_key: str = "user_id",
        item_key: str = "item_id",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.user_key, self.item_key = user_key, item_key
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        u = self.emb(inputs[self.user_key].reshape(-1))
        i = self.emb(inputs[self.item_key].reshape(-1))
        sim = cosine_similarity(u.to(torch.float32), i.to(torch.float32))
        return {"output": 0.5 * (sim + 1.0), "user_embedding": u, "item_embedding": i}


class NCF(nn.Module):
    """Neural CF: the GMF path (``mf_emb``, user ∘ item) beside the MLP path
    (``mlp_emb``, [user ∥ item] → ``mlp``), concatenated → Dense(1)
    ``head`` → sigmoid."""

    def __init__(
        self,
        vocab_size: int,
        mf_dim: int = 16,
        mlp_dim: int = 16,
        hidden_dims: Sequence[int] = (64, 32, 16),
        user_key: str = "user_id",
        item_key: str = "item_id",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.user_key, self.item_key = user_key, item_key
        self.mf_emb = SharedEmbedding(vocab_size, mf_dim, dtype=dtype)
        self.mlp_emb = SharedEmbedding(vocab_size, mlp_dim, dtype=dtype)
        self.mlp = MLP(2 * mlp_dim, hidden_dims, dtype=dtype)
        self.head = Dense(mf_dim + hidden_dims[-1], 1, dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        u_ids = inputs[self.user_key].reshape(-1)
        i_ids = inputs[self.item_key].reshape(-1)
        gmf = self.mf_emb(u_ids) * self.mf_emb(i_ids)
        h = self.mlp(torch.cat([self.mlp_emb(u_ids), self.mlp_emb(i_ids)], dim=-1))
        return binary_output(self.head(torch.cat([gmf, h], dim=-1)))
