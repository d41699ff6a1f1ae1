"""FM family: FM, DSSM two-tower retrieval and DeepFM (counterpart of
``tpurec/models/fm.py``). The other FM-family models come in a later slice."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.modules import LinearEmbedding, SharedEmbedding
from tpurec_torch.models.base import (
    Inputs,
    Outputs,
    binary_output,
    cosine_similarity,
    stack_ids,
)
from tpurec_torch.ops.interactions import fm_second_order
from tpurec_torch.ops.mlp import MLP, Dense


class FM(nn.Module):
    """Factorization Machine: bias + order-1 w-embedding + ½((Σv)²−Σv²)."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.bias = nn.Parameter(torch.empty(()))
        self.w = LinearEmbedding(vocab_size)
        self.v = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        emb = self.v(ids)
        logit = self.bias + self.w(ids).sum(dim=1) + fm_second_order(emb, self.training)
        return binary_output(logit) | {"embeddings": emb}


class DSSMTower(nn.Module):
    """One DSSM tower: embed → flatten → MLP → projection."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.mlp = MLP(len(self.feature_names) * embed_dim, hidden_dims, dtype=dtype)
        self.proj = Dense(hidden_dims[-1], output_dim, dtype=dtype)

    def forward(self, inputs: Inputs) -> torch.Tensor:
        emb = self.emb(stack_ids(inputs, self.feature_names))
        return self.proj(self.mlp(emb.reshape(emb.shape[0], -1)))


class DSSMTwoTowerRetrieval(nn.Module):
    """Two-tower retrieval: cosine(u, i) mapped to [0, 1], a learned
    temperature and bias for the logit, and the tower embeddings for the
    offline indexer."""

    def __init__(
        self,
        user_features: Sequence[str],
        item_features: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        output_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        common = dict(
            vocab_size=vocab_size, embed_dim=embed_dim, hidden_dims=hidden_dims,
            output_dim=output_dim, dtype=dtype,
        )
        self.u_tower = DSSMTower(feature_names=user_features, **common)
        self.i_tower = DSSMTower(feature_names=item_features, **common)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_bias = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.logit_scale, 2.0)
        nn.init.zeros_(self.logit_bias)

    def forward(self, inputs: Inputs) -> Outputs:
        u = self.u_tower(inputs)
        i = self.i_tower(inputs)
        sim = cosine_similarity(u.to(torch.float32), i.to(torch.float32))
        return {
            "output": 0.5 * (sim + 1.0),
            "logit": F.softplus(self.logit_scale) * sim + self.logit_bias,
            "user_embedding": u,
            "item_embedding": i,
        }

    def user_embedding(self, inputs: Inputs) -> torch.Tensor:
        return self.u_tower(inputs)

    def item_embedding(self, inputs: Inputs) -> torch.Tensor:
        return self.i_tower(inputs)


class DeepFM(nn.Module):
    """FM logit + deep MLP logit on the flattened embeddings, summed →
    sigmoid."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.bias = nn.Parameter(torch.empty(()))
        self.w = LinearEmbedding(vocab_size)
        self.v = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.deep = MLP(len(self.feature_names) * embed_dim, hidden_dims, dtype=dtype)
        self.deep_head = Dense(hidden_dims[-1], 1, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        emb = self.v(ids)
        fm_logit = self.bias + self.w(ids).sum(dim=1) + fm_second_order(emb, self.training)
        deep_logit = self.deep_head(self.deep(emb.reshape(emb.shape[0], -1)))
        return binary_output(fm_logit + deep_logit.reshape(-1))
