"""FM family (counterpart of ``tpurec/models/fm.py``): FM, DSSM (single
tower and two-tower retrieval), DeepFM, Wide&Deep, FFM, FwFM, PNN (inner
and outer) and ONN. Child modules keep the flax names (``w``, ``v``,
``emb``, ``fa``, ``tower``, ``mlp``, ``product``, ``fwfm``...), so weights
map across by path."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.modules import (
    FieldAwareEmbedding,
    LinearEmbedding,
    SharedEmbedding,
)
from tpurec_torch.models.base import (
    Inputs,
    Outputs,
    binary_output,
    cosine_similarity,
    stack_continuous,
    stack_ids,
)
from tpurec_torch.ops.interactions import (
    FwFMInteraction,
    InnerProductTower,
    OuterProductTower,
    field_aware_products,
    fm_second_order,
)
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


class DSSMSingleRanking(nn.Module):
    """Single-tower ranking head over all features: a ``DSSMTower`` whose
    projection is as wide as the MLP's last layer, relu, then a Dense(1)
    ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.tower = DSSMTower(
            feature_names, vocab_size, embed_dim, hidden_dims, hidden_dims[-1], dtype
        )
        self.head = Dense(hidden_dims[-1], 1, dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        return binary_output(self.head(torch.relu(self.tower(inputs))))


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


class WideAndDeep(nn.Module):
    """Wide (a Dense(1) over the continuous features; 0 without any) + deep
    (embeddings → MLP → Dense(1)) logits, summed → sigmoid."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.continuous_names = list(continuous_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.deep = MLP(len(self.feature_names) * embed_dim, hidden_dims, dtype=dtype)
        self.deep_head = Dense(hidden_dims[-1], 1, dtype=dtype)
        self.wide = (
            Dense(len(self.continuous_names), 1, dtype=dtype) if self.continuous_names else None
        )

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.emb(stack_ids(inputs, self.feature_names))
        logit = self.deep_head(self.deep(emb.reshape(emb.shape[0], -1))).reshape(-1)
        cont = stack_continuous(inputs, self.continuous_names)
        if cont is not None:
            logit = logit + self.wide(cont).reshape(-1)
        return binary_output(logit)


class FFM(nn.Module):
    """Field-aware FM: bias + order-1 w-embedding + Σ_{i<j} <v_{i,j},
    v_{j,i}> over a ``FieldAwareEmbedding`` ``v``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 4,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.bias = nn.Parameter(torch.empty(()))
        self.w = LinearEmbedding(vocab_size)
        self.v = FieldAwareEmbedding(vocab_size, len(self.feature_names), embed_dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        cross = field_aware_products(self.v(ids)).sum(dim=(1, 2))
        return binary_output(self.bias + self.w(ids).sum(dim=1) + cross)


class FwFM(nn.Module):
    """Field-weighted FM: bias + order-1 w-embedding + a learned weight per
    field pair on the shared embedding's inner products (``fwfm``)."""

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
        self.fwfm = FwFMInteraction(len(self.feature_names))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        cross = self.fwfm(self.v(ids))
        return binary_output(self.bias + self.w(ids).sum(dim=1) + cross)


class PNN(nn.Module):
    """Product-based NN: [flattened embeddings ∥ inner products, or outer
    products through a ``kernel_type`` kernel] (``product``) → MLP →
    Dense(1) ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        product_type: str = "inner",
        kernel_type: str = "mat",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        f = len(self.feature_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        if product_type == "inner":
            self.product = InnerProductTower()
        else:
            self.product = OuterProductTower(f, embed_dim, kernel_type)
        self.mlp = MLP(f * embed_dim + f * (f - 1) // 2, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        sig = self.product(self.emb(stack_ids(inputs, self.feature_names)))
        return binary_output(self.head(self.mlp(sig)))


class ONN(nn.Module):
    """Operation-aware NN (NFFM): the field-aware pair products (``fa``)
    concatenated with the flattened shared embeddings (``emb``) → MLP →
    Dense(1) ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        embed_dim: int = 4,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        f = len(self.feature_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.fa = FieldAwareEmbedding(vocab_size, f, embed_dim, dtype=dtype)
        self.mlp = MLP(f * embed_dim + f * (f - 1) // 2 * embed_dim, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        b = ids.shape[0]
        pairs = field_aware_products(self.fa(ids)).reshape(b, -1)
        sig = torch.cat([self.emb(ids).reshape(b, -1), pairs], dim=-1)
        return binary_output(self.head(self.mlp(sig)))
