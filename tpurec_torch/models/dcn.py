"""DCN-family feature-cross models (counterpart of ``tpurec/models/dcn.py``):
DCN (vector and matrix cross), xDeepFM and FiBiNET. The file's other models
(NFM, DeepCrossing, FNN, CCPM, FGCNN, AFM, AutoInt) come in a later slice.

All take categorical features (one shared id space) and optional continuous
features, which DCN concatenates to its dense input. Child modules keep the
flax names (``emb``, ``cross``, ``deep``, ``cin``, ``senet_bilinear``...), so
weights map across by path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpurec_torch.embedding.modules import LinearEmbedding, SharedEmbedding
from tpurec_torch.models.base import (
    Inputs,
    Outputs,
    binary_output,
    stack_continuous,
    stack_ids,
)
from tpurec_torch.ops.interactions import (
    CIN,
    BilinearInteraction,
    CrossNetwork,
    CrossNetworkMatrix,
    SENet,
    SENetBilinear,
)
from tpurec_torch.ops.mlp import MLP, Dense


class _EmbedBase(nn.Module):
    """The field embedding ``emb`` and the flattened dense input shared by
    the family (not registered itself)."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.continuous_names = list(continuous_names)
        self.num_fields = len(self.feature_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def embed(self, inputs: Inputs) -> torch.Tensor:
        return self.emb(stack_ids(inputs, self.feature_names))

    def dense_input(self, inputs: Inputs) -> torch.Tensor:
        """[flattened embeddings ∥ continuous features], (B, F·D + C)."""
        emb = self.embed(inputs)
        parts = [emb.reshape(emb.shape[0], -1)]
        cont = stack_continuous(inputs, self.continuous_names)
        if cont is not None:
            parts.append(cont.to(parts[0].dtype))
        return torch.cat(parts, dim=-1)


class DCN(_EmbedBase):
    """Deep & Cross: cross tower ∥ deep tower → ``head``. ``cross_type``
    'vector' (DCN, ``CrossNetwork``: kernel #2 at inference) or 'matrix'
    (DCN-v2, ``CrossNetworkMatrix``)."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
        cross_type: str = "vector",
        num_cross_layers: int = 3,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        width = self.num_fields * embed_dim + len(self.continuous_names)
        if cross_type == "vector":
            self.cross = CrossNetwork(width, num_cross_layers)
        else:
            self.cross = CrossNetworkMatrix(width, num_cross_layers, dtype)
        self.deep = MLP(width, hidden_dims, dtype=dtype)
        self.head = Dense(width + hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        x0 = self.dense_input(inputs)
        logit = self.head(torch.cat([self.cross(x0), self.deep(x0)], dim=-1))
        return binary_output(logit)


class XDeepFM(_EmbedBase):
    """Linear term + CIN (kernel #3 at inference) + deep MLP, summed logits.
    Continuous features are not used (as in the JAX model)."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
        cin_layer_sizes: Sequence[int] = (64, 64),
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        self.w = LinearEmbedding(vocab_size)
        self.cin = CIN(self.num_fields, tuple(cin_layer_sizes), dtype)
        self.cin_head = Dense(sum(cin_layer_sizes), 1, dtype)
        self.deep = MLP(self.num_fields * embed_dim, hidden_dims, dtype=dtype)
        self.deep_head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        emb = self.emb(ids)
        linear = self.w(ids).sum(dim=1)
        cin_logit = self.cin_head(self.cin(emb)).reshape(-1)
        deep = self.deep(emb.reshape(emb.shape[0], -1))
        deep_logit = self.deep_head(deep).reshape(-1)
        return binary_output(linear + cin_logit + deep_logit)


class FiBiNet(_EmbedBase):
    """Bilinear interactions of the raw embeddings (``bilinear_raw``) and of
    the SENet-reweighted ones → MLP → ``head``. In 'all' mode the second is
    ``senet_bilinear`` (kernel #6 at inference); otherwise ``senet`` then
    ``bilinear_se``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
        bilinear_mode: str = "all",
        reduction: int = 3,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        f, d = self.num_fields, embed_dim
        self.bilinear_mode = bilinear_mode
        self.bilinear_raw = BilinearInteraction(f, d, bilinear_mode)
        if bilinear_mode == "all":
            self.senet_bilinear = SENetBilinear(f, d, reduction)
        else:
            self.senet = SENet(f, reduction, dtype)
            self.bilinear_se = BilinearInteraction(f, d, bilinear_mode)
        pairs = f * (f - 1) // 2
        self.mlp = MLP(2 * pairs * d, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.embed(inputs)
        b = emb.shape[0]
        p1 = self.bilinear_raw(emb)
        if self.bilinear_mode == "all":
            p2 = self.senet_bilinear(emb)
        else:
            p2 = self.bilinear_se(self.senet(emb))
        x = torch.cat([p1.reshape(b, -1), p2.reshape(b, -1)], dim=-1)
        return binary_output(self.head(self.mlp(x)))
