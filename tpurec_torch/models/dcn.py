"""DCN-family feature-cross models (counterpart of ``tpurec/models/dcn.py``):
DCN (vector and matrix cross), xDeepFM, NFM, DeepCrossing, FNN, CCPM,
FGCNN, AFM, FiBiNET and AutoInt.

All take categorical features (one shared id space) and optional continuous
features: DCN, DeepCrossing and FNN concatenate them to their dense input,
AutoInt scales a learned embedding by each (``cont_emb``), the others leave
them out, as the JAX models do. Child modules keep the flax names (``emb``,
``cross``, ``deep``, ``cin``, ``bn``, ``res_{i}``, ``ccpm``, ``fgcnn``,
``afm``, ``mha_{i}``...), so weights map across by path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.ops.attention import MultiHeadAttention
from tpurec_torch.ops.conv import CCPM, FGCNN, ResidualBlock
from tpurec_torch.ops.interactions import (
    CIN,
    AFMInteraction,
    BilinearInteraction,
    CrossNetwork,
    CrossNetworkMatrix,
    SENet,
    SENetBilinear,
    fm_second_order,
)
from tpurec_torch.ops.mlp import MLP, BatchNorm, Dense


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


class NFM(_EmbedBase):
    """Neural FM: linear term + ``head``(``mlp``(``bn``(bi-interaction))).
    The bi-interaction pooling is the (B, D) FM cross before its sum over d;
    ``bn`` is flax's default ``nn.BatchNorm`` (scale, bias, eps 1e-5), whose
    fp32 output feeds the MLP."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        self.w = LinearEmbedding(vocab_size)
        self.bn = BatchNorm(embed_dim)
        self.mlp = MLP(embed_dim, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        linear = self.w(ids).sum(dim=1)
        bi = self.bn(fm_second_order(self.emb(ids), reduce_dim=False))
        return binary_output(linear + self.head(self.mlp(bi)).reshape(-1))


class DeepCrossing(_EmbedBase):
    """``num_blocks`` residual units (``res_{i}``, hidden ``residual_dim``)
    over the dense input → ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
        num_blocks: int = 3,
        residual_dim: int = 64,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        width = self.num_fields * embed_dim + len(self.continuous_names)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"res_{i}", ResidualBlock(width, residual_dim, dtype))
        self.head = Dense(width, 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.dense_input(inputs)
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i}")(x)
        return binary_output(self.head(x))


class FNN(_EmbedBase):
    """FM-initialised NN: dense input → ``mlp`` → ``head``. The table is a
    trainable parameter that ``init_embedding_from_fm`` can seed from a
    trained FM."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        width = self.num_fields * embed_dim + len(self.continuous_names)
        self.mlp = MLP(width, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        return binary_output(self.head(self.mlp(self.dense_input(inputs))))

    @staticmethod
    def init_embedding_from_fm(fnn_state: Dict[str, torch.Tensor],
                               fm_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A copy of an FNN ``state_dict`` whose table is a trained FM's
        2nd-order table ``v``, as the JAX static method does on param trees."""
        out = dict(fnn_state)
        out["emb.embedding"] = fm_state["v.embedding"]
        return out


class CCPMModel(_EmbedBase):
    """``ccpm`` (conv + k-max-pool levels over the fields) → ``mlp`` →
    ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
        num_filters: Sequence[int] = (4, 4),
        kernel_widths: Sequence[int] = (6, 5),
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        self.ccpm = CCPM(self.num_fields, embed_dim, num_filters, kernel_widths, dtype)
        self.mlp = MLP(self.ccpm.out_features, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        return binary_output(self.head(self.mlp(self.ccpm(self.embed(inputs)))))


class FGCNNModel(_EmbedBase):
    """``fgcnn``'s generated features beside the raw embeddings; [all fields
    flattened ∥ their bi-interaction] → ``mlp`` → ``head``."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
        num_filters: Sequence[int] = (8, 10),
        kernel_widths: Sequence[int] = (7, 7),
        pool_widths: Sequence[int] = (2, 2),
        new_maps: Sequence[int] = (3, 3),
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        self.fgcnn = FGCNN(self.num_fields, embed_dim, num_filters, kernel_widths, pool_widths,
                           new_maps, dtype)
        width = (self.num_fields + self.fgcnn.out_fields + 1) * embed_dim
        self.mlp = MLP(width, hidden_dims, dtype=dtype)
        self.head = Dense(hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.embed(inputs)
        all_fields = torch.cat([emb, self.fgcnn(emb)], dim=1)
        cross = fm_second_order(all_fields, reduce_dim=False)
        x = torch.cat([all_fields.reshape(emb.shape[0], -1), cross], dim=-1)
        return binary_output(self.head(self.mlp(x)))


class AFM(_EmbedBase):
    """Attentional FM: linear term + ``p`` (no bias) of ``afm``'s
    attention-pooled pair products."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
        attention_dim: int = 16,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        self.w = LinearEmbedding(vocab_size)
        self.afm = AFMInteraction(embed_dim, attention_dim, dtype)
        self.p = Dense(embed_dim, 1, dtype, use_bias=False)

    def forward(self, inputs: Inputs) -> Outputs:
        ids = stack_ids(inputs, self.feature_names)
        linear = self.w(ids).sum(dim=1)
        return binary_output(linear + self.p(self.afm(self.emb(ids))).reshape(-1))


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


class AutoInt(_EmbedBase):
    """``num_attention_layers`` multi-head self-attention layers
    (``mha_{i}``) over the field embeddings → ``head``. Each continuous
    feature becomes a field of its own: its value times a learned
    embedding, a row of ``cont_emb`` (C, D), fp32, glorot uniform."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        dtype: Optional[torch.dtype] = None,
        num_attention_layers: int = 2,
        num_heads: int = 2,
        head_dim: int = 8,
    ):
        super().__init__(feature_names, vocab_size, continuous_names, embed_dim, dtype)
        n_cont = len(self.continuous_names)
        self.cont_emb = nn.Parameter(torch.empty(n_cont, embed_dim)) if n_cont else None
        self.num_attention_layers = num_attention_layers
        for i in range(num_attention_layers):
            self.add_module(f"mha_{i}", MultiHeadAttention(embed_dim, num_heads, head_dim, dtype=dtype))
        self.head = Dense((self.num_fields + n_cont) * embed_dim, 1, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.cont_emb is not None:
            glorot_uniform_(self.cont_emb, generator)

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.embed(inputs)
        cont = stack_continuous(inputs, self.continuous_names)
        if cont is not None:
            scaled = cont[..., None].to(x.dtype) * self.cont_emb.to(x.dtype)[None]
            x = torch.cat([x, scaled], dim=1)
        for i in range(self.num_attention_layers):
            x = getattr(self, f"mha_{i}")(x)
        return binary_output(self.head(x.reshape(x.shape[0], -1)))
