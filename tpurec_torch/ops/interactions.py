"""Feature-interaction ops (counterpart of ``tpurec/ops/interactions.py``):
the FM cross term and NFM's bi-interaction, the FM family's pair products
(pairwise, inner, outer, field-aware), ``FwFMInteraction``,
``AFMInteraction`` and PNN's product towers, and the DCN-family modules
(DCN vector and matrix cross, CIN, SENet, bilinear interactions,
SENet-bilinear). ``emb`` is (B, F, D); pairs are the i<j field pairs
in ``np.triu_indices`` order, P = F(F−1)/2. The pair products are plain
tensor math in the embedding's dtype, as in the JAX package (no kernel
there either).

Four of these run a kernel at inference, as the JAX package dispatches them
(``TRAIN_WINNERS`` empty, ``tpurec/ops/pallas/kernels.py:61``): the FM cross
term, ``CrossNetwork``, ``CIN`` and ``SENetBilinear``. The JAX package
reads a process-wide phase flag that its trainer sets while it traces the
train step, the one step that also applies the model with ``train=True``;
eval and inference run outside the phase. Here the calling module's
``training`` mode splits the calls the same way, without the global:
training takes the plain math, differentiated by autograd; otherwise the
fp32 wrapper of ``tpurec_torch.ops.kernels`` (the kernel for CUDA tensors,
the plain version for CPU ones), cast back.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.ops import kernels
from tpurec_torch.ops.mlp import Dense


def fm_second_order(emb: torch.Tensor, training: bool = False,
                    reduce_dim: bool = True) -> torch.Tensor:
    """FM 2nd-order cross, (B, F, D) → (B,): 0.5·Σ_d[(Σ_f v_f)² − Σ_f v_f²].

    ``training`` is the calling module's ``training`` mode (``tpurec/ops/
    interactions.py:44-48``). Training: the plain math in the embedding's
    dtype. Otherwise ``kernels.fm_second_order_fused`` in fp32, cast back to
    the embedding dtype.

    ``reduce_dim=False``: the (B, D) bi-interaction vector before the sum
    over d (NFM's and FGCNN's pooling), the plain math in the embedding's
    dtype in every mode; the JAX package never dispatches its kernel
    there either."""
    if not reduce_dim:
        return 0.5 * (torch.square(emb.sum(dim=1)) - torch.square(emb).sum(dim=1))
    if training:
        return kernels.fm_second_order_plain(emb)
    return kernels.fm_second_order_fused(emb.to(torch.float32)).to(emb.dtype)


def pair_indices(num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (i, j) index arrays of all field pairs i<j, in
    ``np.triu_indices`` order."""
    return np.triu_indices(num_fields, k=1)


@functools.lru_cache(maxsize=None)
def _pair_indices_on(num_fields: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    iu, ju = pair_indices(num_fields)
    with torch.inference_mode(False):  # usable in and out of inference mode
        return torch.as_tensor(iu, device=device), torch.as_tensor(ju, device=device)


def _pairs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pair_indices(x.shape[1])`` on ``x``'s device, copied there once a
    field count and device, then reused."""
    return _pair_indices_on(x.shape[1], x.device)


def pairwise_products(emb: torch.Tensor) -> torch.Tensor:
    """Elementwise products of all field pairs, (B, F, D) → (B, P, D)."""
    iu, ju = _pairs(emb)
    return emb[:, iu, :] * emb[:, ju, :]


def inner_products(emb: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products, (B, F, D) → (B, P): PNN's 'inner' mode."""
    return pairwise_products(emb).sum(dim=-1)


def outer_products(emb: torch.Tensor) -> torch.Tensor:
    """Pairwise outer products, (B, F, D) → (B, P, D, D): PNN's 'outer'
    mode materialised."""
    iu, ju = _pairs(emb)
    return torch.einsum("bpd,bpe->bpde", emb[:, iu, :], emb[:, ju, :])


def field_aware_products(fa_emb: torch.Tensor) -> torch.Tensor:
    """FFM's pair products from a field-aware (B, F, F, D) embedding, where
    ``fa_emb[:, i, j]`` is field i's embedding toward field j: (B, P, D),
    ``v_{i,j} ∘ v_{j,i}`` for each pair i<j (sum it for the FFM logit)."""
    iu, ju = _pairs(fa_emb)
    return fa_emb[:, iu, ju, :] * fa_emb[:, ju, iu, :]


class FwFMInteraction(nn.Module):
    """Field-weighted FM: a learned weight per field pair, ``pair_weight``
    (P,) drawn as ones, on the pairwise inner products; (B, F, D) → (B,)."""

    def __init__(self, num_fields: int):
        super().__init__()
        self.pair_weight = nn.Parameter(torch.empty(num_fields * (num_fields - 1) // 2))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.pair_weight)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        ip = inner_products(emb)
        return (ip * self.pair_weight.to(ip.dtype)).sum(dim=-1)


class AFMInteraction(nn.Module):
    """Attentional FM's pooling, (B, F, D) → (B, D): the pairwise products
    through ``proj`` (D → ``attention_dim``), relu and ``score`` (→ 1, no
    bias), a softmax over the P pairs, then the products summed with those
    weights. Computed in the module's ``dtype`` (the embedding's when None)."""

    def __init__(self, dim: int, attention_dim: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Dense(dim, attention_dim, dtype)
        self.score = Dense(attention_dim, 1, dtype, use_bias=False)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        products = pairwise_products(emb)
        a = torch.softmax(self.score(torch.relu(self.proj(products))), dim=1)
        return (a * products).sum(dim=1)


class InnerProductTower(nn.Module):
    """PNN's inner product layer: [flattened embeddings ∥ pairwise inner
    products], (B, F·D + P)."""

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return torch.cat([emb.reshape(emb.shape[0], -1), inner_products(emb)], dim=-1)


class OuterProductTower(nn.Module):
    """PNN's outer mode with a learned ``kernel`` a pair, which compresses
    each pair's (D, D) outer product to a number without materialising it:
    ``'mat'`` (P, D, D) glorot, out_p = l_p·K_p·r_p; ``'vec'`` (P, D)
    glorot, out_p = Σ_d l_pd K_pd r_pd; ``'num'`` (P,) ones, out_p =
    K_p·(l_p·r_p). The kernel is cast to the embedding's dtype and the
    products taken in it. Returns [flattened embeddings ∥ out], (B, F·D + P).

    ``kernel`` is a raw parameter used as written: the bridge loads it
    untransposed whatever its shape (not as a Dense kernel)."""

    def __init__(self, num_fields: int, dim: int, kernel_type: str = "mat"):
        super().__init__()
        p = num_fields * (num_fields - 1) // 2
        shapes = {"mat": (p, dim, dim), "vec": (p, dim), "num": (p,)}
        if kernel_type not in shapes:
            raise ValueError(f"unknown kernel_type {kernel_type!r}")
        self.kernel_type = kernel_type
        self.kernel = nn.Parameter(torch.empty(shapes[kernel_type]))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.kernel_type == "num":
            nn.init.ones_(self.kernel)
        else:
            glorot_uniform_(self.kernel, generator)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        iu, ju = _pairs(emb)
        left, right = emb[:, iu, :], emb[:, ju, :]
        k = self.kernel.to(emb.dtype)
        if self.kernel_type == "mat":
            out = torch.einsum("bpd,pde,bpe->bp", left, k, right)
        elif self.kernel_type == "vec":
            out = torch.einsum("bpd,pd,bpd->bp", left, k, right)
        else:
            out = torch.einsum("bpd,bpd->bp", left, right) * k
        return torch.cat([emb.reshape(emb.shape[0], -1), out], dim=-1)


class SENet(nn.Module):
    """Squeeze-and-excitation over fields: the mean over d → ``squeeze``
    Dense (F → max(1, F // reduction)) → relu → ``excite`` Dense (→ F) →
    relu → per-field reweighting. Returns (B, F, D)."""

    def __init__(
        self, num_fields: int, reduction: int = 3, dtype: Optional[torch.dtype] = None
    ):
        super().__init__()
        r = max(1, num_fields // reduction)
        self.squeeze = Dense(num_fields, r, dtype)
        self.excite = Dense(r, num_fields, dtype)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        a = torch.relu(self.squeeze(emb.mean(dim=-1)))
        a = torch.relu(self.excite(a))
        return emb * a[..., None]


class BilinearInteraction(nn.Module):
    """Bilinear field-pair products p_ij = (v_i·W) ∘ v_j (i<j), with the
    weight shared by all pairs (``mode='all'``, ``w`` (D, D)), one per field
    (``'each'``, (F, D, D)) or one per pair (``'interaction'``, (P, D, D)).
    Computed in the embedding's dtype. Returns (B, P, D)."""

    def __init__(self, num_fields: int, dim: int, mode: str = "all"):
        super().__init__()
        p = num_fields * (num_fields - 1) // 2
        shapes = {"all": (dim, dim), "each": (num_fields, dim, dim), "interaction": (p, dim, dim)}
        if mode not in shapes:
            raise ValueError(f"unknown bilinear mode {mode!r}")
        self.mode = mode
        self.w = nn.Parameter(torch.empty(shapes[mode]))
        iu, ju = pair_indices(num_fields)
        self.register_buffer("iu", torch.as_tensor(iu), persistent=False)
        self.register_buffer("ju", torch.as_tensor(ju), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.w, generator)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        iu, ju = self.iu, self.ju
        w = self.w.to(emb.dtype)
        if self.mode == "all":
            left = torch.einsum("bfd,de->bfe", emb, w)[:, iu, :]
        elif self.mode == "each":
            left = torch.einsum("bfd,fde->bfe", emb, w)[:, iu, :]
        else:
            left = torch.einsum("bpd,pde->bpe", emb[:, iu, :], w)
        return left * emb[:, ju, :]


class SENetBilinear(nn.Module):
    """SENet reweighting followed by 'all'-mode bilinear pair products as one
    op, FiBiNET's hot path; the parameters of ``SENet`` + ``BilinearInteraction
    ('all')`` as raw arrays: ``squeeze_kernel`` (F, R), ``squeeze_bias`` (R,),
    ``excite_kernel`` (R, F), ``excite_bias`` (F,), ``w`` (D, D), used as
    ``z @ squeeze_kernel`` (not transposed like a Dense weight). Computed in
    fp32 and cast to the embedding's dtype: the plain math in training, the
    kernel otherwise (``tpurec/ops/interactions.py:155-191``). Returns
    (B, P, D)."""

    def __init__(self, num_fields: int, dim: int, reduction: int = 3):
        super().__init__()
        r = max(1, num_fields // reduction)
        self.squeeze_kernel = nn.Parameter(torch.empty(num_fields, r))
        self.squeeze_bias = nn.Parameter(torch.empty(r))
        self.excite_kernel = nn.Parameter(torch.empty(r, num_fields))
        self.excite_bias = nn.Parameter(torch.empty(num_fields))
        self.w = nn.Parameter(torch.empty(dim, dim))

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.squeeze_kernel, self.excite_kernel, self.w):
            glorot_uniform_(p, generator)
        nn.init.zeros_(self.squeeze_bias)
        nn.init.zeros_(self.excite_bias)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        fn = kernels.senet_bilinear_plain if self.training else kernels.senet_bilinear_fused
        out = fn(
            emb.to(torch.float32), self.squeeze_kernel, self.excite_kernel, self.w,
            self.squeeze_bias, self.excite_bias,
        )
        return out.to(emb.dtype)


class CrossNetwork(nn.Module):
    """DCN vector cross, x_{l+1} = x0·(x_l·w_l) + b_l + x_l, with ``w_{i}``
    (D, 1) and ``b_{i}`` (D,). Training: the plain recurrence in x0's dtype
    (the compute dtype). Otherwise ``kernels.cross_network_fused`` over the
    stacked (L, D) weights in fp32, cast back to x0's dtype
    (``tpurec/ops/interactions.py:216-229``)."""

    def __init__(self, dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w_{i}", nn.Parameter(torch.empty(dim, 1)))
            self.register_parameter(f"b_{i}", nn.Parameter(torch.empty(dim)))

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(self.num_layers):
            glorot_uniform_(getattr(self, f"w_{i}"), generator)
            nn.init.zeros_(getattr(self, f"b_{i}"))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        ws = [getattr(self, f"w_{i}") for i in range(self.num_layers)]
        bs = [getattr(self, f"b_{i}") for i in range(self.num_layers)]
        if not self.training:
            w_stack = torch.cat([w.T for w in ws], dim=0)  # (L, D)
            out = kernels.cross_network_fused(x0.to(torch.float32), w_stack, torch.stack(bs))
            return out.to(x0.dtype)
        x = x0
        for w, b in zip(ws, bs):
            x = x0 * (x @ w.to(x.dtype)) + b.to(x.dtype) + x
        return x


class CrossNetworkMatrix(nn.Module):
    """DCN-v2 matrix cross, x_{l+1} = x0 ∘ (W_l x_l + b_l) + x_l, with one
    ``dense_{i}`` Dense (D → D) a layer, in the compute dtype."""

    def __init__(self, dim: int, num_layers: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"dense_{i}", Dense(dim, dim, dtype))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"dense_{i}")(x) + x
        return x


class CIN(nn.Module):
    """Compressed interaction network (xDeepFM): level l maps are
    compressions, by ``compress_{l}`` (H_l·F, S_l), of the outer products
    between level l−1's maps and the raw fields; returns the concatenated sums
    over d of every level, (B, ΣS_l). Computed in fp32 and cast to ``dtype``
    (else the embedding's): the plain math in training, the kernel otherwise
    (``tpurec/ops/interactions.py:264-291``). The kernel takes any level
    size; the JAX package dispatches its TPU kernel only for multiples of 128
    (a lane rule of its compiler), the same fp32 function."""

    def __init__(
        self,
        num_fields: int,
        layer_sizes: Sequence[int] = (128, 128),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.layer_sizes = tuple(layer_sizes)
        self.dtype = dtype
        h = num_fields
        for i, size in enumerate(self.layer_sizes):
            self.register_parameter(f"compress_{i}", nn.Parameter(torch.empty(h * num_fields, size)))
            h = size

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(len(self.layer_sizes)):
            glorot_uniform_(getattr(self, f"compress_{i}"), generator)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        weights = [getattr(self, f"compress_{i}") for i in range(len(self.layer_sizes))]
        fn = kernels.cin_plain if self.training else kernels.cin_fused
        return fn(emb.to(torch.float32), weights).to(self.dtype or emb.dtype)
