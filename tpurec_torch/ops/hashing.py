"""Locality-sensitive hashing ops (counterpart of ``tpurec/ops/hashing.py``):
SimHash codes, Hamming top-k retrieval, LSH bucketed attention, SDIM's
multi-group sketch pooling, and ``gather_steps``.

The JAX package computes these in XLA (no Pallas kernel), so they are plain
PyTorch here on every device. A code keeps only the sign of an fp32 product
(``> 0``, so a product of exactly 0 gives bit 0): two devices that sum the
product in different orders can flip the bit of a product within rounding
of 0. Top-k uses ``tpurec_torch.ops.topk.top_k`` (``lax.top_k``'s order:
the lower index first among equal values), never ``torch.topk``; Hamming
similarities are small integers, so ties are the rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpurec_torch.initializers import jax_normal
from tpurec_torch.ops.topk import top_k


def simhash_bits(x: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Sign bits of random projections: (..., D) × (D, n_bits) → (...,
    n_bits) int32 in {0, 1}, 1 where the product is > 0."""
    return (torch.einsum("...d,db->...b", x, projection) > 0).to(torch.int32)


def hamming_similarity(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """The number of equal bits between (B, n) query codes and (B, L, n)
    sequence codes → (B, L) int32."""
    return (a_bits[:, None, :] == b_bits).sum(dim=-1, dtype=torch.int32)


def topk_select(
    scores: torch.Tensor,  # (B, L), higher is better
    mask: torch.Tensor,  # (B, L), 1 = valid
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (B, k) int32, selection mask (B, k) fp32) of the k best valid
    steps: an invalid step scores −inf, so it ranks below every valid one and
    its pick gets 0 in the mask; a row with no valid step returns the first
    k steps, all with mask 0 (``lax.top_k``'s order)."""
    neg = torch.where(mask.to(torch.bool), scores.to(torch.float32), -torch.inf)
    top_vals, top_idx = top_k(neg, k)
    return top_idx.to(torch.int32), torch.isfinite(top_vals).to(torch.float32)


def gather_steps(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (B, k, ...) steps of ``seq`` (B, L, ...) at the per-row indices
    ``idx`` (B, k), as ``jnp.take_along_axis`` along axis 1."""
    idx = idx.to(torch.int64).reshape(idx.shape + (1,) * (seq.dim() - 2))
    return torch.take_along_dim(seq, idx, dim=1)


def lsh_bucket_ids(x: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Bucket id of each step, its SimHash bits packed little-endian: (B, L,
    D) → (B, L) int32 in [0, 2^n_bits)."""
    bits = simhash_bits(x, projection)
    weights = 2 ** torch.arange(bits.shape[-1], device=bits.device, dtype=torch.int32)
    return (bits * weights).sum(dim=-1, dtype=torch.int32)


def lsh_attention(
    q: torch.Tensor,  # (B, L, D), shared queries and keys as in Reformer
    v: torch.Tensor,  # (B, L, Dv)
    projection: torch.Tensor,  # (D, n_bits)
    mask: Optional[torch.Tensor] = None,  # (B, L)
) -> torch.Tensor:
    """Bucketed attention: a step attends only to the steps of its own LSH
    bucket (and, with ``mask``, only valid steps from valid steps), through
    a (B, L, L) equality mask, −1e9 on the other logits, a softmax in fp32
    and the weights in v's dtype."""
    buckets = lsh_bucket_ids(q, projection)
    same = buckets[:, :, None] == buckets[:, None, :]
    if mask is not None:
        valid = mask.to(torch.bool)
        same = same & valid[:, None, :] & valid[:, :, None]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))  # JAX's fp32 value
    logits = torch.einsum("bld,bmd->blm", q, q).to(torch.float32) * scale
    logits = torch.where(same, logits, -1e9)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("blm,bmd->bld", w.to(v.dtype), v)


def sketch_pool(
    seq: torch.Tensor,  # (B, L, D) behavior embeddings
    mask: torch.Tensor,  # (B, L)
    projections: torch.Tensor,  # (G, D, n_bits), one per hash group
    query: torch.Tensor,  # (B, D) target embedding
) -> torch.Tensor:
    """SDIM's multi-group sketch pooling → (B, D): in each hash group, the
    mean of the valid steps whose bucket is the query's (a denominator of at
    least 1, so a row with no hit pools 0); then the mean over the G
    groups (a loop over the groups where the JAX package ``vmap``s)."""
    pooled = []
    for proj in projections:
        hit = (lsh_bucket_ids(seq, proj) == lsh_bucket_ids(query, proj)[:, None]).to(torch.float32) * mask
        denom = hit.sum(dim=-1, keepdim=True).clamp_min(1.0)
        pooled.append(torch.einsum("bl,bld->bd", (hit / denom).to(seq.dtype), seq))
    return torch.stack(pooled).mean(dim=0)


def make_projections(seed: int, num_groups: int, dim: int, n_bits: int) -> torch.Tensor:
    """(G, D, n_bits) fp32: ``jax.random.normal(jax.random.key(seed), (G, D,
    n_bits))`` (``initializers.jax_normal``, within a few ulp of JAX's)."""
    n = num_groups * dim * n_bits
    return torch.tensor(jax_normal(seed, n).reshape(num_groups, dim, n_bits))
