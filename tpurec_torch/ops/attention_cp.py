"""Context-parallel (sequence-sharded) attention (counterpart of
``tpurec/ops/attention_cp.py``).

A history too long for one device is split over the 'model' axis: each rank
holds L / n of the steps and the collectives finish the pooling. At recsys
lengths one all-reduce beats a ring schedule, so these are the two-pass
forms:

- ``din_attention_cp``: the DIN activation unit's scores are unnormalised,
  so each rank pools its own steps with kernel #4 (``DinAttention``: #4
  forward, #5 backward on the card, their plain versions on the CPU) and
  one sum over the axis finishes the pool;
- ``softmax_attention_cp``: masked scaled-dot pooling with one query per
  row: the global max over the axis, then sums of the exp-weighted
  numerator and denominator.

Each rank passes its own steps (the JAX functions take the whole arrays and
``shard_map`` splits them). The query and the weights are the same on every
rank, and their gradients are summed over the axis (``replicated_input``);
a rank's keys, values and mask are its own, and so are their gradients.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpurec_torch.core.collectives import pmax, psum, replicated_input
from tpurec_torch.core.mesh import MODEL_AXIS, MeshContext
from tpurec_torch.ops.kernels import DinAttention


def din_attention_cp(
    query: torch.Tensor,  # (B, D), alike on every rank of the axis
    keys: torch.Tensor,  # (B, L / n, D): this rank's steps
    mask: torch.Tensor,  # (B, L / n)
    w1: torch.Tensor,  # (4D, H)
    b1: torch.Tensor,  # (H,)
    w2: torch.Tensor,  # (H,)
    alpha: Optional[torch.Tensor],  # (H,) PReLU slopes, or None for relu
    mesh: MeshContext,
    axis: str = MODEL_AXIS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-sharded DIN target attention: (pooled (B, D) fp32, alike on
    every rank; this rank's scores (B, L / n) fp32)."""
    group = mesh.group(axis)
    q, w1, b1, w2 = (replicated_input(t, group) for t in (query, w1, b1, w2))
    if alpha is not None:
        alpha = replicated_input(alpha, group)
    pooled, scores = DinAttention.apply(q, keys, mask, w1, b1, w2, alpha)
    return psum(pooled, group), scores


def softmax_attention_cp(
    query: torch.Tensor,  # (B, D)
    keys: torch.Tensor,  # (B, L / n, D): this rank's steps
    values: torch.Tensor,  # (B, L / n, Dv)
    mask: torch.Tensor,  # (B, L / n)
    mesh: MeshContext,
    axis: str = MODEL_AXIS,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-sharded masked softmax pooling: (B, Dv) in ``values``'
    dtype, alike on every rank. A row with no valid step on any rank gives
    zeros."""
    group = mesh.group(axis)
    s = scale if scale is not None else 1.0 / float(keys.shape[-1]) ** 0.5
    q = replicated_input(query.to(torch.float32), group)
    valid = mask.bool()
    logits = torch.einsum("bd,bld->bl", q, keys.to(torch.float32)) * s
    logits = torch.where(valid, logits, -torch.inf)
    gmax = pmax(logits.max(dim=-1).values, group)
    gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
    w = torch.where(valid, torch.exp(logits - gmax[:, None]), 0.0)
    num = psum(torch.einsum("bl,bld->bd", w, values.to(torch.float32)), group)
    den = psum(w.sum(dim=-1), group)
    return (num / den.clamp_min(1e-9)[:, None]).to(values.dtype)
