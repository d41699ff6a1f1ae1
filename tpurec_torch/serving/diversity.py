"""Aggregate-diversity greedy retrieval, ComiRec's serving path (counterpart
of ``tpurec/serving/diversity.py``): from the per-interest item scores, pick
k items one at a time, each maximising ``score + λ·(category novelty)``, so
the slate trades relevance against category coverage.

On the device, for a batch of U users at once: k steps of an argmax over a
(U, N) objective, with a taken mask and a mask of the categories seen so
far. ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does:
ties decide slates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.serving.indexer import l2_normalize


def greedy_slates(
    capsule_scores: torch.Tensor,  # (U, K, N) per-interest item scores
    item_categories: torch.Tensor,  # (N,) int category per item
    k: int,
    diversity_weight: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy of ``tpurec/serving/diversity.py:25-57`` for U users at
    once: ((U, k) item indices, (U, k) their best-capsule scores)."""
    flat = capsule_scores.to(torch.float32).amax(dim=1)  # (U, N)
    u = flat.shape[0]
    values, cat_idx = torch.unique(item_categories, return_inverse=True)
    # the JAX greedy starts from k chosen categories of -1: a category -1
    # counts as seen before the first pick
    seen = (values == -1)[None, :].repeat(u, 1)  # (U, C)
    taken = torch.zeros_like(flat, dtype=torch.bool)
    rows = torch.arange(u, device=flat.device)
    picks = []
    for _ in range(k):
        novelty = 1.0 - seen[:, cat_idx].to(torch.float32)
        objective = flat + diversity_weight * novelty
        objective = objective.masked_fill(taken, -torch.inf)
        pick = objective.argmax(dim=1)
        taken[rows, pick] = True
        seen[rows, cat_idx[pick]] = True
        picks.append(pick)
    idx = torch.stack(picks, dim=1) if picks else flat.new_zeros((u, 0), dtype=torch.long)
    return idx, flat.gather(1, idx)


def greedy_diverse_topk(
    capsule_scores: torch.Tensor,  # (K, N)
    item_categories: torch.Tensor,  # (N,)
    k: int,
    diversity_weight: float = 0.1,
) -> torch.Tensor:
    """One user's greedy slate (``tpurec/serving/diversity.py:25-57``):
    (k,) item indices."""
    return greedy_slates(capsule_scores[None], item_categories, k, diversity_weight)[0][0]


def diverse_topk(
    user_capsules,  # (U, K, D) interest capsules or (U, D) vectors
    item_embeddings,  # (N, D)
    k: int,
    item_categories,  # (N,) int category ids
    diversity_weight: float = 0.1,
    normalize: bool = True,
    batch_size: int = 1024,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Diversity-greedy retrieval over the whole corpus for every user
    (``tpurec/serving/diversity.py:71-114``): (indices (U, k), scores
    (U, k)) as numpy; the scores are the chosen items' plain best-capsule
    scores (cosine if ``normalize``)."""
    dev = resolve_device(device)
    corpus = torch.as_tensor(np.asarray(item_embeddings), dtype=torch.float32, device=dev)
    if normalize:
        corpus = l2_normalize(corpus)
    cats = torch.as_tensor(np.asarray(item_categories), device=dev)
    caps = np.asarray(user_capsules, np.float32)
    if caps.ndim == 2:
        caps = caps[:, None, :]  # single-vector towers: K = 1
    all_idx, all_val = [], []
    with torch.inference_mode():
        for start in range(0, len(caps), batch_size):
            q = torch.as_tensor(caps[start : start + batch_size], device=dev)
            if normalize:
                q = l2_normalize(q)
            idx, vals = greedy_slates(torch.einsum("ukd,nd->ukn", q, corpus), cats, k,
                                      diversity_weight)
            all_idx.append(idx.cpu().numpy())
            all_val.append(vals.cpu().numpy())
    return np.concatenate(all_idx), np.concatenate(all_val)
