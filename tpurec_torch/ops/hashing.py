"""Hashing ops (counterpart of ``tpurec/ops/hashing.py``): for now only
``gather_steps``, which SDM's short-term window uses. The SimHash codes,
Hamming top-k, LSH buckets and sketch pooling come with the SIM family."""

from __future__ import annotations

import torch


def gather_steps(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (B, k, ...) steps of ``seq`` (B, L, ...) at the per-row indices
    ``idx`` (B, k), as ``jnp.take_along_axis`` along axis 1."""
    idx = idx.to(torch.int64).reshape(idx.shape + (1,) * (seq.dim() - 2))
    return torch.take_along_dim(seq, idx, dim=1)
