"""Model contract and shared helpers (counterpart of ``tpurec/models/base.py``).

Every model is an ``nn.Module`` whose ``forward(inputs: dict[str, Tensor])``
returns named outputs — ``'output'`` (probability) at minimum; retrieval
models add tower embeddings. Inputs are per-feature tensors keyed by feature
name: categorical (B,) ids already offset-encoded into the shared id space,
continuous (B,) floats, behavior sequences (B, L) padded with
``padding_index``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

Inputs = Dict[str, torch.Tensor]
Outputs = Dict[str, torch.Tensor]


def stack_ids(inputs: Inputs, names: Sequence[str]) -> torch.Tensor:
    """(B, F) int tensor from scalar categorical features."""
    return torch.stack([inputs[n].reshape(-1) for n in names], dim=1)


def stack_continuous(inputs: Inputs, names: Sequence[str]) -> Optional[torch.Tensor]:
    """(B, C) fp32 tensor from scalar continuous features; None without
    names."""
    if not names:
        return None
    return torch.stack([inputs[n].reshape(-1).to(torch.float32) for n in names], dim=1)


def binary_output(logit: torch.Tensor) -> Outputs:
    """Binary head: the fp32 logit, and its sigmoid clipped to [0, 1] as
    'output'."""
    logit = logit.reshape(-1).to(torch.float32)
    prob = torch.reciprocal(1.0 + torch.exp(-logit))
    return {"logit": logit, "output": prob.clamp(0.0, 1.0)}


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a_n = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(eps)
    b_n = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(eps)
    return (a_n * b_n).sum(dim=-1)


def sequence_mask(seq_ids: torch.Tensor, padding_index: int = 0) -> torch.Tensor:
    """(B, L) float mask, 1 where the step is a real id."""
    return (seq_ids != padding_index).to(torch.float32)


def series_mask(inputs: Inputs, name: str, padding_index: int = 0) -> torch.Tensor:
    """(B, L) validity mask for the behavior series ``name``: an explicit
    ``__mask__<name>`` input when given, else the padding-index mask."""
    m = inputs.get(f"__mask__{name}")
    if m is not None:
        return m.to(torch.float32)
    return sequence_mask(inputs[name], padding_index)


def embed_series(emb, inputs: Inputs, names: Sequence[str], padding_index: int = 0):
    """Concat-embed parallel behavior series into one (B, L, F·D) block, with
    the (B, L) mask of the first series."""
    mask = series_mask(inputs, names[0], padding_index)
    embs = [emb(inputs[n]) for n in names]  # each (B, L, D)
    keys = torch.cat(embs, dim=-1) if len(embs) > 1 else embs[0]
    return keys, mask
