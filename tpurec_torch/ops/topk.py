"""Top-k with ``jax.lax.top_k``'s order (counterpart of the JAX package's
``lax.top_k`` calls in ``serving/indexer.py``, ``serving/server.py`` and
``models/mind.py``).

``lax.top_k`` returns the values in descending order and, among equal
values, the lower index first. ``torch.topk`` documents no order among equal
values (on the CPU it returns later indices first), so a slate of tied items,
such as two items with the same features, would come out in another order.
A stable descending sort keeps the lower index first.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries over the last axis:
    values descending, the lower index first among equal values. The values
    carry ``x``'s gradient."""
    _, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx
