"""The lazy-sparse embedding engine's ops (counterpart of
``tpurec/embedding/sparse.py``).

A step gathers only the rows its ids touch: ``unique_with_positions`` gives
the step's unique ids (fixed shape) and each id's slot, the trainer gathers
``rows = table[uniq]`` and rewrites the batch's ids into slots, autograd
gives a (U, D) gradient, and one of the row-sparse optimizers below updates
the touched rows (lazy: untouched rows' moments do not decay).

Every op keeps a fixed shape (sort, cumsum, scatter), so nothing waits for
the device; ``torch.unique`` would (its output size is data-dependent).
The optimizers update the table and their state IN PLACE (the JAX versions
return new arrays) and return them. Duplicate ``pad_id`` entries of
``uniq`` all write the sacrificial last row; CUDA orders those writes
arbitrarily, so that row alone may differ between runs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def unique_fixed(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Sorted fixed-size unique: repeats become ``pad_id`` and sort to the
    end (``pad_id`` must be the largest row). Same shape as ``ids.reshape(-1)``."""
    flat = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    return torch.sort(torch.where(first, flat, pad_id)).values


def lookup_positions(uniq: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Positions of ``ids`` in the sorted ``uniq`` (exact matches by
    construction)."""
    return torch.searchsorted(uniq, ids)


def unique_with_positions(flat_ids: torch.Tensor, pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sort, a cumsum and two scatters: ``(uniq (N+1,), positions (N,))``.

    ``uniq`` holds the ascending unique ids, then ``pad_id``; a synthetic id 0
    is injected, so slot 0 is id 0 and a padding index of 0 keeps its value
    in position space. ``positions[i]`` is the slot of ``flat_ids[i]``."""
    flat = torch.cat([flat_ids.new_zeros(1), flat_ids.reshape(-1)])
    sorted_ids, order = torch.sort(flat, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1
    # equal ids share a slot and write the same value
    uniq = torch.full_like(flat, pad_id).scatter_(0, slot, sorted_ids)
    positions = torch.empty_like(slot).scatter_(0, order, slot)
    return uniq, positions[1:]


class SparseAdamState(NamedTuple):
    m: torch.Tensor  # (V, D) first moment
    v: torch.Tensor  # (V, D) second moment


def init_sparse_adam(table: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(torch.zeros_like(table), torch.zeros_like(table))


class SparseAdagradState(NamedTuple):
    """Row-wise Adagrad: one fp32 accumulator per row."""

    acc: torch.Tensor  # (V,)


def init_sparse_adagrad(table: torch.Tensor, initial: float = 0.0) -> SparseAdagradState:
    return SparseAdagradState(
        torch.full((table.shape[0],), initial, dtype=torch.float32, device=table.device)
    )


class SparseRowAdamState(NamedTuple):
    """Row-wise Adam: a bf16 first moment per element, one fp32 second
    moment per row."""

    m: torch.Tensor  # (V, D) bfloat16
    v: torch.Tensor  # (V,) fp32


def init_sparse_row_adam(table: torch.Tensor) -> SparseRowAdamState:
    return SparseRowAdamState(
        torch.zeros(table.shape, dtype=torch.bfloat16, device=table.device),
        torch.zeros(table.shape[0], dtype=torch.float32, device=table.device),
    )


def bias_correction(b: float, step: int) -> float:
    """``1 - b**step`` in fp32, as the JAX optimizers compute it (``b`` and
    the step both fp32: 1 - 0.999 is 1.3e-5 away from 0.001 there)."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(step))


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


@torch.no_grad()
def sparse_rowwise_adagrad(table, opt: SparseAdagradState, uniq, grad_rows, lr, eps=1e-10):
    """Row-wise Adagrad on the touched rows: the accumulator adds each row's
    mean squared gradient; every element of the row shares its scale."""
    g32 = grad_rows.to(torch.float32)
    g2 = g32.square().mean(dim=tuple(range(1, g32.dim())))
    acc_rows = opt.acc.index_select(0, uniq) + g2
    scale = _per_row(lr / torch.sqrt(acc_rows + eps), g32)
    rows = table.index_select(0, uniq) - (scale * g32).to(table.dtype)
    table.index_copy_(0, uniq, rows)
    opt.acc.index_copy_(0, uniq, acc_rows)
    return table, opt


@torch.no_grad()
def sparse_rowwise_adam(table, opt: SparseRowAdamState, uniq, grad_rows, step, lr, b1=0.9,
                        b2=0.999, eps=1e-7):
    """Row-wise Adam on the touched rows: lazy, bias-corrected; the second
    moment is the row's mean squared gradient, the first moment is kept in
    bf16."""
    g32 = grad_rows.to(torch.float32)
    m_new = b1 * opt.m.index_select(0, uniq).to(torch.float32) + (1 - b1) * g32
    v_new = b2 * opt.v.index_select(0, uniq) + (1 - b2) * g32.square().mean(
        dim=tuple(range(1, g32.dim()))
    )
    m_hat = m_new / bias_correction(b1, step)
    v_hat = _per_row(v_new / bias_correction(b2, step), g32)
    delta = lr * m_hat / (torch.sqrt(v_hat) + eps)
    table.index_copy_(0, uniq, table.index_select(0, uniq) - delta.to(table.dtype))
    opt.m.index_copy_(0, uniq, m_new.to(torch.bfloat16))
    opt.v.index_copy_(0, uniq, v_new)
    return table, opt


@torch.no_grad()
def sparse_adam(table, opt: SparseAdamState, uniq, grad_rows, step, lr, b1=0.9, b2=0.999,
                eps=1e-7):
    """Adam on the touched rows only (lazy Adam: untouched rows' moments do
    not decay); equal to dense Adam on the touched rows."""
    m_new = b1 * opt.m.index_select(0, uniq) + (1 - b1) * grad_rows
    v_new = b2 * opt.v.index_select(0, uniq) + (1 - b2) * grad_rows.square()
    m_hat = m_new / bias_correction(b1, step)
    v_hat = v_new / bias_correction(b2, step)
    delta = lr * m_hat / (torch.sqrt(v_hat) + eps)
    table.index_copy_(0, uniq, table.index_select(0, uniq) - delta.to(table.dtype))
    opt.m.index_copy_(0, uniq, m_new)
    opt.v.index_copy_(0, uniq, v_new)
    return table, opt
