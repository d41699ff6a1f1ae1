"""Adam moments of sparse embedding tables in host memory (counterpart of
``tpurec/embedding/host_offload.py``).

With ``embedding_optimizer='host_adam'`` the device holds only the (V, D)
tables: each table's fp32 Adam moments live in host memory (pinned when the
trainer runs on the card), so the moments take no device bytes. Each step
the touched rows' gradients (U, D) go to the host, the host applies lazy
Adam (the math of ``sparse.sparse_adam``) to its moment arrays and returns
the row deltas, and the device subtracts them from the table. The copy to
the host waits for the device: a ``host_adam`` step synchronises once.

Checkpoints: the moments live outside the checkpointed state. The store has
``state_dict``/``load_state_dict`` (``m_<slot>``, ``v_<slot>`` numpy arrays,
the JAX store's keys) and ``save``/``load`` of one ``.npz``; the trainer
keeps one such sidecar per checkpointed step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class HostAdamState(NamedTuple):
    """A table's stand-in in ``TrainState.table_opt``: its slot in the store."""

    slot: int


class HostAdamStore:
    """Per-table fp32 Adam moments in host memory, one slot per table.

    One store per trainer; one training loop at a time updates it."""

    def __init__(self, pin_memory: bool = False) -> None:
        self.pin_memory = pin_memory
        self._m: List[torch.Tensor] = []
        self._v: List[torch.Tensor] = []

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, pin_memory=self.pin_memory)

    def register(self, shape: Tuple[int, ...]) -> int:
        """Host moments for one (V, ...) table; returns its slot."""
        self._m.append(self._zeros(shape))
        self._v.append(self._zeros(shape))
        return len(self._m) - 1

    @property
    def num_tables(self) -> int:
        return len(self._m)

    def nbytes(self) -> int:
        return sum(t.numel() * 4 for t in self._m + self._v)

    # ------------------------------------------------------------- persist
    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for i, (m, v) in enumerate(zip(self._m, self._v)):
            out[f"m_{i}"] = m.numpy()
            out[f"v_{i}"] = v.numpy()
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        n = len([k for k in state if k.startswith("m_")])
        self._m, self._v = [], []
        for i in range(n):
            for arrays, key in ((self._m, f"m_{i}"), (self._v, f"v_{i}")):
                t = self._zeros(np.shape(state[key]))
                t.copy_(torch.from_numpy(np.asarray(state[key], np.float32)))
                arrays.append(t)

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def load(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state_dict(dict(z))

    # -------------------------------------------------------------- update
    def host_update(self, slot: int, uniq: np.ndarray, grad_rows: np.ndarray, step: int,
                    lr: float, b1: float, b2: float, eps: float) -> np.ndarray:
        """Lazy Adam on the host moments of ``slot``; returns the row deltas.
        fp32 throughout, as the JAX store's callback computes. Repeated
        ``uniq`` entries (the sacrificial pad row) write in order, the last
        one kept."""
        m, v = self._m[slot].numpy(), self._v[slot].numpy()
        f32 = np.float32
        b1, b2, eps, lr = f32(b1), f32(b2), f32(eps), f32(lr)
        g = np.asarray(grad_rows, np.float32)
        m_new = b1 * m[uniq] + (f32(1.0) - b1) * g
        v_new = b2 * v[uniq] + (f32(1.0) - b2) * np.square(g)
        m[uniq] = m_new
        v[uniq] = v_new
        t = f32(step)
        m_hat = m_new / (f32(1.0) - b1**t)
        v_hat = v_new / (f32(1.0) - b2**t)
        return np.asarray(lr * m_hat / (np.sqrt(v_hat) + eps), np.float32)

    @torch.no_grad()
    def update(self, table: torch.Tensor, state: HostAdamState, uniq: torch.Tensor,
               grad_rows: torch.Tensor, step: int, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-7) -> Tuple[torch.Tensor, HostAdamState]:
        """The table update of one step (in place): gradients to the host,
        lazy Adam there, the deltas back to the table's device."""
        uniq_h = uniq.cpu().numpy()
        g_h = grad_rows.to(torch.float32).cpu().numpy()
        delta = torch.from_numpy(
            self.host_update(state.slot, uniq_h, g_h, step, lr, b1, b2, eps)
        )
        if self.pin_memory:
            delta = delta.pin_memory()
        delta = delta.to(table.device, non_blocking=True)
        table.index_copy_(0, uniq, table.index_select(0, uniq) - delta.to(table.dtype))
        return table, state
