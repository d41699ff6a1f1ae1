"""Sequence ops (counterpart of ``tpurec/ops/sequence.py``): the sinusoidal
position table ComiRec-SA adds to its behavior sequence. The recurrent ops
(``MaskedGRU``, ``MaskedLSTM``, the bidirectional wrapper) come with the
sequence slice."""

from __future__ import annotations

import numpy as np


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table (length, dim), fp32: sin on even
    columns, cos on odd ones (``tpurec/ops/sequence.py:204-213``)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    table = np.zeros((length, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table
