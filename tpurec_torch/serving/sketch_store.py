"""SDIM's serving-time sketch store, host-side and numpy-only (a copy of
``tpurec/serving/sketch_store.py``).

Per user and per hash group, a bucket → (sum, count) sketch of the user's
long history; serving reads the target item's bucket in each group and
returns the pooled long-term interest without the raw sequence. ``query``
has ``tpurec_torch.ops.hashing.sketch_pool``'s semantics: the mean over the
groups of the target bucket's mean (a bucket the user never hit gives 0).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SketchStore:
    def __init__(self, projections: np.ndarray):
        # projections: (G, D, n_bits)
        self.projections = np.asarray(projections, np.float32)
        self.num_groups = self.projections.shape[0]
        # user → group → bucket → (sum vector, count)
        self._store: Dict[str, list] = {}

    def _bucket_ids(self, vectors: np.ndarray, group: int) -> np.ndarray:
        bits = (vectors @ self.projections[group] > 0).astype(np.int64)
        weights = 2 ** np.arange(bits.shape[-1])
        return bits @ weights

    def update(self, user_id: str, behavior_embeddings: np.ndarray) -> None:
        """Fold new behavior embeddings (L, D) into the user's sketches."""
        entry = self._store.setdefault(user_id, [dict() for _ in range(self.num_groups)])
        for g in range(self.num_groups):
            buckets = self._bucket_ids(behavior_embeddings, g)
            for b, vec in zip(buckets, behavior_embeddings):
                s, c = entry[g].get(int(b), (np.zeros(vec.shape, np.float32), 0))
                entry[g][int(b)] = (s + vec, c + 1)

    def query(self, user_id: str, target_embedding: np.ndarray) -> Optional[np.ndarray]:
        """The long-term interest: the mean over the groups of the target
        bucket's mean; None for an unknown user."""
        entry = self._store.get(user_id)
        if entry is None:
            return None
        pooled = []
        for g in range(self.num_groups):
            bucket = int(self._bucket_ids(target_embedding[None, :], g)[0])
            s, c = entry[g].get(bucket, (np.zeros_like(target_embedding), 0))
            pooled.append(s / max(c, 1))
        return np.mean(pooled, axis=0)

    def __contains__(self, user_id: str) -> bool:
        return user_id in self._store
