"""Offline retrieval indexing: embedding dump → exact top-k → KV store
(counterpart of ``tpurec/serving/indexer.py``, same artifacts):

- ``ebd_result/user_embedding.json`` / ``item_embedding.json``
- per-user ``<prefix>_<uid> → "i1,i2,...\\ts1,s2,..."`` strings in the KV store
- ``topk_index.npz`` (user/item ids and embeddings)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.ops.topk import top_k
from tpurec_torch.serving.kvstore import DictKVStore


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


def exact_topk(
    queries,  # (Q, D)
    corpus,  # (N, D)
    k: int,
    normalize: bool = True,
    batch_size: int = 4096,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine (or inner-product) top-k: one fp32 matmul and
    ``top_k`` (the lower index first among equal scores, as ``lax.top_k``)
    per query batch on ``device``. Returns
    (indices (Q, k), scores (Q, k)) as numpy."""
    dev = resolve_device(device)
    corpus = torch.as_tensor(np.asarray(corpus), dtype=torch.float32, device=dev)
    if normalize:
        corpus = l2_normalize(corpus)
    queries = np.asarray(queries)
    all_idx: List[np.ndarray] = []
    all_val: List[np.ndarray] = []
    with torch.inference_mode():
        for start in range(0, len(queries), batch_size):
            q = torch.as_tensor(
                queries[start : start + batch_size], dtype=torch.float32, device=dev
            )
            if normalize:
                q = l2_normalize(q)
            vals, idx = top_k(q @ corpus.T, k)
            all_idx.append(idx.cpu().numpy())
            all_val.append(vals.cpu().numpy())
    return np.concatenate(all_idx), np.concatenate(all_val)


def recall_at_k(
    user_emb: np.ndarray,
    item_emb: np.ndarray,
    truth: Sequence[int],
    k: int = 100,
    device: DeviceLike = "cuda",
) -> float:
    """Fraction of users whose true item appears in their exact top-k."""
    idx, _ = exact_topk(user_emb, item_emb, k, device=device)
    truth = np.asarray(truth)
    return float(np.mean(np.any(idx == truth[:, None], axis=1)))


class OfflineIndexer:
    """Dump tower embeddings for every profile entry, build the top-k lists,
    persist the artifacts. Towers are callables: dict of id tensors on
    ``device`` ((B,) ids, or (B, L) for a feature that is a sequence, such as
    a stored behavior history) → (B, D) embeddings, or (B, K, D) interest
    capsules for a multi-interest user tower."""

    def __init__(
        self,
        user_tower,
        item_tower,
        user_profile: Dict[str, List[int]],  # uid → encoded feature ids
        item_profile: Dict[str, List[int]],
        user_feature_names: Sequence[str],
        item_feature_names: Sequence[str],
        batch_size: int = 1024,
        device: DeviceLike = "cuda",
    ):
        self.user_tower = user_tower
        self.item_tower = item_tower
        self.user_profile = user_profile
        self.item_profile = item_profile
        self.user_feature_names = list(user_feature_names)
        self.item_feature_names = list(item_feature_names)
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _embed_all(self, tower, profile, feature_names) -> Tuple[List[str], np.ndarray]:
        ids = list(profile.keys())
        rows = [profile[i] for i in ids]
        cols = [
            torch.as_tensor(np.asarray([r[j] for r in rows], np.int64), device=self.device)
            for j in range(len(feature_names))
        ]
        out: List[np.ndarray] = []
        for start in range(0, len(ids), self.batch_size):
            batch = {
                name: cols[j][start : start + self.batch_size]
                for j, name in enumerate(feature_names)
            }
            out.append(tower(batch).to(torch.float32).cpu().numpy())
        return ids, np.concatenate(out)

    def run(
        self,
        output_dir: str,
        kv_store: Optional[DictKVStore] = None,
        topk: int = 20,
        key_prefix: str = "DSSM",
        item_categories: Optional[Sequence[int]] = None,
        diversity_weight: float = 0.0,
    ) -> Dict[str, object]:
        """``diversity_weight > 0`` (with per-item ``item_categories``)
        stores ComiRec's diversity-greedy slates instead of the plain top-k;
        a multi-interest user tower's (B, K, D) capsules score each item by
        their best capsule either way (``tpurec/serving/indexer.py:
        136-175``)."""
        user_ids, user_emb = self._embed_all(
            self.user_tower, self.user_profile, self.user_feature_names
        )
        item_ids, item_emb = self._embed_all(
            self.item_tower, self.item_profile, self.item_feature_names
        )
        ebd_dir = os.path.join(output_dir, "ebd_result")
        os.makedirs(ebd_dir, exist_ok=True)
        with open(os.path.join(ebd_dir, "user_embedding.json"), "w") as f:
            json.dump({u: e.tolist() for u, e in zip(user_ids, user_emb)}, f)
        with open(os.path.join(ebd_dir, "item_embedding.json"), "w") as f:
            json.dump({i: e.tolist() for i, e in zip(item_ids, item_emb)}, f)
        k = min(topk, len(item_ids))
        if user_emb.ndim == 3 or diversity_weight > 0.0:
            from tpurec_torch.serving.diversity import diverse_topk

            cats = (np.asarray(item_categories) if item_categories is not None
                    else np.zeros(len(item_ids), np.int32))
            idx, scores = diverse_topk(
                user_emb, item_emb, k, cats, diversity_weight, device=self.device
            )
        else:
            idx, scores = exact_topk(user_emb, item_emb, k, device=self.device)
        kv = kv_store if kv_store is not None else DictKVStore()
        for row, uid in enumerate(user_ids):
            items = ",".join(item_ids[j] for j in idx[row])
            svals = ",".join(f"{s:.6f}" for s in scores[row])
            kv.set(f"{key_prefix}_{uid}", items + "\t" + svals)
        np.savez(
            os.path.join(output_dir, "topk_index.npz"),
            user_ids=np.asarray(user_ids),
            item_ids=np.asarray(item_ids),
            item_embeddings=item_emb,
            user_embeddings=user_emb,
        )
        return {
            "num_users": len(user_ids),
            "num_items": len(item_ids),
            "kv": kv,
            "user_embeddings": user_emb,
            "item_embeddings": item_emb,
            "user_ids": user_ids,
            "item_ids": item_ids,
        }
