"""Online serving: HTTP POST /predict with retrieve / rank paths (counterpart
of ``tpurec/serving/server.py``, same request and response JSON):

    POST /predict {"user_id": ..., "type": "retrieve", "source": "kv"}      # precomputed
    POST /predict {"user_id": ..., "type": "retrieve"}                       # online tower + top-k
    POST /predict {"user_id": ..., "type": "rank", "item_ids": [...]}        # score candidates
    POST /predict {"user_id": ..., "type": "rank", "from_retrieval": true}

Online retrieval is an exact top-k over a pre-normalised corpus that stays on
the device; a multi-interest tower's (K, D) capsules score each item by their
best capsule. With ``item_categories`` configured, the request knob
``"diversity_weight"`` (> 0) switches retrieval to ComiRec's diversity-greedy
slate. Ranking is one batched forward over the candidate × feature matrix,
padded to a power-of-two bucket.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.ops.topk import top_k
from tpurec_torch.serving.diversity import greedy_slates
from tpurec_torch.serving.indexer import l2_normalize
from tpurec_torch.serving.kvstore import DictKVStore


class RecommendService:
    """Model-side logic, separable from the HTTP layer for testing. Towers and
    rankers are callables over a dict of id tensors on ``device``: the user
    tower returns (B, D) or (B, K, D) embeddings, the ranker (B,) scores."""

    def __init__(
        self,
        user_tower: Optional[Callable] = None,
        ranker: Optional[Callable] = None,
        user_profile: Optional[Dict[str, List[int]]] = None,
        item_profile: Optional[Dict[str, List[int]]] = None,
        user_feature_names: Sequence[str] = (),
        item_feature_names: Sequence[str] = (),
        kv_store: Optional[DictKVStore] = None,
        item_ids: Optional[Sequence[str]] = None,
        item_embeddings: Optional[np.ndarray] = None,
        item_categories: Optional[Sequence[int]] = None,
        key_prefix: str = "DSSM",
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.user_tower = user_tower
        self.ranker = ranker
        self.user_profile = user_profile or {}
        self.item_profile = item_profile or {}
        self.user_feature_names = list(user_feature_names)
        self.item_feature_names = list(item_feature_names)
        self.kv = kv_store or DictKVStore()
        self.item_ids = list(item_ids or [])
        self.key_prefix = key_prefix
        self._cats = (
            None if item_categories is None
            else torch.as_tensor(np.asarray(item_categories), device=self.device)
        )
        # the corpus is normalised once and stays on the device
        self._corpus = None
        if item_embeddings is not None:
            self._corpus = l2_normalize(
                torch.as_tensor(
                    np.asarray(item_embeddings), dtype=torch.float32, device=self.device
                )
            )

    def _capsule_scores(self, q: torch.Tensor) -> torch.Tensor:
        """q: (K, D) capsules (K=1 for single-vector towers) → (K, N) cosine
        scores."""
        return l2_normalize(q.to(torch.float32)) @ self._corpus.T

    # -- retrieval -----------------------------------------------------------
    def retrieve_kv(self, user_id: str) -> Dict[str, float]:
        """Precomputed top-k from the KV store."""
        raw = self.kv.get(f"{self.key_prefix}_{user_id}")
        if raw is None:
            return {}
        items, scores = raw.split("\t")
        return {i: float(s) for i, s in zip(items.split(","), scores.split(","))}

    def retrieve_online(
        self, user_id: str, topk: int = 20, diversity_weight: float = 0.0
    ) -> Dict[str, float]:
        """User tower + exact top-k over the corpus, every item scored by the
        best capsule. ``diversity_weight > 0`` (with ``item_categories``)
        returns the diversity-greedy slate instead; its scores stay the plain
        cosine relevance of the chosen items."""
        feats = self.user_profile.get(str(user_id))
        if feats is None or self._corpus is None:
            return {}
        batch = {
            n: torch.as_tensor([feats[j]], device=self.device)
            for j, n in enumerate(self.user_feature_names)
        }
        with torch.inference_mode():
            emb = self.user_tower(batch)
            scores = self._capsule_scores(emb.reshape(-1, emb.shape[-1]))
            if diversity_weight > 0.0 and self._cats is not None:
                idx, vals = greedy_slates(scores[None], self._cats, topk, diversity_weight)
                idx, vals = idx[0], vals[0]
            else:
                vals, idx = top_k(scores.max(dim=0).values, topk)
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        return {self.item_ids[j]: float(s) for j, s in zip(idx, vals)}

    # -- ranking --------------------------------------------------------------
    def rank(self, user_id: str, item_ids: Sequence[str]) -> Dict[str, float]:
        """Tile the user features across candidates and batch-score them."""
        ufeats = self.user_profile.get(str(user_id))
        if ufeats is None:
            return {}
        valid = [i for i in item_ids if str(i) in self.item_profile]
        if not valid:
            return {}
        n_valid = len(valid)
        # pad to the next power-of-two bucket, so the ranker sees few shapes
        padded = max(8, 1 << (n_valid - 1).bit_length())
        rows_u = np.tile(np.asarray(ufeats, np.int64), (padded, 1))
        rows_i = np.asarray(
            [self.item_profile[str(i)] for i in valid]
            + [self.item_profile[str(valid[0])]] * (padded - n_valid),
            np.int64,
        )
        batch = {}
        for j, n in enumerate(self.user_feature_names):
            batch[n] = torch.as_tensor(rows_u[:, j], device=self.device)
        for j, n in enumerate(self.item_feature_names):
            batch[n] = torch.as_tensor(rows_i[:, j], device=self.device)
        with torch.inference_mode():
            out = self.ranker(batch)
        scores = out.to(torch.float32).cpu().numpy().reshape(-1)[:n_valid]
        order = np.argsort(-scores)
        return {str(valid[j]): float(scores[j]) for j in order}

    # -- dispatcher ------------------------------------------------------------
    def predict(self, request: dict) -> dict:
        rtype = request.get("type", "retrieve")
        user_id = str(request.get("user_id", ""))
        if rtype == "retrieve":
            if request.get("source") == "kv":
                result = self.retrieve_kv(user_id)
            else:
                result = self.retrieve_online(
                    user_id, int(request.get("topk", 20)),
                    float(request.get("diversity_weight", 0.0)),
                )
            return {"user_id": user_id, "type": "retrieve", "result": result}
        if rtype == "rank":
            items = request.get("item_ids")
            if not items and request.get("from_retrieval"):
                items = list(self.retrieve_online(user_id, int(request.get("topk", 20))))
            result = self.rank(user_id, items or [])
            return {"user_id": user_id, "type": "rank", "result": result}
        return {"error": f"unknown type {rtype!r}"}


class _Handler(BaseHTTPRequestHandler):
    service: RecommendService = None  # set by make_server

    def do_POST(self):
        if self.path != "/predict":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            request = json.loads(self.rfile.read(length) or b"{}")
            response = self.service.predict(request)
            code = 200
        except Exception as exc:  # noqa: BLE001 — surface as a 400 payload
            response = {"error": str(exc)}
            code = 400
        body = json.dumps(response).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def make_server(service: RecommendService, host: str = "127.0.0.1", port: int = 5000):
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve_background(service: RecommendService, host="127.0.0.1", port=5000):
    """Start the server on a daemon thread; stop it with ``server.shutdown()``
    and ``server.server_close()``."""
    server = make_server(service, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
