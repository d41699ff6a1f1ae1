"""Load a frozen export back into a servable model (counterpart of
``tpurec/serving/export.py``).

The export (``tpurec_torch.train.checkpoint.export_params``) is params.pt +
export_meta.json. ``load_servable`` rebuilds the model from the registry on
its device and returns callables for ranking and, when the model has towers,
retrieval. Every call runs under ``torch.inference_mode()`` on a model in
eval mode, so the kernels run wherever the tensors are on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from tpurec_torch.config import EmbeddingConfig, ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.device import DeviceLike
from tpurec_torch.models import build_model
from tpurec_torch.train.checkpoint import load_export_meta, load_exported_params


class Servable:
    """Inference callables over a model in eval mode. Batches are mappings of
    feature name → array or tensor; they are moved to the model's device."""

    def __init__(self, model: nn.Module):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.user_tower: Optional[Callable] = None
        self.item_tower: Optional[Callable] = None
        if hasattr(model, "user_embedding"):
            self.user_tower = lambda batch: self._run(self.model.user_embedding, batch)
            self.item_tower = lambda batch: self._run(self.model.item_embedding, batch)

    def _run(self, fn: Callable, batch: Mapping):
        with torch.inference_mode():
            return fn({k: torch.as_tensor(v, device=self.device) for k, v in batch.items()})

    def rank(self, batch: Mapping) -> torch.Tensor:
        return self._run(self.model, batch)["output"]

    def predict(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return self._run(self.model, batch)


def load_servable(export_dir: str, info: DataInfo, device: DeviceLike = "cuda") -> Servable:
    """Rebuild the exported model on ``device`` (``cuda`` unless the caller
    asks for the CPU) and load its params (strict: every key must match)."""
    meta = load_export_meta(export_dir)
    config = ModelConfig(
        name=meta["model"],
        params=meta.get("model_params", {}),
        embedding=EmbeddingConfig.from_dict(meta.get("embedding", {})),
    )
    model = build_model(config, info, device=device)
    device = next(model.parameters()).device
    model.load_state_dict(load_exported_params(export_dir, map_location=device))
    return Servable(model)
