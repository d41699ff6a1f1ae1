"""Checkpoints and the frozen serving export (counterpart of
``tpurec/train/checkpoint.py``).

- ``CheckpointManager``: one ``step_<n>.pt`` per saved step (``torch.save``
  of whatever tree the trainer hands it: model and optimizer state dicts,
  step, generator state), keeping the newest ``max_to_keep``.
- The export: ``params.pt`` — a ``torch.save``d state dict — plus the same
  ``export_meta.json`` sidecar (``model``, ``model_params``, ``embedding``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch

PARAMS_FILE = "params.pt"
META_FILE = "export_meta.json"
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save/restore of training state by step, with ``max_to_keep``
    rotation (the oldest steps are removed, as Orbax's manager does)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, tree: Any) -> None:
        """Write ``tree`` for ``step`` (under a temporary name, then renamed
        into place) and drop the steps beyond ``max_to_keep``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        if self.max_to_keep and self.max_to_keep > 0:
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The tree saved for ``step`` (the latest when None). Loaded with
        ``weights_only``: tensors and plain containers only."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def close(self) -> None:
        pass


def export_params(
    directory: str, state_dict: Mapping[str, torch.Tensor], meta: Optional[dict] = None
) -> None:
    """Write the model's state dict (moved to the CPU) and the JSON meta."""
    os.makedirs(directory, exist_ok=True)
    cpu_state = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    torch.save(cpu_state, os.path.join(directory, PARAMS_FILE))
    if meta is not None:
        with open(os.path.join(directory, META_FILE), "w") as f:
            json.dump(meta, f, indent=2)


def load_exported_params(
    directory: str, map_location: Optional[str] = None
) -> Dict[str, torch.Tensor]:
    """The exported state dict (tensors only: loaded with ``weights_only``)."""
    return torch.load(
        os.path.join(directory, PARAMS_FILE), map_location=map_location, weights_only=True
    )


def load_exported_raw(directory: str) -> Dict[str, torch.Tensor]:
    """The exported state dict on the CPU, for grafting into another
    model's subtree (``Trainer.init_subtree_from_export``)."""
    return load_exported_params(directory, map_location="cpu")


def load_export_meta(directory: str) -> dict:
    with open(os.path.join(directory, META_FILE)) as f:
        return json.load(f)
