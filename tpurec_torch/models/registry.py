"""Model registry: string name → builder (counterpart of
``tpurec/models/registry.py``). Builders receive the model params dict and
the ``DataInfo`` schema; ``build_model`` places the model on its device and
initialises it from a seed."""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from tpurec_torch.config import ModelConfig
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.initializers import init_parameters

Builder = Callable[[dict, DataInfo], nn.Module]

MODEL_REGISTRY: Dict[str, Builder] = {}


def register_model(name: str):
    def deco(fn: Builder) -> Builder:
        if name in MODEL_REGISTRY:
            raise ValueError(f"duplicate model name {name!r}")
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def place_on_mesh(model: nn.Module, mesh) -> nn.Module:
    """Put ``model`` on ``mesh`` (a ``MeshContext`` of more than one device)
    as the JAX package's builders do with their ``mesh`` argument: every
    table holds this rank's rows (``EmbeddingTable.place``) and every
    ``BatchNorm`` takes its batch moments over 'data'. Dense weights stay
    whole on every rank."""
    from tpurec_torch.embedding.modules import EmbeddingTable
    from tpurec_torch.ops.mlp import BatchNorm

    for m in model.modules():
        if isinstance(m, EmbeddingTable):
            m.place(mesh)
        elif isinstance(m, BatchNorm):
            m.data_group = mesh.data_group
    return model


def build_model(
    config: ModelConfig, info: DataInfo, device: DeviceLike = "cuda", seed: int = 0,
    mesh=None,
) -> nn.Module:
    """Build the registry model ``config.name`` on ``device`` (``cuda`` unless
    the caller asks for the CPU; raises when CUDA is asked for and absent),
    its weights drawn from a ``torch.Generator`` seeded with ``seed``.
    ``config.embedding.dim`` becomes ``embed_dim`` unless the params set it.
    On a ``mesh`` of more than one device the model is placed on it
    (``place_on_mesh``) before its weights are drawn; every rank draws the
    same numbers."""
    from tpurec_torch.models import builders  # noqa: F401  (registers the builders)

    if config.name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {config.name!r}; known: {sorted(MODEL_REGISTRY)}")
    params = dict(config.params)
    if config.embedding.dim and "embed_dim" not in params:
        params["embed_dim"] = config.embedding.dim
    with torch.device(resolve_device(device)):
        model = MODEL_REGISTRY[config.name](params, info)
        if mesh is not None and mesh.n_devices > 1:
            place_on_mesh(model, mesh)
    return init_parameters(model, seed)
