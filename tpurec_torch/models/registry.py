"""Model registry: string name → builder (counterpart of
``tpurec/models/registry.py``). Builders receive the model params dict and
the ``DataInfo`` schema; ``build_model`` places the model on its device and
initialises it from a seed."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

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
    as the JAX package places its variables (``tpurec/train/trainer.py:
    358-371``): every table holds this rank's rows (``EmbeddingTable.place``),
    every ``BatchNorm`` takes its batch moments over 'data', and the
    tensor-parallel weights hold this rank's share over 'model': an
    ``MLP`` with ``tp_axis`` (DIN's, DIEN's and DSIN's ``mlp``), every
    ``ExpertBank`` and every ``MultiHeadAttention`` (each parameter whole
    where its split dimension does not divide). The other dense weights
    are whole on every rank. On data > 1 every module whose training terms
    couple the batch's rows (``batch_mesh``: DIEN's and DMR's auxiliary
    losses, the retrieval models' sampled negatives) reads the global
    batch over 'data', and every ``Dropout`` draws the global batch's
    mask."""
    from tpurec_torch.embedding.modules import EmbeddingTable
    from tpurec_torch.models.multitask import ExpertBank
    from tpurec_torch.ops.attention import MultiHeadAttention
    from tpurec_torch.ops.mlp import MLP, BatchNorm

    for m in model.modules():
        if isinstance(m, EmbeddingTable):
            m.place(mesh)
        elif isinstance(m, BatchNorm):
            m.data_group = mesh.data_group
        elif isinstance(m, (MLP, ExpertBank, MultiHeadAttention)) and mesh.n_model > 1:
            m.place(mesh)
        if hasattr(m, "batch_mesh") and mesh.n_data > 1:
            m.batch_mesh = mesh
    return model


@contextlib.contextmanager
def replicated_batch(model: nn.Module):
    """In the body, every module of ``model`` that reads the global batch
    over 'data' (``batch_mesh``) takes this rank's batch as the whole one:
    a batch whose rows do not divide over 'data' is whole on every rank
    (``Trainer.device_batch``)."""
    mods = [(m, m.batch_mesh) for m in model.modules() if getattr(m, "batch_mesh", None) is not None]
    for m, _ in mods:
        m.batch_mesh = None
    try:
        yield
    finally:
        for m, mesh in mods:
            m.batch_mesh = mesh


def sharded_weights(model: nn.Module) -> Dict[str, Tuple[int, object]]:
    """``{parameter name: (dim, mesh)}`` of every dense weight that holds
    this rank's share over 'model' on ``dim`` (the tables are
    ``EmbeddingTable``'s own)."""
    out = {}
    for name, m in model.named_modules():
        for p, dim in getattr(m, "shard_dims", {}).items():
            out[f"{name}.{p}" if name else p] = (dim, m.mesh)
    return out


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
