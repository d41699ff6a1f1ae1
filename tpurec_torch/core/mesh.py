"""The ('data', 'model') mesh over the ranks of a ``torch.distributed`` world
(counterpart of ``tpurec/core/mesh.py``).

- batches split over 'data' (data parallelism: the gradients are averaged
  over the axis);
- embedding-table rows split over 'model' (``embedding.ops.row_sharded_lookup``
  sums each rank's rows over the axis).

Rank r sits at (r // n_model, r % n_model), the layout of the JAX package's
``np.asarray(devices).reshape(data, model)``. A ``MeshContext`` holds one
process group per axis: the ranks that share this rank's index on the other
axis. An axis of size 1 has no group, and a collective over it does
nothing. Without a world ``make_mesh`` gives the (1, 1) mesh, on which every
collective does nothing and the trainer runs as on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch.distributed as dist

from tpurec_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """This rank's place in the mesh and a process group per axis (None for
    an axis of size 1)."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None  # the ranks of this rank's model index, in data order
    model_group: Any = None  # the ranks of this rank's data index, in model order

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    def group(self, axis: str) -> Optional[Any]:
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]


def make_mesh(config: Optional[MeshConfig] = None) -> MeshContext:
    """The world's ranks as the ('data', 'model') mesh.

    ``config.data == -1`` means "all remaining ranks after carving out the
    model axis". Without a world there is one rank, so the mesh is (1, 1).
    Every rank of the world must call this, in the same order, since it
    creates the process groups of the axes."""
    config = config or MeshConfig()
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = max(1, config.model)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    data = config.data if config.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n == 1:
        return MeshContext()
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank creates every group, in one order, as new_group requires
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)]) if data > 1 else None
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)]) if model > 1 else None
        if rank // model == d:
            model_group = g
    return MeshContext(data, model, rank // model, rank % model, data_group, model_group)


def local_batch_size(global_batch: int, ctx: MeshContext) -> int:
    if global_batch % ctx.n_data != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {ctx.n_data}"
        )
    return global_batch // ctx.n_data


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
