"""Multi-process bootstrap (counterpart of ``tpurec/core/distributed.py``).

Each rank of a run is one process with one device. ``initialize()`` joins
the processes into one ``torch.distributed`` world, after which
``tpurec_torch.core.mesh.make_mesh`` lays the world out as the ('data',
'model') mesh. The backend is the caller's choice and nothing changes it:
``"nccl"`` (the default) for ranks on separate GPUs, ``"gloo"`` for CPU
tensors, or for several ranks that share one GPU (NCCL allows only one rank
of a communicator on a device; gloo reduces CUDA tensors through the host).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> dict:
    """Join the world when one is asked for (an address or a process count)
    and none is joined yet; do nothing otherwise, as on a single host.
    Returns the process topology for the input pipeline.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``) or a bare ``host:port``; ``backend`` defaults to
    ``"nccl"``."""
    if not dist.is_initialized() and (coordinator_address or num_processes):
        url = coordinator_address or "env://"
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(
            backend or "nccl", init_method=url,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,  # a rank drives one device
        "global_devices": count,
    }


def host_loader_kwargs() -> dict:
    """kwargs for ``ArrayLoader`` so each process reads its own rows (a
    pipeline split by process; the ``Trainer`` itself takes the global batch
    on every rank and keeps its block, ``Trainer.device_batch``)."""
    if not dist.is_initialized():
        return {"host_id": 0, "num_hosts": 1}
    return {"host_id": dist.get_rank(), "num_hosts": dist.get_world_size()}
