"""One train step of DIN on an n-rank mesh in the three embedding engines
(counterpart of ``__graft_entry__.py:64-165`` ``dryrun_multichip``).

``dryrun_multichip(n)`` runs in each rank of an initialised world of n
ranks (``core.distributed.initialize``), or alone for n = 1. Its layout and
shapes are the JAX version's: model = 2 when n is even, else 1, data the
rest; DIN with D = 8 over a 16-row batch (2 · data rows when that is more),
fp32. It runs one step in each engine and asserts a finite loss:

- dense, with the top MLP tensor parallel: on model > 1 each rank holds
  1/model of the table's rows and of ``mlp.dense_0``'s output columns;
- ``rowwise_adam`` (used-id L2 0): the table's rows and their row-wise
  state sharded;
- ``fused_adam``: the sharded fused step (kernel #9 on each rank's rows
  on the card).

Each prints the JAX version's line, once a world (rank 0). The launcher
starts the ranks:

    python -m tpurec_torch.dryrun N                 # on the card: cuda:0
    python -m tpurec_torch.dryrun N --device cpu    # gloo ranks on the CPU

On the card a world of one joins over NCCL and N > 1 ranks share ``cuda:0``
over gloo (NCCL takes one rank of a communicator a device); on the CPU the
ranks join over gloo. A rank that fails stops the others; the launcher
exits non-zero then, and after ``TIMEOUT`` seconds.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

TIMEOUT = 300  # seconds the launcher waits for its ranks


def tiny_dataset(batch: int = 16, seq_len: int = 16, seed: int = 0):
    """(DataInfo, batch) of the JAX version's ``_tiny_dataset``: three
    features and two behavior series over 85 ids."""
    from tpurec_torch.data.schema import DataInfo

    info = DataInfo(
        feature_names=["item_id", "user_tag", "item_tag"],
        feature_dims=[64, 8, 12],
        feature_offsets=[1, 65, 73],
        total_dims=85,
        sequence_names=["history", "history_tags"],
        sequence_query_features=["item_id", "item_tag"],
        label_names=["label"],
        max_seq_length=seq_len,
        padding_index=0,
        user_features=["user_tag"],
        item_features=["item_id", "item_tag"],
    )
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, seq_len + 1, size=(batch,))
    step = np.arange(seq_len)[None, :] < lengths[:, None]
    data = {
        "item_id": rng.integers(1, 65, size=(batch,)),
        "user_tag": rng.integers(65, 73, size=(batch,)),
        "item_tag": rng.integers(73, 85, size=(batch,)),
        "history": np.where(step, rng.integers(1, 65, size=(batch, seq_len)), 0),
        "history_tags": np.where(step, rng.integers(73, 85, size=(batch, seq_len)), 0),
        "label": rng.integers(0, 2, size=(batch,)).astype(np.float32),
    }
    return info, data


def _check(cond: bool, msg: str) -> None:
    """The dry run's asserts, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def _step(trainer, state, batch) -> float:
    state, _, logs = trainer.train_step(state, trainer.device_batch(batch), trainer.metrics.init())
    loss = float(logs["loss"])
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    return loss


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, float]:
    """One DIN step in the dense, ``rowwise_adam`` and ``fused_adam``
    engines on the world's n ranks; returns each engine's loss."""
    import torch.distributed as dist

    from tpurec_torch.config import (
        EmbeddingConfig,
        ExperimentConfig,
        MeshConfig,
        ModelConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from tpurec_torch.embedding.modules import embedding_tables
    from tpurec_torch.train.trainer import Trainer

    world = dist.get_world_size() if dist.is_initialized() else 1
    first = not dist.is_initialized() or dist.get_rank() == 0

    def say(line):  # once a world
        if first:
            print(line, flush=True)

    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of {world}")
    model_axis = 2 if n_devices % 2 == 0 else 1
    data_axis = n_devices // model_axis
    info, batch = tiny_dataset(batch=max(16, 2 * data_axis))
    cfg = ExperimentConfig(
        model=ModelConfig(name="din", embedding=EmbeddingConfig(dim=8, used_id_l2=1e-6)),
        train=TrainConfig(batch_size=len(batch["label"]), compute_dtype="float32"),
        mesh=MeshConfig(data=data_axis, model=model_axis),
    )
    mesh = f"mesh=({data_axis},{model_axis})"

    def sharded_rows(state, what):
        table = embedding_tables(state.model)[0].embedding
        whole = embedding_tables(state.model)[0].whole(table)
        _check(table.shape[0] * model_axis == whole.shape[0], f"{what} rows not sharded over 'model'")

    trainer = Trainer(cfg, info, device=device)
    state = trainer.init_state(batch)
    if model_axis > 1:
        sharded_rows(state, "embedding")
        dense_0 = state.model.mlp.dense_0
        # the (out, in) weight: its output columns split
        _check(dense_0.split == "column"
               and dense_0.weight.shape[0] * model_axis == state.model.mlp.hidden_dims[0],
               "MLP kernel not tensor-parallel over 'model'")
    loss = _step(trainer, state, batch)
    say(f"dryrun_multichip ok: {n_devices} devices, {mesh}, "
        f"tp={'sharded' if model_axis > 1 else 'off'}, loss={loss:.4f}")

    cfg_s = cfg.replace(
        train=cfg.train.replace(sparse_embedding=True,
                                optimizer=OptimizerConfig(embedding_optimizer="rowwise_adam")),
        model=cfg.model.replace(embedding=cfg.model.embedding.replace(used_id_l2=0.0)),
    )
    trainer_s = Trainer(cfg_s, info, device=device)
    state_s = trainer_s.init_state(batch)
    if model_axis > 1:
        sharded_rows(state_s, "sparse-mode table")
        (opt,) = state_s.table_opt.values()
        _check(opt.v.shape[0] == embedding_tables(state_s.model)[0].embedding.shape[0],
               "row-wise state not sharded with its rows")
    loss_s = _step(trainer_s, state_s, batch)
    say(f"dryrun_multichip sparse ok: rowwise_adam on {mesh}, "
        f"tables={'row-sharded' if model_axis > 1 else 'single-shard'}, loss={loss_s:.4f}")

    cfg_f = cfg_s.replace(
        train=cfg_s.train.replace(optimizer=OptimizerConfig(embedding_optimizer="fused_adam")))
    trainer_f = Trainer(cfg_f, info, device=device)
    state_f = trainer_f.init_state(batch)
    if model_axis > 1:
        sharded_rows(state_f, "fused-mode table")
    loss_f = _step(trainer_f, state_f, batch)
    say(f"dryrun_multichip fused ok: fused_adam on {mesh}, "
        f"engine={'shard_map' if model_axis > 1 else 'global'}, loss={loss_f:.4f}")
    return {"dense": loss, "rowwise_adam": loss_s, "fused_adam": loss_f}


def _rank(n: int, rank: int, url: str, device: str) -> int:
    from tpurec_torch.core.distributed import initialize

    if device == "cuda":
        torch.cuda.set_device(0)
        backend = "nccl" if n == 1 else "gloo"
    else:
        backend = "gloo"
    initialize(url, n, rank, backend)
    import torch.distributed as dist

    try:
        dryrun_multichip(n, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def launch(n: int, device: str = "cuda", timeout: float = TIMEOUT) -> int:
    """Start n ranks of this module, each a fresh interpreter, and wait for
    them; the exit code is 0 when every rank ended with 0."""
    directory = tempfile.mkdtemp(prefix="tpurec_dryrun_")
    url = f"file://{os.path.join(directory, 'rendezvous')}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tpurec_torch.dryrun", str(n), "--device",
                               device, "--rank", str(r), "--url", url], env=env)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(directory, ignore_errors=True)
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"dryrun_multichip: rank exit codes {codes} (killed if negative)", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="ranks (devices) of the mesh")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--url", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    if args.rank is not None:
        return _rank(args.n, args.rank, args.url, args.device)
    return launch(args.n, args.device)


if __name__ == "__main__":
    sys.exit(main())
