"""Pipeline inspection helpers (counterpart of ``tpurec/data/inspect.py``).

Parity with the reference's manual check utilities
(2.FM/utils.py:12-50, 1.MatrixCF/utils.py:8-45): peek at TFRecord shards,
sanity-check an exported model on one batch, and read a KV entry — as
importable functions instead of editable scripts.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from tpurec_torch.data.example_proto import decode_example
from tpurec_torch.data.recordio import read_tfrecords
from tpurec_torch.device import DeviceLike


def check_tf_record(path: str, num_records: int = 3) -> List[Dict[str, np.ndarray]]:
    """Decode and return the first records of a shard (reference
    check_tf_record prints them; here they're returned for assertions)."""
    out = []
    for raw in read_tfrecords([path]):
        out.append(decode_example(raw))
        if len(out) >= num_records:
            break
    return out


def check_inference(
    export_dir: str, data_dir: str, batch_size: int = 4, device: DeviceLike = "cuda"
) -> Dict[str, np.ndarray]:
    """Load a frozen export on ``device`` and score one synthetic batch drawn
    from the dataset's schema (reference check_inference loads the SavedModel
    and scores a hand-built batch). The batch is the JAX package's, drawn
    from the same seed."""
    from tpurec_torch.data.schema import DataInfo
    from tpurec_torch.serving.export import load_servable

    info = DataInfo.load(data_dir)
    servable = load_servable(export_dir, info, device=device)
    rng = np.random.default_rng(0)
    batch = {
        n: rng.integers(off, off + dim, size=(batch_size,))
        for n, off, dim in zip(info.feature_names, info.feature_offsets, info.feature_dims)
    }
    for c in info.continuous_names:
        batch[c] = rng.random(batch_size, dtype=np.float32)
    for s in info.sequence_names:
        batch[s] = rng.integers(
            1, max(2, info.total_dims // 2), size=(batch_size, info.max_seq_length)
        )
    out = servable.predict(batch)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def get_kv_value(kv_path: str, key: str) -> Optional[str]:
    """Read one entry of a persisted DictKVStore (reference get_redis_value)."""
    with open(kv_path) as f:
        return json.load(f).get(key)


def summarize_dataset(data_dir: str) -> Dict[str, object]:
    """Quick dataset card: schema + shard counts + row counts."""
    from tpurec_torch.data.loader import shard_paths
    from tpurec_torch.data.schema import DataInfo

    info = DataInfo.load(data_dir)
    summary: Dict[str, object] = {
        "features": list(info.feature_names),
        "dims": list(info.feature_dims),
        "total_ids": info.total_dims,
        "continuous": list(info.continuous_names),
        "sequences": list(info.sequence_names),
    }
    for kind in ("train", "test"):
        paths = shard_paths(data_dir, kind)
        n = sum(1 for _ in read_tfrecords(paths)) if paths else 0
        summary[f"{kind}_shards"] = len(paths)
        summary[f"{kind}_records"] = n
    return summary
