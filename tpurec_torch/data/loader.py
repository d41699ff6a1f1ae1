"""Input pipeline: columnar in-memory batches from TFRecord shards
(counterpart of ``tpurec/data/loader.py``, the same batches).

The reference feeds training through ``tf.data`` TFRecordDataset pipelines
(2.FM/ModelManager.py:122-153) — and then defeats them by materializing whole
epochs in Python for shuffling (``iter(sorted(ds, key=random))``,
2.FM/ModelManager.py:185; SURVEY §7 quirks). Datasets at this scale are
O(100MB); this design decodes shards once into a columnar numpy store
(cached as .npz next to the shards), then serves device-ready batches: real
per-epoch shuffling, static batch shapes, per-host slicing for multi-host
feeding.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np

from tpurec_torch.data.example_proto import decode_example
from tpurec_torch.data.recordio import read_tfrecords


def decode_columnar(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """Decode Example records into column arrays. Scalar features become
    (N,), fixed-width list features (N, W).

    Fast path: the native C++ parser (cpp/recordio.cc) decodes each shard in
    bulk; the schema is inferred from the first record. Falls back to the
    pure-python codec when the library can't be built or the schema is
    ragged (or holds bytes)."""
    from tpurec_torch.data import native

    paths = list(paths)
    if native.native_available() and paths:
        try:
            first = decode_example(next(read_tfrecords(paths[:1])))
            schema = native.infer_schema(first)
            shards = [native.decode_columnar_native(p, schema) for p in paths]
            return {
                k: np.concatenate([s[k] for s in shards]) for k in schema
            }
        except (IOError, TypeError):
            pass  # ragged/bytes schema or corrupt → python fallback
    columns: Dict[str, List[np.ndarray]] = {}
    n = 0
    for raw in read_tfrecords(paths):
        feats = decode_example(raw)
        for key, val in feats.items():
            columns.setdefault(key, []).append(val)
        n += 1
    out = {}
    for key, vals in columns.items():
        if len(vals) != n:
            raise ValueError(f"feature {key!r} missing in some records")
        widths = {v.shape[0] for v in vals}
        if widths == {1}:
            out[key] = np.concatenate(vals)
        else:
            out[key] = np.stack(vals)
    return out


def load_columnar(
    paths: Sequence[str], cache: bool = True
) -> Dict[str, np.ndarray]:
    """decode_columnar with an .npz cache keyed by the shard list + mtimes."""
    paths = sorted(paths)
    if not paths:
        raise ValueError("no input shards")
    if cache:
        key = hashlib.sha1(
            "|".join(f"{p}:{os.path.getmtime(p)}:{os.path.getsize(p)}" for p in paths).encode()
        ).hexdigest()[:16]
        cache_path = os.path.join(
            os.path.dirname(paths[0]), f".columnar_cache_{key}.npz"
        )
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
    data = decode_columnar(paths)
    if cache:
        np.savez(cache_path, **data)
    return data


class ArrayLoader:
    """Batches over a columnar dict with per-epoch shuffling.

    ``host_id/num_hosts`` slice rows for multi-host feeding (each host loads
    its own 1/num_hosts of the data; the trainer shards the batch dim over
    'data' across that host's devices).
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        pad_final: bool = False,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        lengths = {k: len(v) for k, v in data.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.n = next(iter(lengths.values()))
        if num_hosts > 1:
            idx = np.arange(host_id, self.n, num_hosts)
            data = {k: v[idx] for k, v in data.items()}
            self.n = len(idx)
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder and not pad_final
        # pad_final: the last partial batch is wrap-padded to full size and a
        # '__weight__' column marks real rows — static batch shapes
        # with exact (weighted) eval metrics over every example
        self.pad_final = pad_final
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        end = (self.n // self.batch_size) * self.batch_size if self.drop_remainder else self.n
        for start in range(0, end, self.batch_size):
            idx = order[start : start + self.batch_size]
            real = len(idx)
            if real < self.batch_size:
                if not self.pad_final:
                    yield {k: v[idx] for k, v in self.data.items()}
                    continue
                pad = np.resize(order, self.batch_size - real)  # wrap-around
                idx = np.concatenate([idx, pad])
            batch = {k: v[idx] for k, v in self.data.items()}
            if self.pad_final:
                w = np.zeros(self.batch_size, np.float32)
                w[:real] = 1.0
                batch["__weight__"] = w
            yield batch


def shard_paths(directory: str, pattern_prefix: str) -> List[str]:
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith(pattern_prefix) and f.endswith(".tfrecord")
    )
