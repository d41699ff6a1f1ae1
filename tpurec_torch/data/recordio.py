"""TFRecord container format: framing, writers, readers (counterpart of
``tpurec/data/recordio.py``, the same bytes).

Frame layout (TFRecord on-disk format, implemented from scratch):

    uint64 length (LE) | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

``ShardedTFRecordWriter`` reproduces the reference ``CustomTFWriter`` contract
(2.FM/Tools.py:8-54): explicit train/test routing with shard rotation at a
per-file record cap — with the first-shard off-by-one fixed (the reference
counts one extra record into shard 0; see SURVEY §7 known quirks).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from tpurec_torch.data import crc32c as _crc


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return b"".join(
        [
            header,
            struct.pack("<I", _crc.masked_crc32c(header)),
            data,
            struct.pack("<I", _crc.masked_crc32c(data)),
        ]
    )


def iter_framed(path: str, verify: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify:
                if _crc.masked_crc32c(header) != hcrc:
                    raise IOError(f"corrupt record header in {path}")
                if _crc.masked_crc32c(data) != dcrc:
                    raise IOError(f"corrupt record data in {path}")
            yield data


class TFRecordWriter:
    """Single-file writer with batched CRC computation."""

    def __init__(self, path: str, flush_every: int = 1024):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._pending: List[bytes] = []
        self._flush_every = flush_every
        self.num_records = 0

    def write(self, data: bytes) -> None:
        self._pending.append(data)
        self.num_records += 1
        if len(self._pending) >= self._flush_every:
            self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        headers = [struct.pack("<Q", len(d)) for d in self._pending]
        hcrcs = [_crc.mask(c) for c in _crc.crc32c_batch(headers)]
        dcrcs = [_crc.mask(c) for c in _crc.crc32c_batch(self._pending)]
        chunks = []
        for h, hc, d, dc in zip(headers, hcrcs, self._pending, dcrcs):
            chunks += [h, struct.pack("<I", hc), d, struct.pack("<I", dc)]
        self._f.write(b"".join(chunks))
        self._pending = []

    def close(self) -> None:
        self._flush_pending()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedTFRecordWriter:
    """Routes records to train/test shard families, rotating files at
    ``records_per_file`` (reference: CustomTFWriter shard rotation,
    2.FM/Tools.py:40-54)."""

    def __init__(
        self,
        output_dir: str,
        records_per_file: int = 100_000,
        prefixes: Sequence[str] = ("train", "test"),
    ):
        self.output_dir = output_dir
        self.records_per_file = records_per_file
        os.makedirs(output_dir, exist_ok=True)
        self._writers: Dict[str, Optional[TFRecordWriter]] = {p: None for p in prefixes}
        self._counts: Dict[str, int] = {p: 0 for p in prefixes}
        self._shards: Dict[str, int] = {p: 0 for p in prefixes}
        self.paths: Dict[str, List[str]] = {p: [] for p in prefixes}

    def write(self, data: bytes, kind: str) -> None:
        if self._writers[kind] is None or self._counts[kind] >= self.records_per_file:
            self._rotate(kind)
        self._writers[kind].write(data)
        self._counts[kind] += 1

    def _rotate(self, kind: str) -> None:
        if self._writers[kind] is not None:
            self._writers[kind].close()
            self._shards[kind] += 1
        path = os.path.join(
            self.output_dir, f"{kind}_{self._shards[kind]:05d}.tfrecord"
        )
        self._writers[kind] = TFRecordWriter(path)
        self._counts[kind] = 0
        self.paths[kind].append(path)

    def close(self) -> None:
        for w in self._writers.values():
            if w is not None:
                w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(paths: Iterable[str], verify: bool = False) -> Iterator[bytes]:
    for path in paths:
        yield from iter_framed(path, verify=verify)


def write_columnar_shards(
    output_dir: str,
    kind: str,
    columns: Dict[str, "object"],
    records_per_file: int = 200_000,
) -> List[str]:
    """Write columnar arrays as TFRecord shards — native C++ encoder when
    built (tpurec_torch.data.native), per-row python codec otherwise.
    Returns the shard paths."""
    import numpy as np

    from tpurec_torch.data import native
    from tpurec_torch.data.example_proto import encode_example

    os.makedirs(output_dir, exist_ok=True)
    n = len(next(iter(columns.values())))
    paths: List[str] = []
    for shard, start in enumerate(range(0, n, records_per_file)):
        path = os.path.join(output_dir, f"{kind}_{shard:05d}.tfrecord")
        chunk = {k: v[start : start + records_per_file] for k, v in columns.items()}
        if native.native_available():
            native.encode_columnar_native(path, chunk)
        else:
            with TFRecordWriter(path) as w:
                m = len(next(iter(chunk.values())))
                for i in range(m):
                    feats = {}
                    for key, col in chunk.items():
                        val = col[i]
                        feats[key] = (
                            np.atleast_1d(val)
                            if isinstance(val, np.ndarray) or np.isscalar(val)
                            else val
                        )
                    w.write(encode_example(feats))
        paths.append(path)
    return paths
