"""Key-value store for precomputed retrieval lists (counterpart of
``tpurec/serving/kvstore.py``): per-user
``<prefix>_<uid> → "i1,i2,...\\ts1,s2,..."`` strings. ``DictKVStore`` is a
process-local store persistable as JSON; ``RedisKVStore`` writes to a Redis
server when the ``redis`` package and a server are there."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional


class DictKVStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._data: Dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def set(self, key: str, value: str) -> None:
        self._data[key] = value

    def get(self, key: str) -> Optional[str]:
        return self._data.get(key)

    def keys(self) -> Iterator[str]:
        return iter(self._data)

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no path for DictKVStore.save")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._data, f)

    def __len__(self) -> int:
        return len(self._data)


class RedisKVStore:
    def __init__(self, host: str = "localhost", port: int = 6379, db: int = 0):
        import redis  # optional dependency

        self._r = redis.StrictRedis(host=host, port=port, db=db, decode_responses=True)

    def set(self, key: str, value: str) -> None:
        self._r.set(key, value)

    def get(self, key: str) -> Optional[str]:
        return self._r.get(key)


def open_kv_store(spec: str = "dict://"):
    """'dict://[path]' → DictKVStore; 'redis://host:port' → RedisKVStore."""
    if spec.startswith("dict://"):
        path = spec[len("dict://"):] or None
        return DictKVStore(path)
    if spec.startswith("redis://"):
        rest = spec[len("redis://"):] or "localhost:6379"
        host, _, port = rest.partition(":")
        return RedisKVStore(host or "localhost", int(port or 6379))
    raise ValueError(f"unknown kv store spec {spec!r}")
