"""CRC32-C (Castagnoli) — required by the TFRecord framing format
(counterpart of ``tpurec/data/crc32c.py``, the same checksums).

Three tiers, fastest available wins:
1. native C++ (slice-by-8, via ctypes): the repo's ``cpp/recordio.cc``,
   built at first use with ``g++`` and ``cpp/Makefile``'s flags into the
   git-ignored ``build/recordio/librecordio.so`` (nothing is written into
   ``cpp/``);
2. numpy batch mode: many independent messages CRC'd in lockstep (vectorized
   across messages, python loop only over byte positions);
3. pure-python scalar fallback.

The reference leans on TF's internal TFRecord writer (2.FM/Tools.py:8-54);
here the format is implemented from scratch so the framework has no TF
dependency.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_POLY = 0x82F63B78  # reflected Castagnoli polynomial
_MASK_DELTA = 0xA282EAD8

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "cpp", "recordio.cc")
LIBRARY = os.path.join(_ROOT, "build", "recordio", "librecordio.so")
# cpp/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-std=c++17"]


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()

# ---------------------------------------------------------------------------
# native fast path
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def build_library() -> str:
    """Compile ``cpp/recordio.cc`` into ``build/recordio/librecordio.so``
    unless it is there. Concurrent builders (threads, xdist workers) wait on
    one file lock; the library is written under a temporary name and renamed
    into place. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    if os.path.exists(LIBRARY):
        return LIBRARY
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    with open(LIBRARY + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(LIBRARY):  # built while this process waited
            return LIBRARY
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX) to build librecordio.so")
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building librecordio.so failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


def _load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on the first call; None when it cannot be
    built or loaded (the callers then take the Python codec)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            try:
                lib = ctypes.CDLL(build_library())
            except (OSError, RuntimeError):
                return None
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            _LIB = lib
        return _LIB


def crc32c_python(data: bytes) -> int:
    """The pure-python scalar tier."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ int(_TABLE[(crc ^ byte) & 0xFF])
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = _load_native()
    if lib is not None:
        return int(lib.crc32c(data, len(data)))
    return crc32c_python(data)


def crc32c_batch(messages: Sequence[bytes]) -> List[int]:
    """CRC32C of many messages, vectorized across the batch with numpy.

    The python loop runs over byte *positions* (bounded by the longest
    message), while each step processes every message at once.
    """
    lib = _load_native()
    if lib is not None:
        return [int(lib.crc32c(m, len(m))) for m in messages]
    if not messages:
        return []
    lens = np.array([len(m) for m in messages], dtype=np.int64)
    maxlen = int(lens.max())
    buf = np.zeros((len(messages), maxlen), dtype=np.uint8)
    for i, m in enumerate(messages):
        buf[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    crc = np.full(len(messages), 0xFFFFFFFF, dtype=np.uint32)
    for j in range(maxlen):
        active = j < lens
        nxt = (crc >> np.uint32(8)) ^ _TABLE[(crc ^ buf[:, j]) & np.uint32(0xFF)]
        crc = np.where(active, nxt, crc)
    crc ^= np.uint32(0xFFFFFFFF)
    return [int(c) for c in crc]


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF
