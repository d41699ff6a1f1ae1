"""ctypes bindings for the native recordio runtime (counterpart of
``tpurec/data/native.py``): the library that ``tpurec_torch.data.crc32c``
builds from ``cpp/recordio.cc`` into ``build/recordio/`` at first use.

``decode_columnar_native`` is the bulk path behind ``tpurec_torch.data.loader``:
it parses a whole TFRecord shard of ``tf.train.Example`` records into
preallocated columnar numpy arrays in C++ (no protobuf library, no Python
per-record loop). Falls back cleanly when the library cannot be built.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from tpurec_torch.data.crc32c import _load_native

KIND_INT64 = 0
KIND_FLOAT32 = 1

_LONGS = ctypes.POINTER(ctypes.c_long)
_INTS = ctypes.POINTER(ctypes.c_int)
_POINTERS = ctypes.POINTER(ctypes.c_void_p)
# cpp/recordio.cc's signatures. Without them ctypes passes every Python int
# as a C int where the library takes a ``long``: the encoder crashed so on
# the GPU machine (Python 3.12.3)
_SIGNATURES = {
    "tfrecord_index": ([ctypes.c_char_p, _LONGS, _LONGS, ctypes.c_long], ctypes.c_long),
    "tfrecord_decode_columnar": (
        [ctypes.c_char_p, ctypes.c_char_p, _INTS, _LONGS, ctypes.c_long, _POINTERS,
         ctypes.c_long, ctypes.c_int],
        ctypes.c_long,
    ),
    "tfrecord_encode_columnar": (
        [ctypes.c_char_p, ctypes.c_char_p, _INTS, _LONGS, ctypes.c_long, _POINTERS,
         ctypes.c_long, ctypes.c_int],
        ctypes.c_long,
    ),
}


def _native():
    """The native library with its functions' signatures declared, or None."""
    lib = _load_native()
    if lib is None or not all(hasattr(lib, name) for name in _SIGNATURES):
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def native_available() -> bool:
    return _native() is not None


def _count_records(lib, path: str) -> int:
    cap = 1 << 16
    while True:
        offsets = np.zeros(cap, np.int64)
        lengths = np.zeros(cap, np.int64)
        n = lib.tfrecord_index(
            path.encode(),
            offsets.ctypes.data_as(_LONGS),
            lengths.ctypes.data_as(_LONGS),
            cap,
        )
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise IOError(f"tfrecord_index failed on {path} ({n})")
        return int(n)


def decode_columnar_native(
    path: str,
    schema: Dict[str, Tuple[int, int]],  # name → (kind, width)
    verify: bool = False,
) -> Dict[str, np.ndarray]:
    """Decode one shard into columnar arrays using the C++ parser."""
    lib = _native()
    if lib is None:
        raise RuntimeError("native librecordio.so with decoder not available")
    n_records = _count_records(lib, path)
    names = sorted(schema)
    name_blob = b"".join(n.encode() + b"\0" for n in names)
    kinds = np.asarray([schema[n][0] for n in names], np.int32)
    widths = np.asarray([schema[n][1] for n in names], np.int64)
    outputs = {}
    out_ptrs = (ctypes.c_void_p * len(names))()
    for i, n in enumerate(names):
        kind, width = schema[n]
        dtype = np.int64 if kind == KIND_INT64 else np.float32
        arr = np.zeros((n_records, width), dtype)
        outputs[n] = arr
        out_ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p)
    got = lib.tfrecord_decode_columnar(
        path.encode(),
        name_blob,
        kinds.ctypes.data_as(_INTS),
        widths.ctypes.data_as(_LONGS),
        len(names),
        out_ptrs,
        n_records,
        1 if verify else 0,
    )
    if got < 0:
        raise IOError(f"tfrecord_decode_columnar failed on {path} (code {got})")
    return {
        n: (arr[:got, 0] if schema[n][1] == 1 else arr[:got])
        for n, arr in outputs.items()
    }


def encode_columnar_native(
    path: str,
    columns: Dict[str, np.ndarray],
    append: bool = False,
) -> int:
    """Serialize columnar arrays as framed Example records in C++ (the
    write-side fast path used by the DataGenerators). Columns: (N,) or
    (N, W) int64/float32 arrays."""
    lib = _native()
    if lib is None:
        raise RuntimeError("native librecordio.so with encoder not available")
    names = sorted(columns)
    n = len(next(iter(columns.values())))
    name_blob = b"".join(nm.encode() + b"\0" for nm in names)
    kinds = []
    widths = []
    arrays = []
    for nm in names:
        arr = np.ascontiguousarray(columns[nm])
        if arr.ndim == 1:
            arr = arr[:, None]
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)
            kinds.append(KIND_INT64)
        else:
            arr = arr.astype(np.float32)
            kinds.append(KIND_FLOAT32)
        widths.append(arr.shape[1])
        arrays.append(arr)
    kinds_np = np.asarray(kinds, np.int32)
    widths_np = np.asarray(widths, np.int64)
    ptrs = (ctypes.c_void_p * len(names))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
    )
    got = lib.tfrecord_encode_columnar(
        path.encode(),
        name_blob,
        kinds_np.ctypes.data_as(_INTS),
        widths_np.ctypes.data_as(_LONGS),
        len(names),
        ptrs,
        n,
        1 if append else 0,
    )
    if got < 0:
        raise IOError(f"tfrecord_encode_columnar failed on {path} ({got})")
    return int(got)


def infer_schema(example_features: Dict[str, np.ndarray]) -> Dict[str, Tuple[int, int]]:
    """Schema from one decoded record (kind + fixed width per feature)."""
    schema = {}
    for name, val in example_features.items():
        if np.issubdtype(val.dtype, np.integer):
            kind = KIND_INT64
        elif np.issubdtype(val.dtype, np.floating):
            kind = KIND_FLOAT32
        else:
            raise TypeError(f"native decoder does not handle bytes feature {name!r}")
        schema[name] = (kind, int(val.shape[0]))
    return schema
