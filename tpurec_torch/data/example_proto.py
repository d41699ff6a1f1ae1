"""Minimal protobuf codec for ``tf.train.Example`` / ``SequenceExample``
(counterpart of ``tpurec/data/example_proto.py``, the same bytes).

Hand-rolled wire-format encode/decode for exactly the message subset the data
contract needs (int64/float/bytes feature lists, and feature_lists for padded
behavior sequences — reference: 5.DIN/DataGenerator.py:79-86 writes sequences
as ``tf.train.FeatureList``). No protobuf or TF dependency.

Wire format refresher: each field is ``tag = (field_number << 3) | wire_type``
followed by a varint (type 0), 8 bytes (1), length-delimited bytes (2), or
4 bytes (5). Packed repeated scalars are wire type 2.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

FeatureValue = Union[Sequence[int], Sequence[float], Sequence[bytes], np.ndarray]


# --------------------------------------------------------------------------
# varint / low-level writers
def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_len_delim(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out += payload


# --------------------------------------------------------------------------
# Feature encoding
def _encode_int64_list(values) -> bytes:
    # Int64List { repeated int64 value = 1 [packed]; }
    packed = bytearray()
    for v in values:
        _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
    out = bytearray()
    _write_len_delim(out, 1, bytes(packed))
    return bytes(out)


def _encode_float_list(values) -> bytes:
    # FloatList { repeated float value = 1 [packed]; }
    payload = np.asarray(values, dtype="<f4").tobytes()
    out = bytearray()
    _write_len_delim(out, 1, payload)
    return bytes(out)


def _encode_bytes_list(values) -> bytes:
    out = bytearray()
    for v in values:
        if isinstance(v, str):
            v = v.encode("utf-8")
        _write_len_delim(out, 1, v)
    return bytes(out)


def encode_feature(values: FeatureValue) -> bytes:
    """Feature { BytesList bytes_list=1; FloatList float_list=2; Int64List int64_list=3; }"""
    arr = values
    out = bytearray()
    if isinstance(arr, np.ndarray):
        if np.issubdtype(arr.dtype, np.integer):
            _write_len_delim(out, 3, _encode_int64_list(arr.reshape(-1)))
        elif np.issubdtype(arr.dtype, np.floating):
            _write_len_delim(out, 2, _encode_float_list(arr.reshape(-1)))
        else:
            _write_len_delim(out, 1, _encode_bytes_list(list(arr.reshape(-1))))
        return bytes(out)
    seq = list(arr) if not isinstance(arr, (list, tuple)) else arr
    if len(seq) == 0 or isinstance(seq[0], (int, np.integer)):
        _write_len_delim(out, 3, _encode_int64_list(seq))
    elif isinstance(seq[0], (float, np.floating)):
        _write_len_delim(out, 2, _encode_float_list(seq))
    elif isinstance(seq[0], (bytes, str)):
        _write_len_delim(out, 1, _encode_bytes_list(seq))
    else:
        raise TypeError(f"unsupported feature value type {type(seq[0])}")
    return bytes(out)


def decode_feature(buf: bytes) -> np.ndarray:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2
        length, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + length]
        pos += length
        if field == 3:  # Int64List
            return _decode_int64_list(payload)
        if field == 2:  # FloatList
            return _decode_float_list(payload)
        if field == 1:  # BytesList
            return _decode_bytes_list(payload)
    return np.asarray([], dtype=np.int64)


def _decode_int64_list(buf: bytes) -> np.ndarray:
    values: List[int] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # packed
            length, pos = _read_varint(buf, pos)
            end = pos + length
            while pos < end:
                v, pos = _read_varint(buf, pos)
                values.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif field == 1 and wire == 0:  # unpacked
            v, pos = _read_varint(buf, pos)
            values.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:
            raise ValueError("bad Int64List")
    return np.asarray(values, dtype=np.int64)


def _decode_float_list(buf: bytes) -> np.ndarray:
    values: List[float] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            length, pos = _read_varint(buf, pos)
            vals = np.frombuffer(buf[pos : pos + length], dtype="<f4")
            pos += length
            return np.asarray(vals, dtype=np.float32)
        elif field == 1 and wire == 5:
            values.append(struct.unpack("<f", buf[pos : pos + 4])[0])
            pos += 4
        else:
            raise ValueError("bad FloatList")
    return np.asarray(values, dtype=np.float32)


def _decode_bytes_list(buf: bytes) -> np.ndarray:
    values: List[bytes] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert field == 1 and wire == 2
        length, pos = _read_varint(buf, pos)
        values.append(buf[pos : pos + length])
        pos += length
    return np.asarray(values, dtype=object)


# --------------------------------------------------------------------------
# Features map / Example
def _encode_features(features: Dict[str, FeatureValue]) -> bytes:
    # Features { map<string, Feature> feature = 1; }
    # map entry = message { key=1 (string), value=2 (Feature) }
    out = bytearray()
    for key in sorted(features):
        entry = bytearray()
        _write_len_delim(entry, 1, key.encode("utf-8"))
        _write_len_delim(entry, 2, encode_feature(features[key]))
        _write_len_delim(out, 1, bytes(entry))
    return bytes(out)


def _decode_features(buf: bytes) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        assert tag >> 3 == 1 and tag & 7 == 2
        length, pos = _read_varint(buf, pos)
        entry = buf[pos : pos + length]
        pos += length
        epos = 0
        key = b""
        val = b""
        while epos < len(entry):
            etag, epos = _read_varint(entry, epos)
            elen, epos = _read_varint(entry, epos)
            payload = entry[epos : epos + elen]
            epos += elen
            if etag >> 3 == 1:
                key = payload
            else:
                val = payload
        out[key.decode("utf-8")] = decode_feature(val)
    return out


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Example { Features features = 1; }"""
    out = bytearray()
    _write_len_delim(out, 1, _encode_features(features))
    return bytes(out)


def decode_example(buf: bytes) -> Dict[str, np.ndarray]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        length, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + length]
        pos += length
        if tag >> 3 == 1:
            return _decode_features(payload)
    return {}


# --------------------------------------------------------------------------
# SequenceExample (context + feature_lists) — for padded behavior sequences
def encode_sequence_example(
    context: Dict[str, FeatureValue],
    sequences: Dict[str, Sequence[FeatureValue]],
) -> bytes:
    """SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }

    ``sequences[name]`` is a list of per-timestep feature values.
    """
    out = bytearray()
    _write_len_delim(out, 1, _encode_features(context))
    fl = bytearray()
    for key in sorted(sequences):
        # FeatureList { repeated Feature feature = 1; }
        flist = bytearray()
        for step in sequences[key]:
            _write_len_delim(flist, 1, encode_feature(step))
        entry = bytearray()
        _write_len_delim(entry, 1, key.encode("utf-8"))
        _write_len_delim(entry, 2, bytes(flist))
        _write_len_delim(fl, 1, bytes(entry))
    _write_len_delim(out, 2, bytes(fl))
    return bytes(out)


def decode_sequence_example(
    buf: bytes,
) -> Tuple[Dict[str, np.ndarray], Dict[str, List[np.ndarray]]]:
    context: Dict[str, np.ndarray] = {}
    sequences: Dict[str, List[np.ndarray]] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        length, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + length]
        pos += length
        field = tag >> 3
        if field == 1:
            context = _decode_features(payload)
        elif field == 2:
            fpos = 0
            while fpos < len(payload):
                ftag, fpos = _read_varint(payload, fpos)
                assert ftag >> 3 == 1
                flen, fpos = _read_varint(payload, fpos)
                entry = payload[fpos : fpos + flen]
                fpos += flen
                epos = 0
                key = b""
                steps: List[np.ndarray] = []
                while epos < len(entry):
                    etag, epos = _read_varint(entry, epos)
                    elen, epos = _read_varint(entry, epos)
                    epayload = entry[epos : epos + elen]
                    epos += elen
                    if etag >> 3 == 1:
                        key = epayload
                    else:  # FeatureList
                        lpos = 0
                        while lpos < len(epayload):
                            ltag, lpos = _read_varint(epayload, lpos)
                            assert ltag >> 3 == 1
                            llen, lpos = _read_varint(epayload, lpos)
                            steps.append(decode_feature(epayload[lpos : lpos + llen]))
                            lpos += llen
                sequences[key.decode("utf-8")] = steps
    return context, sequences
