"""TensorBoard scalar summary writer (counterpart of ``tpurec/core/summary.py``).

Writes standard ``events.out.tfevents.*`` files: TFRecord-framed ``Event``
protos with ``Summary.Value{tag, simple_value}``, readable by stock
TensorBoard, with no TF dependency. The record framing, CRC32C and varint
helpers are copies of the few the JAX package keeps in ``tpurec/data/``
(``recordio.frame_record``, ``crc32c.masked_crc32c``, ``example_proto``'s
writers); the port's ``data/`` comes in a later slice.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_POLY = 0x82F63B78  # reflected Castagnoli polynomial
_MASK_DELTA = 0xA282EAD8


def _make_table() -> list:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """uint64 length | uint32 masked crc(length) | data | uint32 masked crc(data)."""
    header = struct.pack("<Q", len(data))
    return b"".join(
        [
            header,
            struct.pack("<I", masked_crc32c(header)),
            data,
            struct.pack("<I", masked_crc32c(data)),
        ]
    )


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_tag(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _write_len_delim(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out += payload


def _encode_event(
    wall_time: float,
    step: int = 0,
    file_version: Optional[str] = None,
    tag: Optional[str] = None,
    simple_value: Optional[float] = None,
) -> bytes:
    # Event { double wall_time=1; int64 step=2; string file_version=3; Summary summary=5; }
    out = bytearray()
    _write_tag(out, 1, 1)
    out += struct.pack("<d", wall_time)
    if step:
        _write_tag(out, 2, 0)
        _write_varint(out, step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        _write_len_delim(out, 3, file_version.encode("utf-8"))
    if tag is not None:
        # Summary { repeated Value value=1; }; Value { string tag=1; float simple_value=2; }
        value = bytearray()
        _write_len_delim(value, 1, tag.encode("utf-8"))
        _write_tag(value, 2, 5)
        value += struct.pack("<f", float(simple_value))
        summary = bytearray()
        _write_len_delim(summary, 1, bytes(value))
        _write_len_delim(out, 5, bytes(summary))
    return bytes(out)


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, fname), "wb")
        self._f.write(
            frame_record(_encode_event(time.time(), file_version="brain.Event:2"))
        )

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            frame_record(
                _encode_event(time.time(), step=step, tag=tag, simple_value=value)
            )
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullSummaryWriter:
    """No-op writer used when no tensorboard_dir is configured."""

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
