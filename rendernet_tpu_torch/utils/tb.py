"""Minimal TensorBoard events writer (scalars), dependency-free.

The port's own copy of ``rendernet_tpu/utils/tb.py``: the training loop
mirrors its numeric metrics into an ``events.out.tfevents.*`` file under
``<run>/tb`` (scalar parity with the reference's tf.summary writes,
RenderNet_Shader.py:169-173). Two tiny protobuf messages are encoded by
hand (Event{wall_time=1:double, step=2:int64, file_version=3:string,
summary=5:msg}; Summary{value=1:repeated Value{tag=1:string,
simple_value=2:float}}) and framed as TFRecords (length, masked CRC32C,
payload, masked CRC32C).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import List

__all__ = ["TBWriter"]

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = _pb_double(1, wall_time)
    if step:
        msg += _pb_int64(2, step)
    if file_version:
        msg += _pb_string(3, file_version.encode())
    if summary:
        msg += _pb_string(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_string(1, val)  # Summary.value (repeated field 1)


class TBWriter:
    """Append-only scalar events file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (int(time.time()), socket.gethostname())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=int(step), summary=_scalar_summary(tag, value)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
