"""Minimal TensorBoard scalar event writer — zero dependencies; a copy of
``instance_segmentation_tpu/utils/tb_writer.py``.

Capability parity with the reference's tensorboardX scalar summaries
(ref utils/logger.py:61-75) without the tensorboardX/protobuf dependency:
hand-encodes the two tiny protos TensorBoard needs for scalars (Event and
Summary) and the TFRecord framing (length + masked CRC32C). Output files
(`events.out.tfevents.<ts>.<host>`) load in stock TensorBoard.

Wire format notes:
  * TFRecord: u64 length | u32 masked_crc(length_bytes) | data |
    u32 masked_crc(data); masked_crc(x) = rotr15(crc32c(x)) + 0xa282ead8.
  * Event proto: wall_time=1 (double), step=2 (int64),
    file_version=3 (string), summary=5 (message).
  * Summary proto: value=1 (repeated message); Summary.Value:
    tag=1 (string), simple_value=2 (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)
    return (_field_double(1, wall_time) + _field_varint(2, int(step)) +
            _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Append-only scalar event file writer (tensorboardX-compatible API)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, name), "ab")
        self._record(_version_event(time.time()))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._record(_scalar_event(tag, value, step,
                                   wall_time if wall_time is not None else time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
