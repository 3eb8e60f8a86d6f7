"""Dependency-free TensorBoard event-file writer (port of
``gmpi_tpu/utils/tb_writer.py``; for the same step, wall time and scalars it
encodes the same bytes).

The reference logs scalars through ``torch.utils.tensorboard``
(``gmpi/utils/tensorboard_utils.py:6-32`` — a SummaryWriter per run
directory, ``add_scalar`` per metric).  This module writes the same
``events.out.tfevents.*`` files TensorBoard consumes, with no tensorflow /
tensorboard / protobuf dependency: the Event protos are hand-encoded on the
wire (they are tiny and stable — varint fields + one nested Summary), and
the TFRecord framing uses a table-driven CRC-32C.

Format notes (both are public, frozen formats):

* TFRecord framing: ``uint64 length | uint32 masked_crc(length) | data |
  uint32 masked_crc(data)``, little-endian, where ``masked_crc(x) =
  rotr15(crc32c(x)) + 0xa282ead8``.
* Event proto fields used: 1 ``wall_time`` (double), 2 ``step`` (int64),
  3 ``file_version`` (string, first record only), 5 ``summary`` (message).
  Summary.Value fields: 1 ``tag`` (string), 2 ``simple_value`` (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto wire enc.


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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _summary_value(tag_name: str, value: float) -> bytes:
    return _f_bytes(1, tag_name.encode()) + _f_float(2, float(value))


def encode_scalar_event(step: int, wall_time: float, scalars: dict) -> bytes:
    """One Event proto carrying every (tag, simple_value) pair."""
    summary = b"".join(_f_bytes(1, _summary_value(k, v)) for k, v in scalars.items())
    return _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(5, summary)


def encode_file_version(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    hdr = struct.pack("<Q", len(data))
    return (hdr + struct.pack("<I", _masked_crc(hdr))
            + data + struct.pack("<I", _masked_crc(data)))


# --------------------------------------------------------------- writer


class SummaryWriter:
    """Minimal ``add_scalar``-style writer producing TensorBoard event files.

    Usage mirrors the reference's writer (one directory per run; scalars
    tagged by name).  ``add_scalars`` batches a whole metrics dict into a
    single Event record — one disk write per training step.
    """

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_file_version(time.time())))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars_dict({tag: value}, step)

    def add_scalars_dict(self, scalars: dict, step: int) -> None:
        ev = encode_scalar_event(step, time.time(), scalars)
        self._f.write(frame_record(ev))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# --------------------------------------------------------------- reader
# (test/debug aid — lets the unit test round-trip files without TensorBoard)


def read_events(path: str):
    """Parse an event file back into [(step, {tag: value})], verifying CRCs."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (length,) = struct.unpack("<Q", hdr)
            (crc_h,) = struct.unpack("<I", f.read(4))
            if crc_h != _masked_crc(hdr):
                raise ValueError("length CRC mismatch")
            data = f.read(length)
            (crc_d,) = struct.unpack("<I", f.read(4))
            if crc_d != _masked_crc(data):
                raise ValueError("data CRC mismatch")
            out.append(_decode_event(data))
    return [e for e in out if e is not None]


def _read_varint(buf: bytes, i: int):
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _decode_event(data: bytes):
    step, scalars, has_summary = 0, {}, False
    for field, wire, v in _fields(data):
        if field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:
            has_summary = True
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag = val = None
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            (val,) = struct.unpack("<f", v3)
                    if tag is not None:
                        scalars[tag] = val
    return (step, scalars) if has_summary else None
