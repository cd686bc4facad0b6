"""Minimal TensorBoard event-file writer and reader, with no TensorFlow.

A copy of ``bigdl_tpu/visualization/tensorboard.py`` (numpy only): scalars
and histograms hand-encoded as protobuf ``Event`` messages, framed as
TFRecords (length, masked CRC32C of the length, payload, masked CRC32C of
the payload), which TensorBoard reads directly; :func:`read_events` decodes
them back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterable, Sequence

import numpy as np

# ------------------------------------------------------------------ CRC32C
# Castagnoli CRC table (polynomial 0x1EDC6F41, reflected 0x82F63B78).
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf enc
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


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_string(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def _pb_packed_doubles(field: int, vs: Iterable[float]) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vs)
    return _pb_bytes(field, payload)


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 } ; Summary{ value=1 } ;
    # Event{ wall_time=1, step=2, summary=5 }
    sv = _pb_string(1, tag) + _pb_float(2, float(value))
    summary = _pb_bytes(1, sv)
    return _pb_double(1, wall_time) + _pb_int64(2, int(step)) + _pb_bytes(5, summary)


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto{ min=1 max=2 num=3 sum=4 sum_squares=5 bucket_limit=6 bucket=7 }
    with TensorBoard's standard exponential bucketing."""
    values = np.asarray(values, np.float64).ravel()
    v = 1e-12
    neg = []
    pos = []
    while v < 1e20:
        pos.append(v)
        neg.append(-v)
        v *= 1.1
    limits = neg[::-1] + [0.0] + pos + [1e308]
    limits_arr = np.asarray(limits)
    idx = np.searchsorted(limits_arr, values, side="left")
    counts = np.bincount(idx, minlength=len(limits))
    nz = np.nonzero(counts)[0]
    if len(nz) == 0:
        bucket_limits, buckets = [0.0], [0.0]
    else:
        lo, hi = max(int(nz[0]) - 1, 0), min(int(nz[-1]) + 1, len(limits) - 1)
        bucket_limits = limits[lo:hi + 1]
        buckets = counts[lo:hi + 1].astype(np.float64)
    out = (_pb_double(1, float(values.min()) if values.size else 0.0)
           + _pb_double(2, float(values.max()) if values.size else 0.0)
           + _pb_double(3, float(values.size))
           + _pb_double(4, float(values.sum()))
           + _pb_double(5, float((values ** 2).sum()))
           + _pb_packed_doubles(6, bucket_limits)
           + _pb_packed_doubles(7, buckets))
    return out


def encode_histogram_event(tag: str, values: np.ndarray, step: int,
                           wall_time: float) -> bytes:
    sv = _pb_string(1, tag) + _pb_bytes(5, _histogram_proto(values))
    summary = _pb_bytes(1, sv)
    return _pb_double(1, wall_time) + _pb_int64(2, int(step)) + _pb_bytes(5, summary)


def encode_file_version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_string(3, "brain.Event:2")


# ------------------------------------------------------------------ writer
import itertools

#: per-process writer sequence number: two writers opened in the same second
#: on one host must not collide on (timestamp, hostname) alone — the pid
#: disambiguates across processes, the counter within one
_WRITER_SEQ = itertools.count()


class EventWriter:
    """Appends TFRecord-framed Event protos to one event file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.{next(_WRITER_SEQ)}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(encode_file_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(encode_scalar_event(tag, value, step, time.time()))
        self._f.flush()

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write_record(encode_histogram_event(tag, np.asarray(values), step,
                                                  time.time()))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_events(path: str):
    """Decode (tag, value-or-None, step) scalar triples from an event file.
    Histograms yield value=None. Used by ``read_scalar`` and tests."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # header crc
            payload = f.read(length)
            f.read(4)  # payload crc
            out.append(payload)
    return [_decode_event(p) for p in out]


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _decode_event(buf: bytes):
    """Minimal decoder for Event{wall_time, step, summary{value{tag, simple_value}}}."""
    pos, step, wall_time, values = 0, 0, 0.0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (val,) = struct.unpack("<d", buf[pos:pos + 8])
            pos += 8
            if field == 1:
                wall_time = val
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 2:
                step = val
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            if field == 5:  # summary
                values.extend(_decode_summary(sub))
        elif wire == 5:
            pos += 4
        else:
            break
    return {"step": step, "wall_time": wall_time, "values": values}


def _decode_summary(buf: bytes):
    vals, pos = [], 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            if field == 1:  # Summary.Value
                tag, simple = None, None
                p2 = 0
                while p2 < len(sub):
                    k2, p2 = _read_varint(sub, p2)
                    f2, w2 = k2 >> 3, k2 & 7
                    if w2 == 2:
                        l2, p2 = _read_varint(sub, p2)
                        if f2 == 1:
                            tag = sub[p2:p2 + l2].decode("utf-8")
                        p2 += l2
                    elif w2 == 5:
                        if f2 == 2:
                            (simple,) = struct.unpack("<f", sub[p2:p2 + 4])
                        p2 += 4
                    elif w2 == 0:
                        _, p2 = _read_varint(sub, p2)
                    elif w2 == 1:
                        p2 += 8
                vals.append((tag, simple))
        else:
            break
    return vals
