"""Self-contained TensorBoard scalar event writer (no tensorboard package).

The port's own copy of ``fast3r_tpu/utils/tb_writer.py``.
Behavioral reference: the reference's TensorBoardLogger config
(configs/logger/tensorboard.yaml) — scalar metrics per step, readable by
`tensorboard --logdir`.  The environment has no tensorboard install, so this
writes the on-disk format directly: a TFRecord stream of `Event` protos
(tensorflow/core/util/event.proto), each record framed as

    uint64 length | uint32 masked_crc32c(length) | bytes data
    | uint32 masked_crc32c(data)

with the protos hand-encoded (only the scalar-summary subset is needed:
Event{wall_time=1, step=2, file_version=3, summary=5} and
Summary.Value{tag=1, simple_value=2}).  crc32c is the Castagnoli CRC with
TensorFlow's rotate-and-add masking.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, Tuple

# --------------------------------------------------------------------------
# crc32c (Castagnoli, reflected, poly 0x82F63B78) + TF masking
# --------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------
# minimal protobuf encoding
# --------------------------------------------------------------------------

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
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def encode_scalar_event(step: int, wall_time: float,
                        metrics: Dict[str, float]) -> bytes:
    """Event{wall_time, step, summary=Summary{value=[{tag, simple_value}]}}"""
    summary = b"".join(
        _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(v)))
        for tag, v in metrics.items()
    )
    return (_pb_double(1, wall_time) + _pb_varint(2, int(step))
            + _pb_bytes(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


def iter_records(blob: bytes) -> Iterator[bytes]:
    """Parse a TFRecord stream back into raw proto payloads (for tests)."""
    off = 0
    while off < len(blob):
        (length,) = struct.unpack_from("<Q", blob, off)
        header = blob[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", blob, off + 8)
        assert hcrc == masked_crc32c(header), "corrupt length crc"
        data = blob[off + 12:off + 12 + length]
        (dcrc,) = struct.unpack_from("<I", blob, off + 12 + length)
        assert dcrc == masked_crc32c(data), "corrupt data crc"
        yield data
        off += 16 + length


def decode_scalar_event(data: bytes) -> Tuple[int, Dict[str, float]]:
    """Inverse of encode_scalar_event (tests); returns (step, {tag: value})."""
    step, metrics = 0, {}
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(data, off)
            if field == 2:
                step = v
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(data, off)
            payload = data[off:off + ln]
            off += ln
            if field == 5:  # summary
                metrics.update(_decode_summary(payload))
    return step, metrics


def _read_varint(data: bytes, off: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7


def _decode_summary(data: bytes) -> Dict[str, float]:
    out = {}
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        if key >> 3 == 1 and key & 7 == 2:  # repeated Value
            ln, off = _read_varint(data, off)
            val = data[off:off + ln]
            off += ln
            tag, simple = None, None
            voff = 0
            while voff < len(val):
                vkey, voff = _read_varint(val, voff)
                if vkey >> 3 == 1 and vkey & 7 == 2:
                    vln, voff = _read_varint(val, voff)
                    tag = val[voff:voff + vln].decode()
                    voff += vln
                elif vkey >> 3 == 2 and vkey & 7 == 5:
                    (simple,) = struct.unpack_from("<f", val, voff)
                    voff += 4
                else:
                    raise ValueError(f"unexpected Value field {vkey}")
            if tag is not None:
                out[tag] = simple
    return out


class TBEventWriter:
    """Append-only scalar writer producing `events.out.tfevents.*` files."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        with open(self.path, "ab") as f:
            f.write(frame_record(encode_file_version_event(time.time())))

    def add_scalars(self, step: int, metrics: Dict[str, float]) -> None:
        finite = {k: float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float))}
        if not finite:
            return
        rec = frame_record(encode_scalar_event(step, time.time(), finite))
        with open(self.path, "ab") as f:
            f.write(rec)

    def close(self) -> None:
        pass
