"""Self-contained OpenEXR scanline codec (reader + fixture writer).

The port's own copy of ``fast3r_tpu/data/exr.py``.  The reference datasets
store depth as single-channel float EXR (MegaDepth/Habitat processed by
dust3r), read back via cv2 with OPENCV_IO_ENABLE_OPENEXR (reference
dust3r/utils/image.py:35-45).  The port has no cv2, so ``data.io.imread_cv2``
reads every EXR file through this pure-python implementation.

Supported: OpenEXR 2.0 single-part scanline files, compression NONE(0) /
ZIPS(2, zlib per scanline) / ZIP(3, zlib per 16-scanline block), channel
types HALF(1)/FLOAT(2)/UINT(0), increasing-y line order.  That covers
every EXR the mirrored datasets ship; anything else raises with a clear
message.  The ZIP predictor+deinterleave transform follows
OpenEXR/ImfZip.cpp.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 20000630
_PIXTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXCODE = {"uint32": 0, "float16": 1, "float32": 2}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes, off: int) -> Tuple[Dict, int]:
    attrs = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        _typ, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (_typ, buf[off:off + size])
        off += size
    return attrs, off + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        (ptype,) = struct.unpack_from("<i", data, off)
        off += 16  # type + pLinear/reserved + xSampling + ySampling
        chans.append((name, ptype))
    return chans


def _unpredict_deinterleave(data: bytes) -> bytes:
    """Inverse of OpenEXR's zip pre-transform (ImfZip::uncompress):
    running-sum byte predictor, then deinterleave the two halves."""
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    arr = arr.copy()
    arr[1:] -= 128
    arr = (np.cumsum(arr) % 256).astype(np.uint8)
    out = np.empty_like(arr)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predict_interleave(data: bytes) -> bytes:
    """Forward zip pre-transform (ImfZip::compress)."""
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.empty_like(arr)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    x = inter.astype(np.int32)
    d = np.concatenate([x[:1], (x[1:] - x[:-1] + 128)]) % 256
    return d.astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Decode an EXR file; (H, W) for one channel, else (H, W, C) with
    channels in alphabetical order (the EXR storage order)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise IOError(f"{path}: not an EXR file")
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR unsupported (scanline only)")
    attrs, off = _parse_header(buf, 8)

    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    if comp not in (0, 2, 3):
        raise IOError(f"{path}: compression {comp} unsupported "
                      "(NONE/ZIPS/ZIP only)")
    lines_per_chunk = {0: 1, 2: 1, 3: 16}[comp]
    n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk
    off += 8 * n_chunks  # skip the chunk offset table (chunks are in order)

    dtypes = [_PIXTYPES[t] for _, t in chans]
    row_bytes = sum(W * dt.itemsize for dt in dtypes)
    planes = [np.empty((H, W), dt) for dt in dtypes]

    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off:off + size]
        off += size
        ny = min(lines_per_chunk, y1 - y + 1)
        if comp in (2, 3) and size != ny * row_bytes:
            # (a chunk zlib could not shrink is stored raw, size == unpacked)
            raw = zlib.decompress(raw)
            if len(raw) < ny * row_bytes:
                raise IOError(f"{path}: short chunk at y={y}")
            raw = _unpredict_deinterleave(raw)
        pos = 0
        for line in range(ny):
            for plane, dt in zip(planes, dtypes):
                n = W * dt.itemsize
                plane[y - y0 + line] = np.frombuffer(raw, dt, W, pos)
                pos += n
    if len(planes) == 1:
        return planes[0]
    return np.stack(planes, axis=-1)


def write_exr(path: str, img: np.ndarray, compression: str = "zip",
              channel: str = "Y") -> str:
    """Encode a single-channel float32/float16 image (fixtures + export)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("write_exr supports single-channel images")
    if img.dtype not in (np.float32, np.float16, np.uint32):
        img = img.astype(np.float32)
    H, W = img.shape
    comp_code = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_chunk = {0: 1, 2: 1, 3: 16}[comp_code]

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    ptype = _PIXCODE[img.dtype.name]
    chan = (channel.encode() + b"\0" + struct.pack("<i", ptype)
            + b"\0\0\0\0" + struct.pack("<ii", 1, 1) + b"\0")
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    hdr = b"".join([
        attr("channels", "chlist", chan),
        attr("compression", "compression", bytes([comp_code])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\0"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0",
    ])
    chunks = []
    for y in range(0, H, lines_per_chunk):
        block = img[y:y + lines_per_chunk].astype(img.dtype.newbyteorder("<"))
        raw = block.tobytes()
        if comp_code:
            packed = zlib.compress(_predict_interleave(raw))
            if len(packed) >= len(raw):
                packed = raw  # EXR stores raw when zip does not shrink
        else:
            packed = raw
        chunks.append((y, packed))
    head = struct.pack("<ii", MAGIC, 2) + hdr
    off0 = len(head) + 8 * len(chunks)
    table = b""
    pos = off0
    for y, packed in chunks:
        table += struct.pack("<Q", pos)
        pos += 8 + len(packed)
    body = b"".join(struct.pack("<ii", y, len(packed)) + packed
                    for y, packed in chunks)
    with open(path, "wb") as f:
        f.write(head + table + body)
    return path
