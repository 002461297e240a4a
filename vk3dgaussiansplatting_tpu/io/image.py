"""Frame output — the swapchain/present equivalent.

The reference presents RGBA8 swapchain images (Swapchain.cpp:20-48); headless
rendering writes frames to PNG instead.  PNG is written and read with the
standard library (`zlib`, `struct`) and numpy only: 8-bit RGB or RGBA,
non-interlaced, all five scanline filters on read.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}  # channels -> PNG color type (RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path, image_u8: np.ndarray) -> None:
    """Write an [H,W,3|4] uint8 image to PNG."""
    arr = np.asarray(image_u8)
    if arr.dtype != np.uint8:
        raise TypeError("expected uint8 image")
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"expected [H, W, 3|4], got {arr.shape}")
    h, w, c = arr.shape
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    )
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                elif ftype == 4:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG into [H, W, 3|4] uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _comp, _filt, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace})"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
