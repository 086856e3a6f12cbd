"""A stdlib PNG decoder for 8-bit grayscale, non-interlaced images.

The fallback of `data/native_loader.py` where `native/volume_loader.cpp`
cannot be built or loaded (no compiler, no libpng): the JAX package falls
back to PIL there, which the card's host does not have.  It reads the
ProstateX slice format and nothing else: colour type 0, bit depth 8,
interlace 0, all five row filters (PNG specification, section 9).  Any
other PNG raises, naming the file.

The None, Sub and Up filters decode as whole-row numpy operations; Average
and Paeth depend on the pixel to the left and decode pixel by pixel.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter_average(line: bytearray, prior: bytes) -> None:
    left = 0
    for x in range(len(line)):
        left = (line[x] + ((left + prior[x]) >> 1)) & 0xFF
        line[x] = left


def _unfilter_paeth(line: bytearray, prior: bytes) -> None:
    left = up_left = 0
    for x in range(len(line)):
        up = prior[x]
        p = left + up - up_left
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
        if pa <= pb and pa <= pc:
            pred = left
        elif pb <= pc:
            pred = up
        else:
            pred = up_left
        left = (line[x] + pred) & 0xFF
        line[x] = left
        up_left = up


def decode_gray8(path: str) -> np.ndarray:
    """The (height, width) uint8 pixels of an 8-bit grayscale PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; the zlib decoder reads 8-bit grayscale, "
            "non-interlaced PNGs only")
    raw = zlib.decompress(b"".join(idat))
    stride = width + 1
    if len(raw) < stride * height:
        raise ValueError(f"{path}: truncated image data")
    rows = np.frombuffer(raw, np.uint8, stride * height).reshape(height, stride)
    out = np.empty((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:                       # Sub: a running sum mod 256
            out[y] = np.cumsum(line, dtype=np.uint8)
        elif kind == 2:                       # Up
            out[y] = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_unfilter_average if kind == 3 else _unfilter_paeth)(
                buf, prior.tobytes())
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind} in row {y}")
        prior = out[y]
    return out
