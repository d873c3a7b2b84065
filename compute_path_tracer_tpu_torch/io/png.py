"""PNG image export without external imaging dependencies.

The headless analog of the reference's GUI "Save Image" path (reference:
src/state.rs:237-303): the HDR accumulator is gamma-2.2 encoded, quantized to
8-bit RGBA, y-flipped, and written as a PNG.  The encoder is a minimal
from-scratch implementation (signature + IHDR/IDAT/IEND chunks, zlib deflate)
so the package has zero imaging deps (JAX package: ``io/png.py``, without
its optional native encoder).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png_rgba(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 4) uint8 array as a PNG byte string."""
    if rgba.ndim != 3 or rgba.shape[2] != 4 or rgba.dtype != np.uint8:
        raise ValueError("expected (H, W, 4) uint8")
    h, w = rgba.shape[:2]
    # Prefix each scanline with filter byte 0 (None).
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", zlib.compress(raw, compress_level)),
            _chunk(b"IEND", b""),
        ]
    )


def hdr_to_rgba8(img: np.ndarray, gamma: float = 2.2, flip_y: bool = True) -> np.ndarray:
    """(H, W, 3) linear-HDR float -> (H, W, 4) uint8 with gamma encode and
    y-flip, matching the reference's export math (state.rs:280-292)."""
    img = np.asarray(img, np.float32)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    rgb8 = (img * 255.0 + 0.5).astype(np.uint8)
    if flip_y:
        rgb8 = rgb8[::-1]
    a = np.full(rgb8.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb8, a], axis=2)


def save_png(path: str, img: np.ndarray, gamma: float = 2.2, flip_y: bool = True) -> None:
    """Save a linear-HDR (H, W, 3) image as an 8-bit PNG file."""
    data = encode_png_rgba(hdr_to_rgba8(img, gamma=gamma, flip_y=flip_y))
    with open(path, "wb") as f:
        f.write(data)


def load_png_rgba(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests: 8-bit RGBA/RGB, filters 0-4."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type not in (2, 6):
        raise ValueError("only 8-bit RGB/RGBA supported")
    nch = 4 if color_type == 6 else 3
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for row in range(h):
        filt = raw[row * (stride + 1)]
        line = np.frombuffer(
            raw[row * (stride + 1) + 1 : (row + 1) * (stride + 1)], np.uint8
        ).copy()
        if filt == 0:
            cur = line
        elif filt == 2:  # Up
            cur = (line + prev).astype(np.uint8)
        elif filt in (1, 3, 4):  # Sub / Average / Paeth need sequential scan
            cur = np.zeros(stride, np.uint8)
            for i in range(stride):
                a = int(cur[i - nch]) if i >= nch else 0
                b = int(prev[i])
                c = int(prev[i - nch]) if i >= nch else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported filter {filt}")
        out[row] = cur
        prev = cur
    img = out.reshape(h, w, nch)
    if nch == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return img
