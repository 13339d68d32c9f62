"""Minimal dependency-free PNG writer (RGBA8), for goldens and CLI output."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 image as PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError("expected (H, W, C) uint8")
    h, w, c = image.shape
    if c == 3:
        image = np.concatenate(
            [image, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    color_type = 6  # RGBA

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG written by `write_png` (8-bit RGBA/RGB, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype, *_ = struct.unpack(">IIBBBBB", body)
            assert depth == 8 and ctype in (2, 6)
            channels = 4 if ctype == 6 else 3
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.empty((h, w, channels), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for row in range(h):
        ft = raw[row * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, stride, row * (stride + 1) + 1).copy()
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for i in range(channels, stride):
                line[i] = (line[i] + line[i - channels]) & 0xFF
        elif ft == 2:  # Up
            line = (line.astype(np.int32) + prev) % 256
            line = line.astype(np.uint8)
        else:
            raise NotImplementedError(f"png filter {ft}")
        out[row] = line.reshape(w, channels)
        prev = line
    return out
