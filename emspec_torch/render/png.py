"""Minimal dependency-free PNG writer (offline renderer output, L4).

The reference renders to a desktop window (README.md:35-39); the rebuild's
product boundary is the display-ready uint8 RGBA raster [NS], and this
writer exists so humans can eyeball it (SURVEY.md §2.4 "offline PNG
renderer for eyeballing").  Stdlib zlib + struct only.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def tile_images(images: list[np.ndarray], pad: int = 2,
                pad_value: int = 32) -> np.ndarray:
    """Tile per-channel rasters into one near-square grid image
    (VERDICT round-1 #7: make multichannel output inspectable).

    images: list of (H, W, 4) uint8, all the same shape →
    (grid_h·H + pads, grid_w·W + pads, 4) uint8 with thin separators."""
    n = len(images)
    if n == 1:
        return images[0]
    h, w, c = images[0].shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    out = np.full((rows * h + (rows - 1) * pad,
                   cols * w + (cols - 1) * pad, c), pad_value, np.uint8)
    if c == 4:
        out[..., 3] = 255
    for i, img in enumerate(images):
        r, col = divmod(i, cols)
        y, x = r * (h + pad), col * (w + pad)
        out[y:y + h, x:x + w] = img
    return out


def png_chunk(tag: bytes, data: bytes) -> bytes:
    """One length-prefixed, CRC-suffixed PNG chunk (shared with apng.py)."""
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def filter0_scanlines(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 → (H, 1+W·C) uint8 filter-0 scanlines, one
    vectorized copy (shared with apng.py — the per-row Python join cost
    30 ms/frame at display size, 3.4× this).  C-contiguous, so zlib can
    compress it via the buffer protocol without another copy."""
    h, w, c = img.shape
    out = np.zeros((h, 1 + w * c), np.uint8)
    out[:, 1:] = np.ascontiguousarray(img).reshape(h, w * c)
    return out


def write_png(path: str | Path, rgba: np.ndarray) -> None:
    """Write (H, W, 4) uint8 RGBA (or (H, W, 3) RGB) as a PNG file."""
    img = np.asarray(rgba)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H,W,3|4) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    color_type = 6 if c == 4 else 2
    chunk = png_chunk

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    payload = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", ihdr)
               + chunk(b"IDAT", zlib.compress(filter0_scanlines(img), 6))
               + chunk(b"IEND", b""))
    Path(path).write_bytes(payload)


def decompress_exact(blob: bytes, expected: int, what: str) -> bytes:
    """zlib-decompress ``blob`` to EXACTLY ``expected`` bytes or raise
    ValueError — never more: the output is capped at ``expected`` before
    any allocation, so a crafted decompression bomb (a few KB expanding
    to GBs) costs at most ``expected`` bytes, and corrupt streams raise
    the decoders' documented ValueError instead of zlib.error
    (round-5 decoder-robustness sweep, VERDICT r4 #5)."""
    if not blob:
        raise ValueError(f"{what}: corrupt/missing compressed data")
    d = zlib.decompressobj()
    try:
        raw = d.decompress(blob, expected)
        extra = d.decompress(d.unconsumed_tail, 1)
    except zlib.error as e:
        raise ValueError(f"{what}: corrupt/missing compressed data") from e
    if len(raw) != expected or extra:
        raise ValueError(f"{what}: decompressed size != expected {expected}")
    return raw


def check_dims(w: int, h: int, c: int, what: str) -> int:
    """Validate header-claimed dimensions BEFORE they size any loop or
    allocation; → the scanline byte count h·(1 + w·c)."""
    expected = h * (1 + w * c)
    if w == 0 or h == 0 or expected > (1 << 31):
        raise ValueError(f"{what}: implausible dimensions {w}x{h}")
    return expected


def read_png(path: str | Path) -> np.ndarray:
    """Minimal decoder for PNGs written by :func:`write_png` (8-bit
    RGB/RGBA, filter 0 on every scanline, one IDAT stream) — enough for
    tests and tools to read our own output back without a dependency.

    Robustness contract (fuzz-pinned, tests/test_decoder_fuzz.py): any
    input either parses or raises ValueError — truncated chunks, lying
    length fields, zero/huge dimensions, corrupt or bomb zlib streams
    included."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, w = 8, None
    idat = []
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if len(body) != ln:
            raise ValueError(f"{path}: truncated chunk {tag!r}")
        if tag == b"IHDR":
            if ln < 10:
                raise ValueError(f"{path}: IHDR chunk too short ({ln})")
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color not in (2, 6):
                raise ValueError(f"{path}: unsupported PNG (not write_png output)")
            c = 4 if color == 6 else 3
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + ln
    if w is None or not idat:
        raise ValueError(f"{path}: truncated PNG (missing IHDR or IDAT)")
    expected = check_dims(w, h, c, str(path))
    raw = decompress_exact(b"".join(idat), expected, str(path))
    stride = 1 + w * c
    arr = np.frombuffer(raw, np.uint8).reshape(h, stride)
    if arr[:, 0].any():
        raise ValueError(f"{path}: non-zero PNG filter (not write_png output)")
    return arr[:, 1:].reshape(h, w, c)
