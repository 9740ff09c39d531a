"""Minimal PNG/ APNG writers (stdlib only: zlib + struct).

The reference displays via PyGame (rendering.py:58); the
headless build exports frames instead. No imaging dependency needed for
8-bit RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def png_bytes(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as a PNG byte string."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    # Filter type 0 (None) per scanline.
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def write_apng(path: str, frames: list[np.ndarray], fps: float = 30.0) -> None:
    """Encode a frame sequence as an animated PNG."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    delay_num, delay_den = 1, max(1, int(round(fps)))
    out = [b"\x89PNG\r\n\x1a\n"]
    out.append(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
    out.append(_chunk(b"acTL", struct.pack(">II", len(frames), 0)))
    seq = 0
    for i, img in enumerate(frames):
        img = np.ascontiguousarray(img, np.uint8)
        if img.shape[:2] != (h, w):
            raise ValueError("frame size mismatch")
        fctl = struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0
        )
        out.append(_chunk(b"fcTL", fctl))
        seq += 1
        raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
        comp = zlib.compress(raw, 6)
        if i == 0:
            out.append(_chunk(b"IDAT", comp))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + comp))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
