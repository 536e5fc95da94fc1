"""Image output: ASCII P3 PPM matching the reference writer byte for byte
(cpu/printer.c:3-18, `"%d %d %d "` per pixel after an int truncation) and
RGBA8 PNG (gpu/rt.cpp:14-52) through zlib. NumPy copies of the JAX package's
`utils/image.py` writers, without its native fast path."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H,W,3) image, float in [0,255] (truncated like the C int
    cast) or integer, as ASCII P3."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    vals = img.astype(np.int32)  # C float->int cast truncates toward zero
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write("".join(f"{r} {g} {b} " for r, g, b in vals.reshape(-1, 3)))


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H,W,3) or (H,W,4) uint8 as an RGBA PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], axis=2)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
