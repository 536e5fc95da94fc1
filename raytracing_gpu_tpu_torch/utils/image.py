"""Image I/O: ASCII P3 PPM matching the reference writer byte for byte
(cpu/printer.c:3-18, `"%d %d %d "` per pixel after an int truncation), its
reader, and RGBA8 PNG (gpu/rt.cpp:14-52) through zlib. NumPy copies of the
JAX package's `utils/image.py`.

Both writers take the native library's path (`native/`, byte-identical)
when `native` allows it: "auto" (the default) when the library builds,
"force" or RuntimeError, "never" for the Python path only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracing_gpu_tpu_torch.native import svati as native_lib


def _native_ppm_exact(img: np.ndarray) -> bool:
    """The native PPM writer gives the Python bytes when every value is
    exact in float32 and has at most three digits."""
    if not np.can_cast(img.dtype, np.float32, "safe"):
        return False
    return img.size == 0 or bool(img.min() > -1000) and bool(img.max() < 1000)


def write_ppm(path: str, image: np.ndarray, native: str = "auto") -> None:
    """Write an (H,W,3) image, float in [0,255] (truncated like the C int
    cast) or integer, as ASCII P3."""
    img = np.asarray(image)
    lib = native_lib.library(native)
    if lib is not None and _native_ppm_exact(img):
        native_lib.write_ppm_native(path, img)
        return
    if native == "force":
        raise ValueError("the native PPM writer takes values exact in float32 "
                         f"within (-1000, 1000); got {img.dtype}")
    with open(path, "wb") as f:
        f.write(ppm_bytes(img))


def ppm_bytes(image: np.ndarray) -> bytes:
    """The bytes `write_ppm` writes for `image`."""
    img = np.asarray(image).astype(np.int32)  # C float->int truncates toward zero
    h, w = img.shape[:2]
    body = "".join(f"{r} {g} {b} " for r, g, b in img.reshape(-1, 3))
    return (f"P3\n{w} {h}\n255\n" + body).encode()


def read_ppm(path: str) -> np.ndarray:
    """Read ASCII P3 (as the reference writes it) into (H,W,3) uint8."""
    with open(path, "rb") as f:
        toks = f.read().split()
    if toks[0] != b"P3":
        raise ValueError(f"not a P3 PPM: {path}")
    w, h, maxval = int(toks[1]), int(toks[2]), int(toks[3])
    pix = np.array(toks[4:4 + w * h * 3], dtype=np.int64)
    if maxval > 255:
        raise ValueError("only 8-bit PPM supported")
    return pix.reshape(h, w, 3).astype(np.uint8)


def write_png(path: str, image: np.ndarray, native: str = "auto") -> None:
    """Write (H,W,3) or (H,W,4) uint8 as an RGBA PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], axis=2)
    if native_lib.library(native) is not None:
        native_lib.write_png_native(path, img)
        return
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
