"""ctypes binding of the native library: `.svati` parsing and image writing.

`library(native)` decides, for the three values of a `native=` argument,
whether a caller takes the native path: "never" -> None; "auto" -> the
loaded library, or None when RGT_NATIVE=0 or it cannot be built (the caller
then takes its Python path); "force" -> the loaded library, or RuntimeError.
The first call that needs the library builds it (`native/build.py`).
"""

from __future__ import annotations

import ctypes as ct
import functools

import numpy as np

from raytracing_gpu_tpu_torch.native import build

NATIVE_CHOICES = ("auto", "never", "force")


class _RgtScene(ct.Structure):
    """`struct RgtScene` of svati_parser.cpp."""

    _fields_ = [
        ("ok", ct.c_int32),
        ("error", ct.c_char * 512),
        ("width", ct.c_int32),
        ("height", ct.c_int32),
        ("position", ct.c_float * 3),
        ("u", ct.c_float * 3),
        ("v", ct.c_float * 3),
        ("fov", ct.c_float),
        ("n_lights", ct.c_int64),
        ("light_kind", ct.POINTER(ct.c_int32)),
        ("light_rgb", ct.POINTER(ct.c_float)),
        ("light_v", ct.POINTER(ct.c_float)),
        ("n_objects", ct.c_int64),
        ("ka", ct.POINTER(ct.c_float)),
        ("kd", ct.POINTER(ct.c_float)),
        ("ks", ct.POINTER(ct.c_float)),
        ("ns", ct.POINTER(ct.c_float)),
        ("ni", ct.POINTER(ct.c_float)),
        ("nr", ct.POINTER(ct.c_float)),
        ("d", ct.POINTER(ct.c_float)),
        ("tri_count", ct.POINTER(ct.c_int64)),
        ("n_triangles", ct.c_int64),
        ("vertices", ct.POINTER(ct.c_float)),
        ("normals", ct.POINTER(ct.c_float)),
    ]


@functools.cache
def _load():
    """(library, None) once built and loaded, else (None, the reason)."""
    try:
        lib = ct.CDLL(str(build.library_path()))
    except (RuntimeError, OSError) as e:
        return None, str(e)
    lib.rgt_parse.restype = ct.POINTER(_RgtScene)
    lib.rgt_parse.argtypes = [ct.c_char_p, ct.c_int64]
    lib.rgt_scene_free.restype = None
    lib.rgt_scene_free.argtypes = [ct.POINTER(_RgtScene)]
    lib.rgt_write_ppm.restype = ct.c_int32
    lib.rgt_write_ppm.argtypes = [ct.c_char_p, ct.POINTER(ct.c_float),
                                  ct.c_int64, ct.c_int64]
    lib.rgt_write_png.restype = ct.c_int32
    lib.rgt_write_png.argtypes = [ct.c_char_p, ct.POINTER(ct.c_uint8),
                                  ct.c_int64, ct.c_int64]
    return lib, None


def library(native: str = "auto"):
    """The loaded library or None, as `native` asks (see the module
    docstring)."""
    if native not in NATIVE_CHOICES:
        raise ValueError(f"native must be one of {NATIVE_CHOICES}, got {native!r}")
    if native == "never":
        return None
    if not build.enabled():
        reason = "RGT_NATIVE=0"
        lib = None
    else:
        lib, reason = _load()
    if lib is None and native == "force":
        raise RuntimeError(f"native library requested but not available: {reason}")
    return lib


def available() -> bool:
    return library("auto") is not None


def _as_np(ptr, n: int, dtype):
    if not n:
        return np.zeros((0,), dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_scene_native(path: str, pad_triangles: int = 128, pad_objects: int = 8):
    """The native twin of `models.parser.parse_scene_text` on a file: the
    port's Scene of CPU tensors; raises the port's SvatiParseError with the
    library's message."""
    from raytracing_gpu_tpu_torch.models.parser import SvatiParseError
    from raytracing_gpu_tpu_torch.models.scene import build_scene, make_camera

    lib = library("force")
    with open(path, "rb") as f:
        data = f.read()
    sp = lib.rgt_parse(data, len(data))
    try:
        s = sp.contents
        if not s.ok:
            raise SvatiParseError(s.error.decode())
        camera = make_camera(s.width, s.height, s.position[:], s.u[:], s.v[:],
                             np.float32(s.fov))
        L = int(s.n_lights)
        kinds = _as_np(s.light_kind, L, np.int32)
        rgb = _as_np(s.light_rgb, L * 3, np.float32).reshape(L, 3)
        lv = _as_np(s.light_v, L * 3, np.float32).reshape(L, 3)
        lights = [(int(kinds[i]), rgb[i], lv[i]) for i in range(L)]

        O = int(s.n_objects)
        vec = {k: _as_np(getattr(s, k), O * 3, np.float32).reshape(O, 3)
               for k in ("ka", "kd", "ks")}
        scal = {k: _as_np(getattr(s, k), O, np.float32) for k in ("ns", "ni", "nr", "d")}
        counts = _as_np(s.tri_count, O, np.int64)
        T = int(s.n_triangles)
        verts = _as_np(s.vertices, T * 9, np.float32).reshape(T, 3, 3)
        norms = _as_np(s.normals, T * 9, np.float32).reshape(T, 3, 3)
        objects, pos = [], 0
        for i in range(O):
            t = int(counts[i])
            obj = {k: a[i] for k, a in (*vec.items(), *scal.items())}
            obj.update(vertices=verts[pos:pos + t], normals=norms[pos:pos + t])
            objects.append(obj)
            pos += t
        return build_scene(camera, lights, objects, pad_triangles, pad_objects)
    finally:
        lib.rgt_scene_free(sp)


def write_ppm_native(path: str, image: np.ndarray) -> None:
    """ASCII P3 of an (H,W,3) image through `rgt_write_ppm`: each value cast
    to float32 and truncated toward zero, as the Python writer does, for
    values in (-1000, 1000)."""
    lib = library("force")
    img = np.ascontiguousarray(image, dtype=np.float32)
    h, w = img.shape[:2]
    if lib.rgt_write_ppm(str(path).encode(), img.ctypes.data_as(ct.POINTER(ct.c_float)),
                         w, h) != 0:
        raise OSError(f"rgt_write_ppm failed for {path}")


def write_png_native(path: str, image: np.ndarray) -> None:
    """RGBA8 PNG of an (H,W,4) uint8 image through `rgt_write_png`: the
    Python writer's bytes (the same zlib stream at level 9)."""
    lib = library("force")
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 4:
        raise ValueError(f"expected an (H,W,4) RGBA image, got {img.shape}")
    h, w = img.shape[:2]
    if lib.rgt_write_png(str(path).encode(), img.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                         w, h) != 0:
        raise OSError(f"rgt_write_png failed for {path}")
