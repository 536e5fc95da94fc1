"""`.svati` scene parser.

The JAX package's parser (models/parser.py:47-221), which reproduces the
reference grammar and its quirks: whitespace tokens with `#` comments to end
of line, `object N` with N the vertex count, LIFO triangle rebuild (file
triangle (a,b,c) stored as (c,b,a), triangles in reverse order), material
defaults per init_object, and an error on unknown keywords. The Python code
here is the semantic definition; `parse_scene` takes the native C++
tokenizer (`native/svati_parser.cpp`, the same grammar, numbers parsed with
strtod and cast to float as `float()` then float32 does) when it is built.
"""

from __future__ import annotations

import numpy as np

from raytracing_gpu_tpu_torch.models.scene import (
    AMBIENT,
    DIRECTIONAL,
    POINT,
    Scene,
    build_scene,
    make_camera,
)
from raytracing_gpu_tpu_torch.native import svati as native_lib


class SvatiParseError(ValueError):
    pass


def _tokenize(text: str):
    """Yield whitespace-separated tokens, dropping `#`-to-EOL comments
    (fscanf("%s") plus the `#` handler, cpu/parser.c:108-109)."""
    i = 0
    n = len(text)
    while i < n:
        while i < n and text[i].isspace():
            i += 1
        if i >= n:
            return
        j = i
        while j < n and not text[j].isspace():
            j += 1
        tok = text[i:j]
        i = j
        if tok == "#":
            while i < n and text[i] != "\n":
                i += 1
        else:
            yield tok


class _TokenStream:
    def __init__(self, text: str):
        self._it = _tokenize(text)

    def next(self):
        return next(self._it, None)

    def floats(self, k: int):
        out = []
        for _ in range(k):
            tok = self.next()
            if tok is None:
                raise SvatiParseError("unexpected EOF while reading numbers")
            out.append(float(tok))
        return out


def _parse_object(ts: _TokenStream) -> dict:
    """Parse one object body (cpu/parse_obj.c:42-91)."""
    tok = ts.next()
    if tok is None:
        raise SvatiParseError("unexpected EOF after 'object'")
    vertex_count = int(tok)
    obj = {
        "ka": np.zeros(3, np.float32),
        "kd": np.zeros(3, np.float32),
        "ks": np.zeros(3, np.float32),
        "ns": 0.0,
        "ni": 1.0,
        "nr": 0.0,
        "d": 1.0,
    }
    vs: list[list[float]] = []
    vns: list[list[float]] = []
    cpt = 0
    while cpt < vertex_count * 2:
        tok = ts.next()
        if tok is None:
            break  # fscanf EOF ends the loop in the reference too
        if tok in ("Ka", "Kd", "Ks"):
            obj[tok.lower()] = np.array(ts.floats(3), np.float32)
        elif tok in ("Ns", "Ni", "Nr", "d"):
            obj[tok.lower()] = ts.floats(1)[0]
        elif tok == "v":
            cpt += 1
            vs.append(ts.floats(3))
        elif tok == "vn":
            cpt += 1
            vns.append(ts.floats(3))
        else:
            raise SvatiParseError(f"Error during parsing {tok}")

    # LIFO rebuild (cpu/parse_obj.c:82-88): pop 3 at a time from the top
    nv = min(len(vs), len(vns))
    varr = np.array(vs[:nv], np.float32) if nv else np.zeros((0, 3), np.float32)
    narr = np.array(vns[:nv], np.float32) if nv else np.zeros((0, 3), np.float32)
    varr = varr[::-1]
    narr = narr[::-1]
    ntri = nv // 3
    obj["vertices"] = varr[: ntri * 3].reshape(ntri, 3, 3)
    obj["normals"] = narr[: ntri * 3].reshape(ntri, 3, 3)
    return obj


def parse_scene_text(
    text: str, pad_triangles: int = 128, pad_objects: int = 8
) -> Scene:
    """Parse `.svati` source text into a Scene of CPU tensors."""
    ts = _TokenStream(text)
    camera = None
    lights: list[tuple[int, np.ndarray, np.ndarray]] = []
    objects: list[dict] = []
    while True:
        tok = ts.next()
        if tok is None:
            break
        if tok == "camera":
            vals = ts.floats(12)
            camera = make_camera(int(vals[0]), int(vals[1]), vals[2:5],
                                 vals[5:8], vals[8:11], vals[11])
        elif tok == "a_light":
            vals = ts.floats(3)
            lights.append((AMBIENT, np.array(vals, np.float32), np.zeros(3, np.float32)))
        elif tok == "d_light":
            vals = ts.floats(6)
            lights.append((DIRECTIONAL, np.array(vals[:3], np.float32),
                           np.array(vals[3:], np.float32)))
        elif tok == "p_light":
            vals = ts.floats(6)
            lights.append((POINT, np.array(vals[:3], np.float32),
                           np.array(vals[3:], np.float32)))
        elif tok == "object":
            objects.append(_parse_object(ts))
        else:
            raise SvatiParseError(f"Error during the parsing {tok}")

    if camera is None:
        raise SvatiParseError("scene has no camera")
    return build_scene(camera, lights, objects, pad_triangles, pad_objects)


def parse_scene(path: str, pad_triangles: int = 128, pad_objects: int = 8,
                native: str = "auto") -> Scene:
    """Parse a `.svati` file. `native`: "auto" takes the native tokenizer
    when the library builds (RGT_NATIVE=0 turns it off), "force" raises
    RuntimeError where it cannot, "never" parses in Python."""
    if native_lib.library(native) is not None:
        return native_lib.parse_scene_native(path, pad_triangles, pad_objects)
    with open(path, "r") as f:
        text = f.read()
    return parse_scene_text(text, pad_triangles, pad_objects)
