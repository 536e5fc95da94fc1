"""Scenes of the benchmark's configurations, built from their JSON files.

A configuration file (`configs/<name>.json`) fixes the geometry, the light
positions, the mirror coefficients (`nr`), the shininess (`ns`) and the camera
pose; the cell's traffic file fixes the image size. `--seed` draws only the
colours (`ka`, `kd`, `ks` of every object and every light's rgb) within the
configuration's `colour_ranges`, so every seed traces the same rays to the
same depth and the work per frame does not depend on the seed.

`build(config, width, height, seed)` returns a `SceneArrays` of float32
NumPy arrays: the inputs that the program reads from the `.svati` text
`svati_text` writes, and that the plain reference reads as they are.
Each object entry names its shape, built by `scenes/<shape>.py`
(`build(spec) -> (vertices, normals)`): a new shape is a new file.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AMBIENT, DIRECTIONAL, POINT = 0, 1, 2
KINDS = {"ambient": AMBIENT, "directional": DIRECTIONAL, "point": POINT}
_SVATI_LIGHT = {AMBIENT: "a_light", DIRECTIONAL: "d_light", POINT: "p_light"}


@dataclasses.dataclass
class Obj:
    vertices: np.ndarray  # (t,3,3) float32
    normals: np.ndarray  # (t,3,3) float32
    ka: np.ndarray  # (3,)
    kd: np.ndarray
    ks: np.ndarray
    ns: float
    nr: float


@dataclasses.dataclass
class SceneArrays:
    width: int
    height: int
    position: np.ndarray  # (3,) float32
    u: np.ndarray
    v: np.ndarray
    fov: float  # a float32 value
    light_kind: tuple
    light_rgb: np.ndarray  # (L,3) float32
    light_v: np.ndarray  # (L,3) float32
    objects: list

    @property
    def n_triangles(self) -> int:
        return sum(o.vertices.shape[0] for o in self.objects)

    def soup(self):
        """(vertices (T,3,3), normals (T,3,3), tri_obj (T,) int64) in object
        order, and the (O,11) material table [ka kd ks ns nr]."""
        verts = np.concatenate([o.vertices for o in self.objects])
        norms = np.concatenate([o.normals for o in self.objects])
        tri_obj = np.concatenate([np.full(o.vertices.shape[0], i, np.int64)
                                  for i, o in enumerate(self.objects)])
        mats = np.stack([np.concatenate([o.ka, o.kd, o.ks, [o.ns, o.nr]])
                         for o in self.objects]).astype(np.float32)
        return verts, norms, tri_obj, mats


def shape(spec: dict):
    """(vertices (t,3,3), normals (t,3,3)) of one object entry of a
    configuration, from `scenes/<spec["shape"]>.py`'s `build(spec)`."""
    from portbench import harness

    verts, norms = harness.plugin("scenes", spec["shape"]).build(spec)
    return np.asarray(verts, np.float32), np.asarray(norms, np.float32)


def build(config: dict, width: int, height: int, seed: int) -> SceneArrays:
    """The configuration's scene at width x height, its colours drawn from
    `seed` (any integer)."""
    rng = np.random.default_rng(seed % (1 << 64))
    ranges = config["colour_ranges"]

    def draw(key):
        lo, hi = ranges[key]
        return rng.uniform(lo, hi, 3).astype(np.float32)

    objects = []
    for spec in config["objects"]:
        verts, norms = shape(spec)
        objects.append(Obj(verts, norms, draw("ka"), draw("kd"), draw("ks"),
                           float(np.float32(spec["ns"])), float(np.float32(spec["nr"]))))
    kinds, rgb, lv = [], [], []
    for light in config["lights"]:
        kind = KINDS[light["kind"]]
        kinds.append(kind)
        rgb.append(draw("ambient_rgb" if kind == AMBIENT else "light_rgb"))
        lv.append(np.asarray(light.get("v", (0.0, 0.0, 0.0)), np.float32))
    cam = config["camera"]
    return SceneArrays(width, height, np.asarray(cam["position"], np.float32),
                       np.asarray(cam["u"], np.float32), np.asarray(cam["v"], np.float32),
                       float(np.float32(cam["fov"])), tuple(kinds),
                       np.stack(rgb), np.stack(lv), objects)


def _g(x) -> str:
    # 9 significant digits give back the same float32 through strtod
    return "%.9g" % float(x)


def _vec(a) -> str:
    return " ".join(_g(x) for x in a)


def svati_text(s: SceneArrays) -> str:
    """The scene as `.svati` source. The reference's parser rebuilds an
    object's triangles from the top of its vertex stack (file triangle
    (a,b,c) becomes (c,b,a), the last one first), so every vertex list is
    written reversed and the file reads back as `s.objects` exactly."""
    lines = [f"camera {s.width} {s.height} {_vec(s.position)} {_vec(s.u)} "
             f"{_vec(s.v)} {_g(s.fov)}"]
    for kind, rgb, v in zip(s.light_kind, s.light_rgb, s.light_v):
        lines.append(f"{_SVATI_LIGHT[kind]} {_vec(rgb)}"
                     + ("" if kind == AMBIENT else f" {_vec(v)}"))
    for o in s.objects:
        t = o.vertices.shape[0]
        lines += [f"object {3 * t}", f"Ka {_vec(o.ka)}", f"Kd {_vec(o.kd)}",
                  f"Ks {_vec(o.ks)}", f"Ns {_g(o.ns)}", f"Nr {_g(o.nr)}"]
        vs = o.vertices.reshape(-1, 3)[::-1].astype(np.float64)
        ns = o.normals.reshape(-1, 3)[::-1].astype(np.float64)
        lines.append("\n".join(f"v {a:.9g} {b:.9g} {c:.9g}" for a, b, c in vs.tolist()))
        lines.append("\n".join(f"vn {a:.9g} {b:.9g} {c:.9g}" for a, b, c in ns.tolist()))
    return "\n".join(lines) + "\n"
