"""Scene model: dataclasses of padded SoA tensors.

The same layout as the JAX package's `models/scene.py`: triangles as a padded
(T,3,3) soup with per-triangle object ids, per-object Phong materials padded
to `pad_objects`, lights as (L,3) arrays with a static tuple of kinds. Every
float leaf is float32, object ids int32, the validity mask bool. Each
dataclass's `.to(device)` moves its tensors to one device; width, height,
counts and light kinds stay plain Python values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Light type codes (cpu/headers/scene.h; dispatch at cpu/light.c:40-97).
AMBIENT = 0
DIRECTIONAL = 1
POINT = 2


class _Tensors:
    """`.to(device)` for a dataclass: a copy with every tensor field moved
    (nested dataclasses too); other fields are kept."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), (torch.Tensor, _Tensors))
        })


@dataclasses.dataclass
class Camera(_Tensors):
    """`camera w h pos(3) u(3) v(3) fov` (cpu/parser.c:5-21)."""

    width: int
    height: int
    position: torch.Tensor  # (3,) f32
    u: torch.Tensor  # (3,) f32
    v: torch.Tensor  # (3,) f32
    fov: torch.Tensor  # () f32, degrees


@dataclasses.dataclass
class Lights(_Tensors):
    """kind: tuple of AMBIENT/DIRECTIONAL/POINT; rgb, v: (L,3) f32."""

    kind: tuple
    rgb: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class Geometry(_Tensors):
    """Triangle soup padded to `pad_triangles` with all-zero triangles.

    vertices/normals (T,3,3) f32, tri_obj (T,) int32, valid (T,) bool. Vertex
    order reproduces the reference's LIFO rebuild (see models/parser.py).
    """

    vertices: torch.Tensor
    normals: torch.Tensor
    tri_obj: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class Materials(_Tensors):
    """Per-object Phong materials padded to `pad_objects`: ka/kd/ks (O,3),
    ns/ni/nr/d (O,), defaults per init_object (cpu/parse_obj.c:3-20)."""

    ka: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    ns: torch.Tensor
    ni: torch.Tensor
    nr: torch.Tensor
    d: torch.Tensor


@dataclasses.dataclass
class Scene(_Tensors):
    """Full scene; n_triangles / n_objects are the unpadded counts."""

    camera: Camera
    lights: Lights
    geometry: Geometry
    materials: Materials
    n_triangles: int
    n_objects: int

    @property
    def device(self) -> torch.device:
        return self.geometry.vertices.device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else m


def _t(a, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))


def make_camera(width, height, position, u, v, fov) -> Camera:
    """Camera from host values (numpy or Python), as float32 tensors."""
    return Camera(width=int(width), height=int(height), position=_t(position),
                  u=_t(u), v=_t(v), fov=_t(fov))


def build_scene(
    camera: Camera,
    light_list: list[tuple[int, np.ndarray, np.ndarray]],
    objects: list[dict],
    pad_triangles: int = 128,
    pad_objects: int = 8,
) -> Scene:
    """Assemble a Scene from parsed host data (NumPy), with padding — the
    JAX package's `build_scene` (models/scene.py:187-264) leaf for leaf.

    objects: dicts with 'vertices' (t,3,3), 'normals' (t,3,3), 'ka','kd','ks'
    (3,) and 'ns','ni','nr','d' scalars.
    """
    n_objects = len(objects)
    n_triangles = int(sum(o["vertices"].shape[0] for o in objects))
    T = _round_up(max(n_triangles, 1), pad_triangles)
    O = _round_up(max(n_objects, 1), pad_objects)

    vertices = np.zeros((T, 3, 3), np.float32)
    normals = np.zeros((T, 3, 3), np.float32)
    # padding rows get a unit normal so the per-vertex normalize stays finite
    normals[:, :, 2] = 1.0
    tri_obj = np.zeros((T,), np.int32)
    valid = np.zeros((T,), bool)
    pos = 0
    for i, o in enumerate(objects):
        t = o["vertices"].shape[0]
        if t:
            vertices[pos:pos + t] = o["vertices"]
            normals[pos:pos + t] = o["normals"]
            tri_obj[pos:pos + t] = i
            valid[pos:pos + t] = True
            pos += t

    def mat_field(key, default, dim=()):
        arr = np.full((O,) + dim, default, np.float32)
        for i, o in enumerate(objects):
            arr[i] = o[key]
        return torch.from_numpy(arr)

    materials = Materials(
        ka=mat_field("ka", 0.0, (3,)),
        kd=mat_field("kd", 0.0, (3,)),
        ks=mat_field("ks", 0.0, (3,)),
        ns=mat_field("ns", 0.0),
        ni=mat_field("ni", 1.0),
        nr=mat_field("nr", 0.0),
        d=mat_field("d", 1.0),
    )

    L = max(len(light_list), 1)
    kind = [AMBIENT] * L
    rgb = np.zeros((L, 3), np.float32)
    lv = np.zeros((L, 3), np.float32)
    # no lights: one AMBIENT light with rgb=0 keeps the arrays non-empty
    for i, (k, c, v) in enumerate(light_list):
        kind[i] = int(k)
        rgb[i] = c
        lv[i] = v

    return Scene(
        camera=camera,
        lights=Lights(kind=tuple(kind), rgb=torch.from_numpy(rgb),
                      v=torch.from_numpy(lv)),
        geometry=Geometry(vertices=torch.from_numpy(vertices),
                          normals=torch.from_numpy(normals),
                          tri_obj=torch.from_numpy(tri_obj),
                          valid=torch.from_numpy(valid)),
        materials=materials,
        n_triangles=n_triangles,
        n_objects=n_objects,
    )


def scene_from_numpy(obj) -> Scene:
    """Port Scene from any object shaped like the JAX package's host Scene.

    Reads each leaf by attribute and converts it with `np.asarray`, so it
    needs no JAX import: the tests hand both packages the same scene this
    way. Dtypes are forced to the port's (float32 / int32 / bool).
    """
    cam, lights, geo, mats = obj.camera, obj.lights, obj.geometry, obj.materials
    return Scene(
        camera=make_camera(cam.width, cam.height, np.asarray(cam.position),
                           np.asarray(cam.u), np.asarray(cam.v),
                           np.asarray(cam.fov)),
        lights=Lights(kind=tuple(int(k) for k in lights.kind),
                      rgb=_t(np.asarray(lights.rgb)), v=_t(np.asarray(lights.v))),
        geometry=Geometry(vertices=_t(np.asarray(geo.vertices)),
                          normals=_t(np.asarray(geo.normals)),
                          tri_obj=_t(np.asarray(geo.tri_obj), np.int32),
                          valid=_t(np.asarray(geo.valid), bool)),
        materials=Materials(**{
            f.name: _t(np.asarray(getattr(mats, f.name)))
            for f in dataclasses.fields(Materials)
        }),
        n_triangles=int(obj.n_triangles),
        n_objects=int(obj.n_objects),
    )
