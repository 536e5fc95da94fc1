"""Procedural test scenes, as NumPy.

The same generators as the JAX package's `models/procedural.py`, operation
for operation, so both packages build bit-identical scenes from the same
arguments without the port importing JAX. `make_sphere_scene(512, 512,
n_lat=32, n_lon=40)` has 4,962 triangles, the size of the reference's largest
corpus scene; `make_sphere_grid_scene(512, 512)` has 96,000.
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


def _uv_sphere(center, radius, n_lat: int, n_lon: int):
    """Lat-long tessellated sphere with smooth per-vertex normals.

    Returns (vertices (t,3,3), normals (t,3,3)) float32 triangle soup.
    """
    cx, cy, cz = center
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)

    def pt(i, j):
        sl, cl = np.sin(lat[i]), np.cos(lat[i])
        so, co = np.sin(lon[j]), np.cos(lon[j])
        n = np.array([sl * co, cl, sl * so], np.float32)
        return np.array([cx, cy, cz], np.float32) + radius * n, n

    tris, norms = [], []
    for i in range(n_lat):
        for j in range(n_lon):
            p00, n00 = pt(i, j)
            p01, n01 = pt(i, j + 1)
            p10, n10 = pt(i + 1, j)
            p11, n11 = pt(i + 1, j + 1)
            if i > 0:  # skip degenerate top cap slivers
                tris.append([p00, p10, p01])
                norms.append([n00, n10, n01])
            if i < n_lat - 1:
                tris.append([p01, p10, p11])
                norms.append([n01, n10, n11])
    return np.asarray(tris, np.float32), np.asarray(norms, np.float32)


def _uv_sphere_fast(center, radius, n_lat: int, n_lon: int):
    """Vectorized `_uv_sphere` topology (row order (i, j), cap slivers
    dropped) for the large grid scene."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    sl, cl = np.sin(lat)[:, None], np.cos(lat)[:, None]
    so, co = np.sin(lon)[None, :], np.cos(lon)[None, :]
    n = np.stack(
        [sl * co, np.broadcast_to(cl, (n_lat + 1, n_lon + 1)), sl * so],
        axis=-1,
    ).astype(np.float32)  # (n_lat+1, n_lon+1, 3)
    p = np.asarray(center, np.float32) + np.float32(radius) * n

    def corners(a):
        return a[:-1, :-1], a[:-1, 1:], a[1:, :-1], a[1:, 1:]

    p00, p01, p10, p11 = corners(p)
    n00, n01, n10, n11 = corners(n)
    tri1 = np.stack([p00, p10, p01], axis=2)[1:].reshape(-1, 3, 3)
    nrm1 = np.stack([n00, n10, n01], axis=2)[1:].reshape(-1, 3, 3)
    tri2 = np.stack([p01, p10, p11], axis=2)[:-1].reshape(-1, 3, 3)
    nrm2 = np.stack([n01, n10, n11], axis=2)[:-1].reshape(-1, 3, 3)
    return np.concatenate([tri1, tri2]), np.concatenate([nrm1, nrm2])


def make_sphere_grid_scene(
    width: int = 128,
    height: int = 128,
    nx: int = 5,
    ny: int = 5,
    nz: int = 4,
    n_lat: int = 16,
    n_lon: int = 32,
    spacing: float = 2.5,
    pad_triangles: int = 256,
    pad_objects: int = 8,
) -> Scene:
    """An nx*ny*nz grid of tessellated spheres (the defaults give 100
    spheres, 96,000 triangles), no mirrors: the large-scene content on which
    tile culling decides the cost."""
    ext_x, ext_y, ext_z = (nx - 1) * spacing, (ny - 1) * spacing, (nz - 1) * spacing
    center = np.array([0.0, 0.0, 0.0], np.float32)
    camera = make_camera(
        width, height,
        center + np.array(
            [0.0, 0.35 * ext_y, -(0.75 * max(ext_x, ext_y) + ext_z + 6.0)],
            np.float32,
        ),
        np.array([-1.0, 0.0, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
        np.float32(70.0),
    )
    lights = [
        (AMBIENT, np.array([0.2, 0.2, 0.22], np.float32), np.zeros(3, np.float32)),
        (DIRECTIONAL, np.array([0.8, 0.75, 0.7], np.float32),
         np.array([0.4, -1.0, 0.6], np.float32)),
    ]
    palette = [
        (np.array([0.1, 0.1, 0.3], np.float32), np.array([0.25, 0.35, 0.85], np.float32)),
        (np.array([0.3, 0.1, 0.1], np.float32), np.array([0.85, 0.3, 0.25], np.float32)),
        (np.array([0.1, 0.25, 0.1], np.float32), np.array([0.3, 0.8, 0.35], np.float32)),
        (np.array([0.25, 0.22, 0.08], np.float32), np.array([0.85, 0.75, 0.3], np.float32)),
    ]
    objects = []
    i = 0
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                c = (
                    (ix - (nx - 1) / 2.0) * spacing,
                    (iy - (ny - 1) / 2.0) * spacing,
                    (iz - (nz - 1) / 2.0) * spacing,
                )
                v, n = _uv_sphere_fast(c, 1.0, n_lat, n_lon)
                ka, kd = palette[i % len(palette)]
                objects.append({
                    "vertices": v, "normals": n,
                    "ka": ka, "kd": kd,
                    "ks": np.array([0.4, 0.4, 0.4], np.float32),
                    "ns": np.float32(16.0), "ni": np.float32(1.0),
                    "nr": np.float32(0.0), "d": np.float32(1.0),
                })
                i += 1
    return build_scene(camera, lights, objects,
                       pad_triangles=pad_triangles, pad_objects=pad_objects)


def _quad(p0, p1, p2, p3, normal):
    v = np.array([[p0, p1, p2], [p0, p2, p3]], np.float32)
    n = np.broadcast_to(np.asarray(normal, np.float32), (2, 3, 3)).copy()
    return v, n


def make_sphere_scene(
    width: int = 64,
    height: int = 64,
    n_lat: int = 16,
    n_lon: int = 25,
    reflective: bool = True,
    pad_triangles: int = 128,
    pad_objects: int = 8,
) -> Scene:
    """A spheres.svati-like scene: two tessellated spheres over a ground
    plane, ambient + directional + point lights, mirror materials."""
    camera = make_camera(
        width, height,
        np.array([0.0, 2.0, -8.0], np.float32),
        np.array([-1.0, 0.0, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
        np.float32(90.0),
    )
    lights = [
        (AMBIENT, np.array([0.15, 0.15, 0.18], np.float32), np.zeros(3, np.float32)),
        (DIRECTIONAL, np.array([0.7, 0.65, 0.6], np.float32),
         np.array([0.3, -1.0, 0.5], np.float32)),
        (POINT, np.array([0.9, 0.3, 0.2], np.float32),
         np.array([-3.0, 4.0, -2.0], np.float32)),
    ]

    s1v, s1n = _uv_sphere((-1.6, 1.0, 0.0), 1.0, n_lat, n_lon)
    s2v, s2n = _uv_sphere((1.6, 1.2, 1.0), 1.2, n_lat, n_lon)
    gv, gn = _quad(
        (-20.0, 0.0, -20.0), (-20.0, 0.0, 20.0), (20.0, 0.0, 20.0), (20.0, 0.0, -20.0),
        (0.0, 1.0, 0.0),
    )

    objects = [
        {
            "vertices": s1v, "normals": s1n,
            "ka": np.array([0.1, 0.1, 0.3], np.float32),
            "kd": np.array([0.2, 0.3, 0.8], np.float32),
            "ks": np.array([0.6, 0.6, 0.6], np.float32),
            "ns": np.float32(32.0), "ni": np.float32(1.0),
            "nr": np.float32(0.45 if reflective else 0.0), "d": np.float32(1.0),
        },
        {
            "vertices": s2v, "normals": s2n,
            "ka": np.array([0.25, 0.1, 0.1], np.float32),
            "kd": np.array([0.8, 0.25, 0.2], np.float32),
            "ks": np.array([0.5, 0.5, 0.5], np.float32),
            "ns": np.float32(16.0), "ni": np.float32(1.0),
            "nr": np.float32(0.0), "d": np.float32(1.0),
        },
        {
            "vertices": gv, "normals": gn,
            "ka": np.array([0.12, 0.12, 0.12], np.float32),
            "kd": np.array([0.5, 0.5, 0.45], np.float32),
            "ks": np.array([0.1, 0.1, 0.1], np.float32),
            "ns": np.float32(4.0), "ni": np.float32(1.0),
            "nr": np.float32(0.85 if reflective else 0.0), "d": np.float32(1.0),
        },
    ]
    return build_scene(camera, lights, objects,
                       pad_triangles=pad_triangles, pad_objects=pad_objects)
