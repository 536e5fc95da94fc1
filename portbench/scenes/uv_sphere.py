"""uv_sphere: a lat-long sphere of `radius` about `center`, n_lat bands of
n_lon columns, the cap slivers dropped (2 * n_lon * (n_lat - 1) triangles),
smooth per-vertex normals."""

import numpy as np


def build(spec: dict):
    """Rows i of latitude bands, columns j of longitude; the band's upper
    triangle is dropped at the top pole and its lower one at the bottom
    pole, where they are slivers."""
    n_lat, n_lon = spec["n_lat"], spec["n_lon"]
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    sl, cl = np.sin(lat)[:, None], np.cos(lat)[:, None]
    so, co = np.sin(lon)[None, :], np.cos(lon)[None, :]
    n = np.stack([sl * co, np.broadcast_to(cl, (n_lat + 1, n_lon + 1)), sl * so],
                 axis=-1).astype(np.float32)
    p = np.asarray(spec["center"], np.float32) + np.float32(spec["radius"]) * n
    tris, norms = [], []
    for i in range(n_lat):
        for j in range(n_lon):
            if i > 0:
                tris.append([p[i, j], p[i + 1, j], p[i, j + 1]])
                norms.append([n[i, j], n[i + 1, j], n[i, j + 1]])
            if i < n_lat - 1:
                tris.append([p[i, j + 1], p[i + 1, j], p[i + 1, j + 1]])
                norms.append([n[i, j + 1], n[i + 1, j], n[i + 1, j + 1]])
    return np.asarray(tris, np.float32), np.asarray(norms, np.float32)
