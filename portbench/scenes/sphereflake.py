"""sphereflake: one group of Haines' SPD sphereflake (`balls.c`), tessellated.

The flake: a root sphere of `radius` about `center`; each sphere has 9
children of a third its radius, touching it. In a sphere's own frame, whose
pole points away from its parent (the root's pole is +z, its azimuth 0 is
+x), 6 children lie on the equator at azimuths k*60 degrees and 3 at
elevation 60 degrees, azimuths 30, 150 and 270. A child's azimuth 0 is its
parent's pole, made square to the child's own pole (never parallel to it:
a child lies 90 or 30 degrees off its parent's pole); so placed, no two
spheres overlap. Levels 0..`depth` hold 1, 9, 81, ... spheres, in breadth-first
order: the children of sphere j of a level are spheres 9j..9j+8 of the next.

Each sphere of level L is `uv_sphere` at `levels[L]` = [n_lat, n_lon]. A
group is one sphere above `group_level`, or a sphere of `group_level` with
all its descendants; groups are numbered by their first sphere in
breadth-first order, and `build` returns group `group`'s triangles, its
first sphere's first.

The flake and the tessellated levels are computed once per process and
shared by the groups of one configuration.
"""

import functools

import numpy as np

from portbench import harness

CHILDREN = 9
RATIO = 1.0 / 3.0


def _directions():
    """(9, 3) child directions in the parent's frame."""
    out = [(np.cos(np.radians(60.0 * k)), np.sin(np.radians(60.0 * k)), 0.0)
           for k in range(6)]
    el = np.radians(60.0)
    out += [(np.cos(el) * np.cos(np.radians(a)), np.cos(el) * np.sin(np.radians(a)),
             np.sin(el)) for a in (30.0, 150.0, 270.0)]
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def spheres(center: tuple, radius: float, depth: int):
    """[(centres (9^L, 3) float64, radius)] for L = 0..depth."""
    c = np.asarray([center], np.float64)
    frames = np.eye(3)[None]  # columns: azimuth 0, azimuth 90, pole
    out = [(c, float(radius))]
    r = float(radius)
    for _ in range(depth):
        child_r = r * RATIO
        pole = np.einsum("nij,kj->nki", frames, _directions()).reshape(-1, 3)
        c = np.repeat(c, CHILDREN, axis=0) + (r + child_r) * pole
        up = np.repeat(frames[:, :, 2], CHILDREN, axis=0)
        e1 = up - (up * pole).sum(1, keepdims=True) * pole
        e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
        frames = np.stack([e1, np.cross(pole, e1), pole], axis=2)
        r = child_r
        out.append((c, r))
    return out


@functools.lru_cache(maxsize=None)
def _unit(n_lat: int, n_lon: int):
    """`uv_sphere`'s unit sphere about the origin: (vertices, normals),
    each (t, 3, 3) float32, equal to each other."""
    uv = harness.plugin("scenes", "uv_sphere")
    return uv.build({"center": [0.0, 0.0, 0.0], "radius": 1.0, "n_lat": n_lat,
                     "n_lon": n_lon})


def level_triangles(center: tuple, radius: float, depth: int, level: int, n_lat: int,
                    n_lon: int, first: int, count: int):
    """(vertices, normals) (count * t, 3, 3) float32 of spheres first..first+count-1
    of `level`: `uv_sphere.build` of each sphere's centre and radius, the
    same float32 operations."""
    centres, r = spheres(center, radius, depth)[level]
    unit_v, unit_n = _unit(n_lat, n_lon)
    c = centres[first:first + count].astype(np.float32)[:, None, None, :]
    verts = c + np.float32(r) * unit_v[None]
    norms = np.broadcast_to(unit_n[None], verts.shape)
    return verts.reshape(-1, 3, 3), norms.reshape(-1, 3, 3)


def groups(depth: int, group_level: int) -> list:
    """[(level, first sphere)] of each group's head, in group order."""
    heads = []
    for level in range(min(group_level, depth) + 1):
        heads += [(level, j) for j in range(CHILDREN ** level)]
    return heads


def build(spec: dict):
    center = tuple(float(x) for x in spec["center"])
    depth, group_level = int(spec["depth"]), int(spec["group_level"])
    head_level, head = groups(depth, group_level)[spec["group"]]
    verts, norms = [], []
    last = depth if head_level == group_level else head_level
    for level in range(head_level, last + 1):
        n = CHILDREN ** (level - head_level)  # the head's descendants there
        n_lat, n_lon = spec["levels"][level]
        v, nn = level_triangles(center, float(spec["radius"]), depth, level, n_lat, n_lon,
                                head * n, n)
        verts.append(v)
        norms.append(nn)
    return np.concatenate(verts), np.concatenate(norms)
