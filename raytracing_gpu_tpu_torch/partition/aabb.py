"""Axis-aligned bounding boxes of objects and the slab test against them.

The JAX package's `partition/aabb.py` (reference: gpu/partitioning/aabb.cu):
per-object boxes as a segment min/max of the triangle vertices keyed by
`tri_obj`, seeded at +/-inf so a padding object keeps an empty (inf, -inf)
box that no ray hits; the slab test as branch-free min/max chains over
(rays x boxes).
"""

from __future__ import annotations

import torch

INF = float("inf")


def compute_object_aabbs(vertices, tri_obj, valid, n_objects: int):
    """Per-object boxes of a triangle soup: vertices (T,3,3), tri_obj (T,)
    int32, valid (T,) bool -> (O,2,3), [:,0] the min corner, [:,1] the max."""
    vmin = torch.where(valid[:, None, None], vertices, INF).amin(1)  # (T,3)
    vmax = torch.where(valid[:, None, None], vertices, -INF).amax(1)
    seg = tri_obj.long()[:, None].expand(-1, 3)
    omin = vertices.new_full((n_objects, 3), INF).scatter_reduce(
        0, seg, vmin, "amin")
    omax = vertices.new_full((n_objects, 3), -INF).scatter_reduce(
        0, seg, vmax, "amax")
    return torch.stack([omin, omax], 1)


def objects_valid(tri_obj, valid, n_objects: int):
    """(O,) bool: an object is valid iff it owns a valid triangle (padding
    triangles carry tri_obj 0)."""
    owned = torch.zeros((n_objects,), dtype=torch.int64, device=valid.device)
    return owned.index_add(0, tri_obj.long(), valid.long()) > 0


def compute_scene_aabb(obj_aabbs, obj_valid):
    """(2,3) bounds of the valid objects (find_scene_scale, octree.cu:51-115)."""
    mins = torch.where(obj_valid[:, None], obj_aabbs[:, 0], INF).amin(0)
    maxs = torch.where(obj_valid[:, None], obj_aabbs[:, 1], -INF).amax(0)
    return torch.stack([mins, maxs], 0)


def _slab_interval(origins, dirs, boxes):
    d = dirs[:, None, :]  # (R,1,3)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    o = origins[:, None, :]
    t1 = (boxes[None, :, 0, :] - o) * inv  # (R,B,3)
    t2 = (boxes[None, :, 1, :] - o) * inv
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def hit_aabb(origins, dirs, boxes):
    """Slab test of R rays against B boxes -> (R,B) bool (aabb.cu:202-243):
    intersections behind the origin count, as there. A zero direction
    component is nudged to 1e-30, so a ray that starts on a slab plane hits
    instead of being culled by a NaN."""
    tmin, tmax = _slab_interval(origins, dirs, boxes)
    return tmax >= tmin


def hit_aabb_forward(origins, dirs, boxes):
    """The slab test on the forward half-line (t >= 0) only: tighter, and
    still conservative for culling, since every accepted triangle hit has
    t > 0 (cpu/hit.c:59)."""
    tmin, tmax = _slab_interval(origins, dirs, boxes)
    return (tmax >= tmin) & (tmax >= 0.0)
