"""Attach the object-level acceleration data to a scene: the runtime form of
the reference's PARTITIONING_{NONE,AABB,OCTREE} build matrix
(gpu/CMakeLists.txt:12-15) and of `to_cuda`'s build-on-upload step."""

from __future__ import annotations

import dataclasses

import torch

from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.partition.aabb import (
    compute_object_aabbs,
    compute_scene_aabb,
    objects_valid,
)
from raytracing_gpu_tpu_torch.partition.octree import build_octree, node_cull_tables


@torch.no_grad()  # culling is a boolean pre-test: no gradient through the boxes
def with_accel(scene: Scene, partitioning: str):
    """(scene with `geometry.obj_aabb` and, for "octree", `geometry.octree`
    filled; the full Octree or None). Culling with them is conservative: a
    culled object never holds the nearest hit, so renders equal brute force."""
    if partitioning == "none":
        return scene, None
    if partitioning not in ("aabb", "octree"):
        raise ValueError(f"unknown partitioning {partitioning!r}")
    geo = scene.geometry
    n_obj = scene.materials.ns.shape[0]
    obj_valid = objects_valid(geo.tri_obj, geo.valid, n_obj)
    aabbs = compute_object_aabbs(geo.vertices, geo.tri_obj, geo.valid, n_obj)
    if partitioning == "aabb":
        return dataclasses.replace(
            scene, geometry=dataclasses.replace(geo, obj_aabb=aabbs)), None
    tree = build_octree(aabbs, compute_scene_aabb(aabbs, obj_valid), obj_valid)
    return dataclasses.replace(
        scene, geometry=dataclasses.replace(
            geo, obj_aabb=aabbs, octree=node_cull_tables(tree))), tree
