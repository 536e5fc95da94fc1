"""Object-level acceleration structures: per-object boxes and the flat
octree over them (the JAX package's `partition/`). Backend "torch" culls
(ray, object) pairs with them; the kernel backends cull (ray tile, triangle
tile) pairs on their own hierarchy and do not read them."""

from raytracing_gpu_tpu_torch.partition.aabb import (
    compute_object_aabbs,
    compute_scene_aabb,
    hit_aabb,
)
from raytracing_gpu_tpu_torch.partition.octree import (
    Octree,
    build_octree,
    position_keys,
)

__all__ = [
    "compute_object_aabbs",
    "compute_scene_aabb",
    "hit_aabb",
    "Octree",
    "build_octree",
    "position_keys",
]
