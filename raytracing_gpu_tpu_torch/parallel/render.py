"""Sharded forward rendering: rays over the "tiles" axis, triangles over the
"scene" axis of a `parallel.mesh.Mesh`.

The JAX package's `parallel/render.py`, with its `shard_map` program run as
the same Python on every rank. Rays go to the tile ranks in contiguous
blocks (horizontal image bands); each rank of a scene group holds a
contiguous, ascending triangle range and combines its nearest hits and
shadow distances with the others' in every bounce (`ops/intersect.py`); the
image is assembled by one `all_gather` of each tile's colors over the tiles
group, so every rank returns the whole image.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.scene import Geometry, Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.parallel import collectives
from raytracing_gpu_tpu_torch.parallel.mesh import SCENE, TILES
from raytracing_gpu_tpu_torch.partition.apply import with_accel
from raytracing_gpu_tpu_torch.render import (
    _trace_chunked,
    assemble_cpu_image,
    assemble_gpu_image,
    frame_depth,
    hi_res_scene,
    resolve_device,
)


def split_scene(scene: Scene):
    """(geometry, the scene without its geometry): the triangle arrays are
    sharded over the scene axis, the rest is replicated."""
    return scene.geometry, dataclasses.replace(scene, geometry=None)


def check_shardable(scene: Scene, mesh) -> None:
    n_scene = mesh.shape[SCENE]
    T = scene.geometry.vertices.shape[0]
    if T % n_scene:
        raise ValueError(
            f"padded triangle count {T} not divisible by scene axis {n_scene}; "
            f"raise RenderConfig.pad_triangles to a multiple of {n_scene}"
        )


def shard_rows(x, mesh, axis: str = SCENE):
    """This rank's contiguous block of the rows of `x` along a mesh axis
    (its shard's along SCENE, its tile's along TILES)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over the {axis} axis of {n}")
    mesh.require_member()
    i, rows = (mesh.shard if axis == SCENE else mesh.tile), x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


def shard_geometry(geo: Geometry, mesh) -> Geometry:
    """This rank's triangles; the object-level acceleration data (boxes and
    octree, indexed by object) stays whole."""
    return dataclasses.replace(
        geo, **{k: shard_rows(getattr(geo, k), mesh)
                for k in ("vertices", "normals", "tri_obj", "valid")})


def _render_sharded(geo, rest, coords, mesh, cfg, depth, width, height):
    """(H,W,3) image on every rank from the whole geometry `geo`, the rest
    of the scene `rest` and the (R,2) plane coordinates of every ray."""
    mesh.require_member()
    R = coords.shape[0]
    pad = (-R) % mesh.shape[TILES]
    if pad:
        coords = torch.cat([coords, coords.new_zeros((pad, 2))])
    scene = dataclasses.replace(rest, geometry=shard_geometry(geo, mesh))
    u, v, C = camera_ops.camera_basis(scene.camera)
    origins, dirs = camera_ops.make_rays(u, v, C, scene.camera.position,
                                         shard_rows(coords, mesh, TILES))
    gpu = cfg.mode == "gpu"
    colors = _trace_chunked(scene, origins, dirs, cfg, depth, gpu_semantics=gpu,
                            scene_group=mesh.scene_group)
    colors = collectives.all_gather(colors, mesh.tiles_group)[:R]
    if gpu:
        return assemble_gpu_image(colors, cfg, width, height)
    return assemble_cpu_image(colors, cfg, width, height)


def make_sharded_renderer(mesh, cfg: RenderConfig, depth: int, width: int,
                          height: int, device="cuda"):
    """A (geo, rest, coords) -> (H,W,3) renderer bound to a mesh; the inputs
    are moved to `device` (`"cuda"` raises without a card). `geo` is the
    whole geometry: each rank keeps its own triangles. Recorded by autograd
    where an input requires grad (the tiles' colors come back through a
    gather whose backward keeps each rank's own block)."""
    device = resolve_device(device)

    def render(geo, rest, coords):
        return _render_sharded(geo.to(device), rest.to(device), coords.to(device),
                               mesh, cfg, depth, width, height)

    return render


def frame_inputs(scene: Scene, cfg: RenderConfig):
    """(scene, depth, (R,2) coords) of one frame: CPU mode's depth from the
    materials and its 2x2 subsamples in row-major order, or GPU mode's
    hi-res camera (the basis uses it, gpu/rt.cpp:78-79) and pixels."""
    if cfg.mode == "cpu":
        w, h = scene.camera.width, scene.camera.height
        ids = torch.arange(w * h * 4, device=scene.device)
        return (scene, frame_depth(scene, cfg),
                camera_ops.cpu_subpixel_coords_traced(w, h, ids))
    scene = hi_res_scene(scene, cfg)
    w, h = scene.camera.width, scene.camera.height
    ids = torch.arange(w * h, device=scene.device)
    return scene, 0, camera_ops.gpu_pixel_coords_traced(w, h, ids)


def render_scene_sharded(scene: Scene, cfg: RenderConfig, mesh,
                         to_host: bool = True, device="cuda"):
    """`render_scene` sharded over `mesh`: the same image, on every rank of
    the mesh (as host numpy, or with `to_host=False` as a tensor on
    `device`). `device="cuda"` raises without a card; only `device="cpu"`
    renders on the CPU. Every rank of the world calls it with the same
    scene."""
    width, height = scene.camera.width, scene.camera.height
    scene = scene.to(resolve_device(device))
    if cfg.partitioning != "none" and cfg.backend == "torch":
        # the object-level cull, built once from the whole scene; the kernel
        # backends cull tiles of their own shard instead
        scene, _ = with_accel(scene, cfg.partitioning)
    check_shardable(scene, mesh)
    scene, depth, coords = frame_inputs(scene, cfg)
    geo, rest = split_scene(scene)
    with torch.no_grad():
        img = _render_sharded(geo, rest, coords, mesh, cfg, depth, width, height)
    return img.cpu().numpy() if to_host else img
