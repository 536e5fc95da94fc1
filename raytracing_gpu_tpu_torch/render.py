"""Render orchestration: the reference's two pipelines.

CPU mode (the JAX package's `render._render_cpu_mode`): rays for every
(pixel, 2x2 subsample) generated from ray ids chunk by chunk, block-swizzled
on the kernel backends so a 256-ray tile covers a compact pixel block, traced
through the emulated recursion of cpu/raytracer.c:19-34 (contribution
color_mul(shade, coef) per level, coef' = nr*coef, stop below 0.01 or on a
miss), and folded into pixels inside each chunk with the reference's clamped
0.25-weight accumulation (cpu/raytracer.c:55-68).

GPU mode (`render._render_gpu_mode`): one ray per pixel of an image
`aliasing` times larger in each direction, in row-major order, traced through
the do/while bounce loop of gpu/raytracer.cu:107-122 (first bounce
unconditional, shallow-first saturating accumulation, at most max_bounce + 1
iterations), then the uint8 box downscale of gpu/raytracer.cu:49-85.

Both bounce loops are Python loops with one `.any()` sync per bounce that
stop once no ray is alive; dead rays are parked (origin 3e29, direction 0) so
tile culling drops them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.fp import f32
from raytracing_gpu_tpu_torch.ops.colors import ColorOps
from raytracing_gpu_tpu_torch.ops.intersect import KERNEL_BACKENDS, collide
from raytracing_gpu_tpu_torch.ops.shading import PARKED, material_rows, shade


def required_depth(max_nr: float, cutoff: float, cap: int) -> int:
    """Recursion depth: smallest D with max_nr^D < cutoff, within [1, cap]."""
    if max_nr <= 0.0:
        return 1
    if max_nr >= 1.0:
        return cap
    d = int(math.ceil(math.log(cutoff) / math.log(max_nr)))
    return max(1, min(cap, d))


def _winner_nr(scene, hit):
    """(R,) reflection coefficient of each winning object."""
    if hit.mat is not None:
        return hit.mat[:, 10]
    return material_rows(scene.materials, hit.obj)[:, 10]


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, depth: int,
               pack=None):
    """Emulated recursive trace() for a batch of rays: (R,3) colors in the
    cfg.quantize domain. Contributions accumulate forward through the
    saturating add (associative for non-negative terms)."""
    cops = ColorOps(cfg.quantize)
    R = origins.shape[0]
    o, d = origins, dirs
    coef = origins.new_ones((R,))
    alive = torch.ones((R,), dtype=torch.bool, device=origins.device)
    color = cops.zeros((R,), device=origins.device)
    cutoff = f32(cfg.reflect_cutoff)
    for _ in range(depth):
        if not bool((alive & (coef >= cutoff)).any()):
            break
        hit, local = _hit_and_shade(scene, o, d, cfg, cops, pack)
        use = alive & (coef >= cutoff) & hit.mask
        color = cops.add(color, torch.where(use[:, None],
                                            cops.mul(local, coef[:, None]), 0.0))
        o, d = _bounce(o, d, hit, use)
        coef = torch.where(use, _winner_nr(scene, hit) * coef, 0.0)
        alive = use
    return color


def _hit_and_shade(scene, o, d, cfg, cops, pack):
    """One bounce's nearest hits and their locally shaded colors."""
    hit = collide(o, d, scene.geometry, cfg.mt_eps, cfg.self_hit_eps,
                  cfg.backend, pack, cfg.partitioning, cfg.f2b_tiles)
    local = shade(scene, hit, cops, cfg.mt_eps, cfg.self_hit_eps,
                  cfg.backend, pack, cfg.partitioning, cfg.any_hit_min_tris)
    return hit, local


def _bounce(o, d, hit, use):
    """Mirror rays of the rays in `use` — ray_bounce (cpu/ray.c:16-25) with
    the unnormalized normal; every other ray is parked, so tile culling
    skips it on later bounces."""
    n = hit.normal
    p = n * d
    refl = d - n * (2.0 * ((p[:, 0] + p[:, 1]) + p[:, 2]))[:, None]
    return (torch.where(use[:, None], hit.point, PARKED),
            torch.where(use[:, None], refl, 0.0))


def trace_rays_gpu(scene: Scene, origins, dirs, cfg: RenderConfig, pack=None):
    """The GPU pipeline's iterative bounce loop for a batch of rays:
    `do { tmp = trace(); color += tmp*nr_acc; nr_acc *= hit.nr } while
    (nr_acc > 0.01 && MAX_BOUNCE-- > 0)` (gpu/raytracer.cu:107-122). The
    first bounce is unconditional, accumulation is a shallow-first saturating
    add, and a ray stays alive while nr_acc > cutoff (strictly, where the CPU
    pipeline tests coef >= cutoff), for at most max_bounce + 1 iterations."""
    cops = ColorOps(cfg.quantize)
    R = origins.shape[0]
    o, d = origins, dirs
    nr_acc = origins.new_ones((R,))
    alive = torch.ones((R,), dtype=torch.bool, device=origins.device)
    color = cops.zeros((R,), device=origins.device)
    cutoff = f32(cfg.reflect_cutoff)
    for _ in range(cfg.max_bounce + 1):
        if not bool(alive.any()):
            break
        hit, local = _hit_and_shade(scene, o, d, cfg, cops, pack)
        use = alive & hit.mask
        color = cops.add(color, torch.where(use[:, None],
                                            cops.mul(local, nr_acc[:, None]), 0.0))
        o, d = _bounce(o, d, hit, use)
        nr_acc = nr_acc * torch.where(use, _winner_nr(scene, hit), 0.0)
        alive = use & (nr_acc > cutoff)
    return color


def _pick_block(width: int, height: int):
    """(Bx, By) pixel block for block-swizzled ray order (ideally 64 pixels,
    one 256-ray tile), or None when no candidate divides the image."""
    for bx, by in ((8, 8), (16, 4), (4, 16), (32, 2), (2, 32),
                   (8, 4), (4, 8), (4, 4)):
        if width % bx == 0 and height % by == 0:
            return bx, by
    return None


def _swiz_ray_ids(r, width: int, bx: int, by: int):
    """Block-swizzled ray position -> original ray id: pixel blocks in
    block-row-major order, row-major within a block, the 4 subsamples of a
    pixel kept adjacent."""
    nbx = width // bx
    pix = r // 4
    s = r % 4
    blkid = pix // (bx * by)
    within = pix % (bx * by)
    y = (blkid // nbx) * by + within // bx
    x = (blkid % nbx) * bx + within % bx
    return (y * width + x) * 4 + s


def _fold_subsamples(colors, cfg: RenderConfig):
    """(4k,3) subsample colors -> (k,3) pixels, accumulated in the
    reference's subsample order with clamped ops (cpu/raytracer.c:55-68)."""
    cops = ColorOps(cfg.quantize)
    x = colors.reshape(-1, 4, 3)
    acc = cops.zeros((x.shape[0],), device=colors.device)
    for s in range(4):
        acc = cops.add(acc, cops.mul(x[:, s], 0.25))
    return acc


def assemble_cpu_image(colors, cfg: RenderConfig, width: int, height: int):
    """(H*W*4,3) subsample colors -> (H,W,3) image in [0,255]."""
    return ColorOps(cfg.quantize).finalize(
        _fold_subsamples(colors, cfg)).reshape(height, width, 3)


def _trace_image(scene, cfg, depth, n_rays, coord_fn, pack=None,
                 gpu_semantics=False, fold4=False, ray_id_map=None):
    """Colors of n_rays rays, chunk by chunk, generating each chunk's rays
    from their ids with `coord_fn(ray_ids)` and tracing them through the CPU
    pipeline's recursion or, with gpu_semantics, the GPU pipeline's bounce
    loop. The tail chunk's ids are clamped to the last ray (its duplicates
    are sliced away). fold4 folds each chunk's 2x2 subsamples into pixels
    and returns (n_rays/4, 3); it needs a chunk size divisible by 4, so
    that a pixel's subsamples never straddle chunks."""
    chunk = min(cfg.ray_chunk, n_rays)
    dev = scene.device
    u, v, C = camera_ops.camera_basis(scene.camera)
    pos = scene.camera.position
    out = []
    for c0 in range(0, n_rays, chunk):
        r = torch.clamp(torch.arange(c0, c0 + chunk, device=dev), max=n_rays - 1)
        if ray_id_map is not None:
            r = ray_id_map(r)
        origins, dirs = camera_ops.make_rays(u, v, C, pos, coord_fn(r))
        if gpu_semantics:
            colors = trace_rays_gpu(scene, origins, dirs, cfg, pack)
        else:
            colors = trace_rays(scene, origins, dirs, cfg, depth, pack)
        out.append(_fold_subsamples(colors, cfg) if fold4 else colors)
    colors = torch.cat(out)
    return colors[:n_rays // 4] if fold4 else colors[:n_rays]


def _render_cpu_mode(scene: Scene, cfg: RenderConfig, depth: int, pack=None):
    """CPU-reference pipeline: (H,W,3) float32 image in [0,255] on the
    scene's device."""
    width, height = scene.camera.width, scene.camera.height
    n_rays = width * height * 4
    fold4 = min(cfg.ray_chunk, n_rays) % 4 == 0
    blk = _pick_block(width, height) if fold4 else None
    swiz = (blk is not None and cfg.backend in KERNEL_BACKENDS
            and cfg.block_rays in ("on", "auto"))
    ray_id_map = None
    if swiz:
        bx, by = blk
        ray_id_map = lambda r: _swiz_ray_ids(r, width, bx, by)  # noqa: E731
    coord_fn = functools.partial(camera_ops.cpu_subpixel_coords_traced,
                                 width, height)
    colors = _trace_image(scene, cfg, depth, n_rays, coord_fn, pack,
                          fold4=fold4, ray_id_map=ray_id_map)
    if not fold4:
        return assemble_cpu_image(colors, cfg, width, height)
    out = ColorOps(cfg.quantize).finalize(colors)
    if swiz:
        return (out.reshape(height // by, width // bx, by, bx, 3)
                .permute(0, 2, 1, 3, 4).reshape(height, width, 3))
    return out.reshape(height, width, 3)


def assemble_gpu_image(colors, cfg: RenderConfig, width: int, height: int):
    """(H*a * W*a, 3) hi-res colors -> (H,W,3) by the reference's box
    downscale (gpu/raytracer.cu:49-85): sum the uint8-quantized texels of
    each a x a box, / (255 a^2), * 255, clamp. The reference writes sample
    (px, py) flipped on both axes and its downscale un-flips the read but
    flips the write (gpu/raytracer.cu:67-84,97,128), so the image is the box
    average of the sample grid flipped on both axes."""
    a = cfg.aliasing
    hi = ColorOps(cfg.quantize).finalize(colors.reshape(height * a, width * a, 3))
    box = torch.trunc(hi).reshape(height, a, width, a, 3).sum((1, 3))
    lo = torch.clamp(box / (255.0 * a * a) * 255.0, 0.0, 255.0)
    return torch.flip(lo, (0, 1))


def _render_gpu_mode(scene: Scene, cfg: RenderConfig, pack=None):
    """GPU-reference pipeline: (H,W,3) float32 image in [0,255] on the
    scene's device. Rays go out in row-major order, unswizzled and unfolded,
    as in the JAX package."""
    width, height = scene.camera.width, scene.camera.height
    hw, hh = width * cfg.aliasing, height * cfg.aliasing
    # gpu/rt.cpp:78-79 multiplies the camera's width and height by aliasing
    # before rendering, so the image-plane distance uses the hi-res width
    scene_hi = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, width=hw, height=hh))
    coord_fn = functools.partial(camera_ops.gpu_pixel_coords_traced, hw, hh)
    colors = _trace_image(scene_hi, cfg, 0, hw * hh, coord_fn, pack,
                          gpu_semantics=True)
    return assemble_gpu_image(colors, cfg, width, height)


class SceneRenderer:
    """Renderer for repeated frames of one scene on one device.

    Moves the scene to `device` and, on the kernel backends, builds the
    kernel pack (clustering, packing, winner table) once; `render()` then
    only traces, through the pipeline `cfg.mode` names (`depth` is None in
    GPU mode, which caps bounces by `cfg.max_bounce`). `device="cuda"`
    raises when CUDA is not available: nothing falls back to the CPU unless
    `device="cpu"` is asked for.
    """

    def __init__(self, scene: Scene, cfg: RenderConfig = RenderConfig(),
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available; pass device='cpu' to render on the CPU")
        self.cfg = cfg
        self.width, self.height = scene.camera.width, scene.camera.height
        self.scene = scene.to(device)
        self.depth = None
        if cfg.mode == "cpu":
            max_nr = float(np.max(scene.materials.nr.cpu().numpy()))
            cap = (cfg.diff_max_depth if cfg.quantize == "smooth"
                   else cfg.cpu_max_depth)
            self.depth = required_depth(max_nr, cfg.reflect_cutoff, cap)
        self.pack = None
        if cfg.backend in KERNEL_BACKENDS:
            g = self.scene.geometry
            self.pack = ck.pack_geometry(g.vertices, g.valid, g.normals,
                                         g.tri_obj, self.scene.materials)

    @torch.no_grad()
    def render_device(self) -> torch.Tensor:
        """One frame, left on the device: (H,W,3) float32 in [0,255]."""
        if self.cfg.mode == "gpu":
            return _render_gpu_mode(self.scene, self.cfg, self.pack)
        return _render_cpu_mode(self.scene, self.cfg, self.depth, self.pack)

    def render(self) -> np.ndarray:
        """One frame as host numpy (H,W,3) float32 in [0,255]."""
        return self.render_device().cpu().numpy()


def render_scene(scene: Scene, cfg: RenderConfig = RenderConfig(),
                 device="cuda") -> np.ndarray:
    """Render a scene to an (H,W,3) float image in [0,255]; truncate to
    uint8 (or write with utils.image.write_ppm) for the reference's output."""
    return SceneRenderer(scene, cfg, device).render()
