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
tile culling drops them. A `FrameLayout` (`cpu_frame`, `gpu_frame`) says how
a frame's rays are made and its image assembled; the eager chunk loop
(`_trace_image`) and the captured frame (`frame_plan`, a
`utils.frame_graph.FramePlan`: one chunk's rays, one bounce step and the
fold captured once and assembled into one CUDA graph whose loops run on
the device) both follow it, and
`SceneRenderer` takes the captured frame on the card.

The loops are differentiable as they stand (`render_image`, and
`parallel/train.py` through `trace_chunks`): a sweep only selects, and what
depends smoothly on the scene is recomputed on each ray's winner
(`ops/intersect.py`). With `cfg.remat` each bounce step is checkpointed and
its sweeps are kept on a `SweepTape`, so the backward pass recomputes the
step's arithmetic and the winner-row fetch but sweeps nothing again.
`SceneRenderer` renders without recording. On the card `render_image` is
compiled once per configuration and scene structure
(`utils.image_graph.ImagePlan`, over `IMAGE_PROGRAM`): the unrolled image
at a fixed depth (`unrolled_image`) as a forward and a backward CUDA graph,
or without grad in the while-loop strategy the frame program after a graph
that rebuilds its inputs (`frame_program_inputs`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.parser import parse_scene
from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.fp import f32
from raytracing_gpu_tpu_torch.ops.colors import ColorOps
from raytracing_gpu_tpu_torch.ops.intersect import (
    KERNEL_BACKENDS,
    SweepTape,
    collide,
)
from raytracing_gpu_tpu_torch.ops.shading import PARKED, material_rows, shade
from raytracing_gpu_tpu_torch.partition.apply import with_accel
from raytracing_gpu_tpu_torch.utils import image as image_io
from raytracing_gpu_tpu_torch.utils import profiling
from raytracing_gpu_tpu_torch.utils.frame_graph import (
    FrameLayout,
    FramePlan,
    uses_frame_graph,
)
from raytracing_gpu_tpu_torch.utils.image_graph import (
    ImageProgram,
    image_graph_blocker,
    image_plan,
    needs_grad,
    uses_image_graph,
)
from raytracing_gpu_tpu_torch.utils.profiling import annotate


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a card raises: nothing
    falls back to the CPU unless `device="cpu"` is asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available; pass device='cpu' to render on the CPU")
    return device


def required_depth(max_nr: float, cutoff: float, cap: int) -> int:
    """Recursion depth: smallest D with max_nr^D < cutoff, within [1, cap]."""
    if max_nr <= 0.0:
        return 1
    if max_nr >= 1.0:
        return cap
    d = int(math.ceil(math.log(cutoff) / math.log(max_nr)))
    return max(1, min(cap, d))


def frame_depth(scene, cfg) -> int:
    """CPU mode's recursion depth for a scene: from its materials' largest
    reflection coefficient, capped by `diff_max_depth` (smooth) or
    `cpu_max_depth` (match)."""
    max_nr = float(np.max(scene.materials.nr.cpu().numpy()))
    cap = cfg.diff_max_depth if cfg.quantize == "smooth" else cfg.cpu_max_depth
    return required_depth(max_nr, cfg.reflect_cutoff, cap)


def hi_res_scene(scene, cfg):
    """The scene with GPU mode's camera: gpu/rt.cpp:78-79 multiplies the
    camera's width and height by aliasing before rendering, so the
    image-plane distance uses the hi-res width."""
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, width=scene.camera.width * cfg.aliasing,
        height=scene.camera.height * cfg.aliasing))


def _winner_nr(scene, hit):
    """(R,) reflection coefficient of each winning object."""
    if hit.mat is not None:
        return hit.mat[:, 10]
    return material_rows(scene.materials, hit.obj)[:, 10]


def _bounce_step(scene, cfg, cops, pack, gpu_semantics, tape, scene_group,
                 o, d, coef, alive, color):
    """One bounce of either pipeline: nearest hits, their shaded colors
    added under the running coefficient, and the mirror rays of the rays
    still in use (every other ray is parked). `alive` comes in already
    narrowed to the rays this bounce traces. Spans "collide", "shade" and
    "update"."""
    with annotate("collide"):
        hit = collide(o, d, scene.geometry, cfg.mt_eps, cfg.self_hit_eps,
                      cfg.backend, pack, cfg.partitioning, cfg.f2b_tiles, tape,
                      scene_group)
    with annotate("shade"):
        local = shade(scene, hit, cops, cfg.mt_eps, cfg.self_hit_eps,
                      cfg.backend, pack, cfg.partitioning, cfg.any_hit_min_tris,
                      tape, scene_group)
    with annotate("update"):
        use = alive & hit.mask
        color = cops.add(color, torch.where(use[:, None],
                                            cops.mul(local, coef[:, None]), 0.0))
        o, d = _bounce(o, d, hit, use)
        if gpu_semantics:
            coef = coef * torch.where(use, _winner_nr(scene, hit), 0.0)
        else:
            coef = torch.where(use, _winner_nr(scene, hit) * coef, 0.0)
    return o, d, coef, use, color


def _trace(scene, origins, dirs, cfg, pack, n_bounces: int, gpu_semantics: bool,
           scene_group=None, fixed_depth: bool = False):
    """The bounce loop of both pipelines. CPU pipeline: a ray is traced
    while coef >= cutoff. GPU pipeline: the first bounce is unconditional and
    a ray stays alive while nr_acc > cutoff (strictly). With a
    `scene_group` the scene holds this rank's triangles only (see
    `ops.intersect`). The loop stops once no ray is alive (a host read per
    bounce), unless `fixed_depth`: then it runs all `n_bounces` steps, as
    the JAX package's differentiable strategy does, and reads nothing back
    (what a captured training step runs). A step whose rays are all dead
    adds exact zeros, so the colors are the same either way. The recorder
    counts the rays each step traces and its slots."""
    cops = ColorOps(cfg.quantize)
    R = origins.shape[0]
    cutoff = f32(cfg.reflect_cutoff)
    remat = cfg.remat and cfg.resolve_unroll() and torch.is_grad_enabled()
    state = (origins, dirs, origins.new_ones((R,)),
             torch.ones((R,), dtype=torch.bool, device=origins.device),
             cops.zeros((R,), device=origins.device))
    for _ in range(n_bounces):
        o, d, coef, alive, color = state
        if not gpu_semantics:
            alive = alive & (coef >= cutoff)
        # every shard of a scene group holds the same rays and the combined
        # hits, so their loops end together; ranks of a tiles group may stop
        # at different bounces, so no collective may cross that group here
        if not fixed_depth and not bool(alive.any()):
            break
        profiling.count("live_rays", alive)
        profiling.count("ray_slots", alive.numel())
        if remat:
            tape = SweepTape()
            step = functools.partial(_bounce_step, scene, cfg, cops, pack,
                                     gpu_semantics, tape, scene_group)
            state = checkpoint(step, o, d, coef, alive, color,
                               use_reentrant=False, preserve_rng_state=False)
            tape.rewind()
        else:
            state = _bounce_step(scene, cfg, cops, pack, gpu_semantics, None,
                                 scene_group, o, d, coef, alive, color)
        if gpu_semantics:
            o, d, coef, alive, color = state
            state = (o, d, coef, alive & (coef > cutoff), color)
    return state[4]


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, depth: int,
               pack=None, scene_group=None, fixed_depth: bool = False):
    """Emulated recursive trace() for a batch of rays: (R,3) colors in the
    cfg.quantize domain. Contributions accumulate forward through the
    saturating add (associative for non-negative terms). `fixed_depth`: see
    `_trace`."""
    return _trace(scene, origins, dirs, cfg, pack, depth, False, scene_group,
                  fixed_depth)


def _bounce(o, d, hit, use):
    """Mirror rays of the rays in `use` — ray_bounce (cpu/ray.c:16-25) with
    the unnormalized normal; every other ray is parked, so tile culling
    skips it on later bounces."""
    n = hit.normal
    p = n * d
    refl = d - n * (2.0 * ((p[:, 0] + p[:, 1]) + p[:, 2]))[:, None]
    return (torch.where(use[:, None], hit.point, PARKED),
            torch.where(use[:, None], refl, 0.0))


def trace_rays_gpu(scene: Scene, origins, dirs, cfg: RenderConfig, pack=None,
                   scene_group=None, fixed_depth: bool = False):
    """The GPU pipeline's iterative bounce loop for a batch of rays:
    `do { tmp = trace(); color += tmp*nr_acc; nr_acc *= hit.nr } while
    (nr_acc > 0.01 && MAX_BOUNCE-- > 0)` (gpu/raytracer.cu:107-122). The
    first bounce is unconditional, accumulation is a shallow-first saturating
    add, and a ray stays alive while nr_acc > cutoff (strictly, where the CPU
    pipeline tests coef >= cutoff), for at most max_bounce + 1 iterations.
    `fixed_depth`: see `_trace`."""
    return _trace(scene, origins, dirs, cfg, pack, cfg.max_bounce + 1, True,
                  scene_group, fixed_depth)


def _kernel_pack(scene, cfg):
    """The kernel backends' pack of the scene's current geometry (its table
    carries gradient to vertices, normals and materials), else None."""
    if cfg.backend not in KERNEL_BACKENDS:
        return None
    g = scene.geometry
    return ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj,
                            scene.materials)


def trace_chunks(scene, origins, dirs, cfg, depth, pack=None,
                 gpu_semantics=False, scene_group=None, fixed_depth=False):
    """Trace explicit ray arrays `cfg.ray_chunk` rays at a time: yields
    (first ray, colors of the chunk's rays) chunk by chunk, so a caller can
    run a backward pass per chunk and keep one chunk's graph alive at a
    time. The tail chunk is padded to the chunk size with rays from the
    origin along (1,1,1), as the JAX package pads it (the matmul backend
    recentres on every ray of a chunk); their colors are dropped.
    `fixed_depth`: every chunk runs every bounce step (see `_trace`)."""
    R = origins.shape[0]
    chunk = min(cfg.ray_chunk, R)
    if pack is None:
        pack = _kernel_pack(scene, cfg)
    n_bounces = cfg.max_bounce + 1 if gpu_semantics else depth
    for c0 in range(0, R, chunk):
        o, d = origins[c0:c0 + chunk], dirs[c0:c0 + chunk]
        n = o.shape[0]
        if n < chunk:
            o = torch.cat([o, o.new_zeros((chunk - n, 3))])
            d = torch.cat([d, d.new_ones((chunk - n, 3))])
        colors = _trace(scene, o, d, cfg, pack, n_bounces, gpu_semantics,
                        scene_group, fixed_depth)[:n]
        yield c0, colors
        del colors  # the chunk's graph must not outlive the caller's use of it


def _trace_chunked(scene, origins, dirs, cfg, depth, pack=None,
                   gpu_semantics=False, scene_group=None):
    """(R,3) colors of explicit ray arrays, traced in chunks."""
    return torch.cat([c for _, c in trace_chunks(scene, origins, dirs, cfg, depth,
                                                 pack, gpu_semantics, scene_group)])


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


def _trace_image(frame: FrameLayout, cfg, depth, pack=None, fixed_depth=False,
                 basis=camera_ops.camera_basis):
    """Colors of a frame's rays, chunk by chunk, generating each chunk's
    rays from their ids and tracing them through the CPU pipeline's
    recursion (`depth` levels) or the GPU pipeline's bounce loop. The tail
    chunk's ids are clamped to the last ray (its duplicates are sliced
    away). With `frame.fold4` each chunk's 2x2 subsamples are folded into
    pixels: (n_rays/4, 3). `fixed_depth` runs every bounce step (see
    `_trace`); `basis(camera)` gives the camera's (u, v, C)."""
    scene, n_rays, chunk = frame.scene, frame.n_rays, frame.chunk
    dev = scene.device
    if pack is None:
        pack = _kernel_pack(scene, cfg)
    u, v, C = basis(scene.camera)
    pos = scene.camera.position
    out = []
    for c0 in range(0, n_rays, chunk):
        r = torch.clamp(torch.arange(c0, c0 + chunk, device=dev), max=n_rays - 1)
        origins, dirs = camera_ops.make_rays(u, v, C, pos, frame.coords(r))
        if frame.gpu_semantics:
            colors = trace_rays_gpu(scene, origins, dirs, cfg, pack,
                                    fixed_depth=fixed_depth)
        else:
            colors = trace_rays(scene, origins, dirs, cfg, depth, pack,
                                fixed_depth=fixed_depth)
        out.append(_fold_subsamples(colors, cfg) if frame.fold4 else colors)
    return torch.cat(out)[:frame.n_out]


def cpu_frame(scene: Scene, cfg: RenderConfig) -> FrameLayout:
    """The CPU-reference pipeline's frame: (pixel, 2x2 subsample) rays,
    block-swizzled on the kernel backends when a pixel block divides the
    image, folded into pixels per chunk when the chunk size allows."""
    width, height = scene.camera.width, scene.camera.height
    n_rays = width * height * 4
    chunk = min(cfg.ray_chunk, n_rays)
    fold4 = chunk % 4 == 0
    blk = _pick_block(width, height) if fold4 else None
    swiz = (blk is not None and cfg.backend in KERNEL_BACKENDS
            and cfg.block_rays in ("on", "auto"))
    ray_id_map = None
    if swiz:
        bx, by = blk
        ray_id_map = functools.partial(_swiz_ray_ids, width=width, bx=bx, by=by)
    coord_fn = functools.partial(camera_ops.cpu_subpixel_coords_traced,
                                 width, height)

    def finish(colors):
        if not fold4:
            return assemble_cpu_image(colors, cfg, width, height)
        out = ColorOps(cfg.quantize).finalize(colors)
        if swiz:
            return (out.reshape(height // by, width // bx, by, bx, 3)
                    .permute(0, 2, 1, 3, 4).reshape(height, width, 3))
        return out.reshape(height, width, 3)

    return FrameLayout(scene, n_rays, chunk, coord_fn, ray_id_map, False, fold4,
                       finish)


def gpu_frame(scene: Scene, cfg: RenderConfig) -> FrameLayout:
    """The GPU-reference pipeline's frame: one ray per pixel of the hi-res
    image in row-major order, unswizzled and unfolded, as in the JAX
    package, then the box downscale."""
    scene_hi = hi_res_scene(scene, cfg)
    hw, hh = scene_hi.camera.width, scene_hi.camera.height
    coord_fn = functools.partial(camera_ops.gpu_pixel_coords_traced, hw, hh)
    finish = functools.partial(assemble_gpu_image, cfg=cfg,
                               width=scene.camera.width,
                               height=scene.camera.height)
    n_rays = hw * hh
    return FrameLayout(scene_hi, n_rays, min(cfg.ray_chunk, n_rays), coord_fn, None,
                       True, False, finish)


def frame_layout(scene: Scene, cfg: RenderConfig) -> FrameLayout:
    """The frame `cfg.mode` names."""
    return gpu_frame(scene, cfg) if cfg.mode == "gpu" else cpu_frame(scene, cfg)


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


def _render_frame(scene: Scene, cfg: RenderConfig, depth: int | None, pack=None):
    """The frame `cfg.mode` names, eager: (H,W,3) float32 image in [0,255]
    on the scene's device (`depth` is the CPU pipeline's recursion depth;
    GPU mode caps its bounces by `cfg.max_bounce`)."""
    frame = frame_layout(scene, cfg)
    return frame.finish(_trace_image(frame, cfg, depth, pack))


def frame_plan(scene: Scene, cfg: RenderConfig, depth: int | None,
               pack=None, basis=None) -> FramePlan:
    """The frame `cfg.mode` names as a `FramePlan` over `_bounce_step`, on
    the scene's device: captured and assembled into one CUDA graph on the
    card, its program interpreted over the same pieces on the CPU. `basis`:
    the frame camera's (u, v, C) as tensors the caller owns and refreshes
    in place (`frame_program_inputs`); None computes it once, on the host."""
    frame = frame_layout(scene, cfg)
    n_bounces = cfg.max_bounce + 1 if frame.gpu_semantics else depth
    step = functools.partial(_bounce_step, frame.scene, cfg, ColorOps(cfg.quantize),
                             pack, frame.gpu_semantics, None, None)
    if basis is not None:
        basis = (*basis, frame.scene.camera.position)
    return FramePlan(frame, cfg, n_bounces, step,
                     functools.partial(_fold_subsamples, cfg=cfg), basis)


def unrolled_image(scene: Scene, cfg: RenderConfig, depth: int):
    """The frame `cfg.mode` names as `render_image` captures it: every bounce
    step of every chunk (the JAX package's unrolled strategy; a step whose
    rays are all dead adds exact zeros, so the image is `_render_frame`'s),
    and the kernel pack and the camera basis computed on the device, so
    nothing is read back to the host."""
    frame = frame_layout(scene, cfg)
    return frame.finish(_trace_image(frame, cfg, depth, _kernel_pack(scene, cfg),
                                     fixed_depth=True,
                                     basis=camera_ops.camera_basis_on_device))


def frame_program_inputs(scene: Scene, cfg: RenderConfig):
    """(kernel pack or None, (u, v, C)): what a `FramePlan` reads besides
    the scene, computed from the scene's tensors on the device (the basis of
    the frame's camera: GPU mode's is the hi-res one)."""
    camera = frame_layout(scene, cfg).scene.camera
    return _kernel_pack(scene, cfg), camera_ops.camera_basis_on_device(camera)


IMAGE_PROGRAM = ImageProgram(unrolled_image, frame_program_inputs, frame_plan)


class SceneRenderer:
    """Renderer for repeated frames of one scene on one device.

    Moves the scene to `device` and, on the kernel backends, builds the
    kernel pack (clustering, packing, winner table) once. On a CUDA device
    with `cfg.resolve_unroll()` False (the JAX package's compiled while-loop
    strategy: every config but `unroll="static"` and `quantize="smooth"`
    under "auto") it also captures the frame once into one CUDA graph with
    its loops on the device (`self.plan`, a `utils.frame_graph.FramePlan`),
    as the JAX `SceneRenderer` compiles its frame once, and `render()`
    launches it. A capture or assembly that fails raises, naming the step:
    nothing renders eagerly unasked. Elsewhere (`device="cpu"`, the unrolled strategy) `self.plan`
    is None and `render()` traces eagerly through the pipeline `cfg.mode`
    names. `depth` is None in GPU mode, which caps bounces by
    `cfg.max_bounce`. `device="cuda"` raises when CUDA is not available:
    nothing falls back to the CPU unless `device="cpu"` is asked for.

    The frame graph reads `self.scene`'s and `self.pack`'s tensors where they were
    at capture: reassigning them afterwards is not seen (the JAX renderer's
    compiled frame closes over its scene the same way).
    """

    def __init__(self, scene: Scene, cfg: RenderConfig = RenderConfig(),
                 device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.width, self.height = scene.camera.width, scene.camera.height
        self.scene = scene.to(device)
        if cfg.partitioning != "none" and cfg.backend == "torch":
            # the object-level cull; the kernel backends cull tiles instead
            self.scene, _ = with_accel(self.scene, cfg.partitioning)
        self.depth = frame_depth(scene, cfg) if cfg.mode == "cpu" else None
        with torch.no_grad():
            self.pack = _kernel_pack(self.scene, cfg)
        self.plan = (frame_plan(self.scene, cfg, self.depth, self.pack)
                     if uses_frame_graph(cfg, device) else None)

    @torch.no_grad()
    def render_device(self) -> torch.Tensor:
        """One frame, left on the device: (H,W,3) float32 in [0,255]."""
        if self.plan is not None:
            return self.plan.render()
        return _render_frame(self.scene, self.cfg, self.depth, self.pack)

    def render(self) -> np.ndarray:
        """One frame as host numpy (H,W,3) float32 in [0,255]."""
        return self.render_device().cpu().numpy()


def render_scene(scene: Scene, cfg: RenderConfig = RenderConfig(),
                 device="cuda") -> np.ndarray:
    """Render a scene to an (H,W,3) float image in [0,255]; truncate to
    uint8 (or write with utils.image.write_ppm) for the reference's output."""
    return SceneRenderer(scene, cfg, device).render()


def render_image(scene: Scene, cfg: RenderConfig | None = None,
                 depth: int | None = None, device="cuda",
                 plan: bool | None = None) -> torch.Tensor:
    """Differentiable render: scene -> (H,W,3) float32 image in [0,255] on
    `device`, recorded by autograd wherever a scene tensor requires grad.
    The scene is moved to `device` first (`device="cuda"` raises without a
    card; only `device="cpu"` takes the plain path), and the move is itself
    recorded, so gradients reach the caller's tensors wherever they lie.
    With `quantize="smooth"` (the default here)
    `render_image(scene).mean().backward()` leaves gradients on vertices,
    normals, materials, lights and camera. The recursion depth is not
    derived from the materials: it defaults to `cfg.diff_max_depth` (smooth)
    or `cfg.cpu_max_depth` (match). In GPU mode the downscale's uint8
    truncation has a zero derivative, as in the reference.

    On the card the call is compiled once, as the JAX package jits its
    render: an `utils.image_graph.ImagePlan` per configuration, depth,
    scene structure and set of grad-requiring tensors captures CUDA graphs
    on the first call and replays them after (the forward pass one replay,
    its backward pass one more; without grad and with `resolve_unroll()`
    False, the frame program of `SceneRenderer` after a graph that
    recomputes the pack and the camera basis). Gradients through the
    while-loop strategy and backend "torch" with partitioning stay eager
    (`image_graph_blocker` says why). `plan`: None follows
    `uses_image_graph`; True takes the plan on the CPU too, where it runs
    uncaptured (raising `ValueError` where a blocker names a reason); False
    renders eagerly (the counterpart of `jax.disable_jit`). With grad a
    plan keeps one slot (buffers, graphs, memory pool) per outstanding
    image, so several images of one plan are differentiated together or in
    any order, as under `jax.grad`; beyond `image_graph.MAX_SLOTS`
    outstanding images a call renders eagerly (counted in the plan's
    `eager_calls`)."""
    cfg = cfg or RenderConfig(quantize="smooth")
    device = resolve_device(device)
    scene = scene.to(device)
    if depth is None:
        depth = cfg.diff_max_depth if cfg.quantize == "smooth" else cfg.cpu_max_depth
    grad = needs_grad(scene)
    blocker = image_graph_blocker(cfg, grad)
    if plan and blocker:
        raise ValueError(f"plan=True, but this render_image call cannot be "
                         f"captured: {blocker}")
    if uses_image_graph(cfg, device, grad) if plan is None else plan:
        image = image_plan(scene, cfg, depth, grad, IMAGE_PROGRAM).image(scene)
        if image is not None:
            return image
    return _render_frame(scene, cfg, depth)


def render(input_path: str, output_path: str, cfg: RenderConfig = RenderConfig(),
           device="cuda") -> None:
    """Parse, render, write: `rt in.svati out.ppm` (cpu/rt.c:5-10) or
    `rt in.svati out.png` (gpu/rt.cpp:54-97). A `.png` path gets the image
    truncated to uint8 as RGBA PNG; any other path gets ASCII P3."""
    img = render_scene(parse_scene(input_path), cfg, device=device)
    if output_path.endswith(".png"):
        image_io.write_png(output_path, np.trunc(img).astype(np.uint8))
    else:
        image_io.write_ppm(output_path, img)
