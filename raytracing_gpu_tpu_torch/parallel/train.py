"""Differentiable inverse rendering: the training step, on one device or
sharded over a `parallel.mesh.Mesh`.

The JAX package's `parallel/train.py`:

- `extract_params` / `insert_params`: the 13 differentiable leaf groups of a
  scene as a flat dict, by the same names; `PARAM_SPECS` names the mesh
  axis each group is split over (`vertices` and `normals` over the scene
  axis, the rest replicated) and `shard_params` gives a rank its slices;
- `predict_pixels`: the exact prediction the loss compares with its target;
- `make_train_step(mesh, cfg, scene, ...)` -> `(init_state, step_fn)`:
  `step_fn(state, fixed_geo, fixed_rest, coords, target) -> (state, loss)`
  renders the current parameters in the smooth domain, takes
  `sum(err^2) / (3 n_pixels)`, differentiates it and lets the optimizer
  step. `mesh=None` is one device.

Sharded: each rank traces its tile's block of the rays against its shard's
triangles (combined over the scene group in every bounce), runs the
backward pass, and one `all_reduce(SUM)` over the tiles group per step adds
the tiles' losses and the free groups' gradients. Nothing is summed over the
scene group: after the combine every shard computes the same thing, its
replicated groups get the whole gradient, and its own triangles get theirs
through the combine's gather (`parallel.collectives.all_gather`). The JAX
package's gather transposes to a sum over the shards instead, which scales
its `vertices` and `normals` gradients by the number of shards.

`torch.optim.Adam` stands for `optax.adam`: the same update with the same
betas, epsilon outside the square root and bias correction. An optimizer
here is a factory `params dict -> torch.optim.Optimizer`; the groups it is
handed are the free ones (only they are recorded by autograd), every other
group stays frozen, which is what the JAX package does with `optax.masked`.
A step updates the state's tensors in place, as torch optimizers do, and
returns the same state object.

On the card a one-device step is captured into a CUDA graph and replayed
(`utils.step_graph.StepPlan`), as the JAX package jits its step; it then
traces every bounce step of every chunk (no early exit: dead steps add
exact zeros). A mesh and backend "torch" with partitioning stay eager
(`utils.step_graph.step_graph_blocker` says why).

quantize="smooth" is required: "match" clamps at every color operation and
zeroes the gradient wherever an intermediate saturates. Hard shadows and
winner selection stay piecewise constant: no gradient crosses a silhouette
or a shadow edge.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.parallel import collectives
from raytracing_gpu_tpu_torch.parallel.mesh import SCENE, TILES
from raytracing_gpu_tpu_torch.parallel.render import (
    check_shardable,
    shard_geometry,
    shard_rows,
)
from raytracing_gpu_tpu_torch.partition.apply import with_accel
from raytracing_gpu_tpu_torch.render import (
    _trace_chunked,
    required_depth,
    resolve_device,
    trace_chunks,
)
from raytracing_gpu_tpu_torch.utils.profiling import annotate
from raytracing_gpu_tpu_torch.utils.step_graph import (
    StepPlan,
    require_capturable,
    step_graph_blocker,
    uses_step_graph,
)

PARAM_KEYS = ("vertices", "normals", "lights_rgb", "lights_v", "ka", "kd", "ks",
              "ns", "nr", "cam_position", "cam_u", "cam_v", "cam_fov")

# the mesh axis each group's rows are split over; None: replicated
PARAM_SPECS = {k: SCENE if k in ("vertices", "normals") else None
               for k in PARAM_KEYS}


def extract_params(scene: Scene) -> dict:
    return {
        "vertices": scene.geometry.vertices,
        "normals": scene.geometry.normals,
        "lights_rgb": scene.lights.rgb,
        "lights_v": scene.lights.v,
        "ka": scene.materials.ka,
        "kd": scene.materials.kd,
        "ks": scene.materials.ks,
        "ns": scene.materials.ns,
        "nr": scene.materials.nr,
        "cam_position": scene.camera.position,
        "cam_u": scene.camera.u,
        "cam_v": scene.camera.v,
        "cam_fov": scene.camera.fov,
    }


def insert_params(scene: Scene, p: dict) -> Scene:
    return dataclasses.replace(
        scene,
        camera=dataclasses.replace(
            scene.camera, position=p["cam_position"], u=p["cam_u"],
            v=p["cam_v"], fov=p["cam_fov"]),
        lights=dataclasses.replace(scene.lights, rgb=p["lights_rgb"],
                                   v=p["lights_v"]),
        geometry=dataclasses.replace(scene.geometry, vertices=p["vertices"],
                                     normals=p["normals"]),
        materials=dataclasses.replace(
            scene.materials, ka=p["ka"], kd=p["kd"], ks=p["ks"], ns=p["ns"],
            nr=p["nr"]),
    )


def params_from_numpy(arrays: dict, device="cuda") -> dict:
    """The port's params from a dict of arrays under the same 13 names (the
    JAX package's `extract_params` through `np.asarray`), as float32 on
    `device` (`"cuda"` raises without a card; pass `device="cpu"` for the
    host)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
            for k in PARAM_KEYS}


def shard_params(params: dict, mesh) -> dict:
    """This rank's parameters: its contiguous slice of the groups
    `PARAM_SPECS` splits over the scene axis, the rest as they are (no
    copies). `mesh=None` is one device."""
    if mesh is None:
        return dict(params)
    return {k: shard_rows(v, mesh) if PARAM_SPECS[k] == SCENE else v
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """The way back: host float32 arrays under the same names (copies: a
    later step does not change them)."""
    return {k: params[k].detach().cpu().numpy().copy() for k in PARAM_KEYS}


@dataclasses.dataclass
class TrainState:
    params: dict   # name -> tensor (this rank's slice); the free groups require grad
    opt_state: Any  # the torch.optim.Optimizer over the free groups
    step: int
    mesh: Any = None  # the mesh the params are sharded over; None: one device


def predict_pixels(scene: Scene, cfg: RenderConfig, depth: int, coords,
                   device="cuda", scene_group=None):
    """(R/4, 3) pixel colors in [0,1] on `device` (the scene and `coords`
    are moved there; `device="cuda"` raises without a card, only
    `device="cpu"` takes the plain path): the exact prediction the training
    loss compares with its target (camera rays -> smooth trace -> mean of
    the 2x2 subsamples, no final clamp). A target made here at the true
    parameters puts the loss's minimum exactly at those parameters, which a
    clamped render does not (a saturated pixel clamps in the image but not
    in this prediction). With a `scene_group` the scene holds this rank's
    shard of the triangles."""
    device = resolve_device(device)
    scene, coords = scene.to(device), coords.to(device)
    u, v, C = camera_ops.camera_basis(scene.camera)
    origins, dirs = camera_ops.make_rays(u, v, C, scene.camera.position, coords)
    colors = _trace_chunked(scene, origins, dirs, cfg, depth,
                            scene_group=scene_group)
    return colors.reshape(-1, 4, 3).mean(1)


def _blur_taps(sigma: float, device):
    """The (2r+1,) normalised gaussian of `_blur_residual`, r = 3 sigma."""
    r = max(1, int(round(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.from_numpy(k / k.sum()).to(device)


def _blur_residual(err, n_pixels: int, sigma: float, taps=None):
    """Separable gaussian blur (edge-replicated, radius 3 sigma) of a
    per-pixel residual (n_pixels, 3) laid out as a row-major square image:
    an optional low-pass weighting of the image loss. Blur is linear, so the
    minimum stays at residual 0. It does not create gradients across hard
    visibility boundaries. `taps`: `_blur_taps(sigma, err.device)`, made
    once (made here, it is a copy from the host in every call)."""
    H = W = int(round(n_pixels ** 0.5))
    if H * W != n_pixels:
        raise ValueError(f"loss_blur needs a square image (n_pixels={n_pixels})")
    k = _blur_taps(sigma, err.device) if taps is None else taps
    r = k.shape[0] // 2

    def conv(a, axis):
        n = a.shape[axis]
        first, last = a.narrow(axis, 0, 1), a.narrow(axis, n - 1, 1)
        shape = [-1, -1, -1]
        shape[axis] = r
        ap = torch.cat([first.expand(shape), a, last.expand(shape)], axis)
        out = torch.zeros_like(a)
        for i in range(2 * r + 1):
            out = out + k[i] * ap.narrow(axis, i, n)
        return out

    return conv(conv(err.reshape(H, W, 3), 0), 1).reshape(-1, 3)


def _default_optimizer(learning_rate: float, capturable: bool = False) -> Callable:
    """Adam over every group; `capturable` (a captured step on the card)
    keeps its step count on the device."""
    return lambda params: torch.optim.Adam(list(params.values()), lr=learning_rate,
                                           capturable=capturable)


def _new_state(params: dict, optimizer: Callable, device, mesh=None) -> TrainState:
    """Own copies of this rank's slices of `params` on `device`, the
    optimizer over them, and autograd recording exactly the groups the
    optimizer holds."""
    params = shard_params(params, mesh)
    params = {k: params[k].detach().to(device, copy=True) for k in PARAM_KEYS}
    opt = optimizer(params)
    free = {id(p) for group in opt.param_groups for p in group["params"]}
    for p in params.values():
        p.requires_grad_(id(p) in free)
    return TrainState(params=params, opt_state=opt, step=0, mesh=mesh)


def make_train_step(mesh, cfg: RenderConfig, scene: Scene, optimizer=None,
                    learning_rate: float = 1e-2, loss_blur: float = 0.0,
                    device="cuda", plan: bool | None = None):
    """Build (init_state, step_fn) for inverse rendering on `scene`'s
    structure, on `device` (`"cuda"` raises without a card), sharded over
    `mesh` (a `parallel.mesh.Mesh`; None is one device).

    init_state(params) -> TrainState: copies of this rank's slices of the
    13 groups (`shard_params`) on the device. `optimizer` maps that params
    dict to a `torch.optim.Optimizer` over the groups to train (default:
    Adam at `learning_rate` over all of them, `capturable=True` where the
    step is captured).

    plan: None (the default) steps through a `utils.step_graph.StepPlan`
    wherever `uses_step_graph(cfg, device, mesh)` says: on a card, one
    device, and not backend "torch" with partitioning. There the step is
    captured into a CUDA graph on the first
    call with a state (that call is a real step, run eagerly) and replayed
    after; it traces every bounce step (no early exit). True takes the plan
    on the CPU too, where it runs uncaptured (raising where
    `step_graph_blocker` names a reason); False steps eagerly. A captured
    step needs an optimizer that reads nothing back to the host: one with
    a `capturable` option (Adam) must be built with `capturable=True`, or
    `init_state` and `step_fn` raise ValueError; SGD needs nothing.

    step_fn(state, fixed_geo, fixed_rest, coords, target) -> (state, loss)
      fixed_geo, fixed_rest: the whole scene's geometry and the rest of it
        (`parallel.render.split_scene`), whose non-parameter leaves
        (tri_obj, valid, light kinds, sizes) the step uses; any
        acceleration data attached to the geometry is dropped. With
        `mesh=None`, step_fn(state, scene_fixed, coords, target) works too.
      coords: (R,2) subpixel plane coordinates of every ray, R divisible by
        4 * n_tiles; target: (R/4,3) pixel colors in [0,1]. Each rank takes
        its tile's block of both.
      Updates `state` in place and returns it with the loss (a 0-d tensor
      on the device, the same on every rank) of the parameters before the
      update.

    The pack of the kernel backends is rebuilt from this rank's current
    vertices in every step (its table carries the gradient); backend
    "torch" with partitioning rebuilds its object-level boxes from them
    instead, without gradient. With `loss_blur == 0` the backward pass runs
    chunk by chunk (`cfg.ray_chunk` rays), so one chunk's graph is alive at
    a time; the gradient is the whole image's up to the order of the sums.
    `loss_blur > 0` needs one tile: the blur window would straddle tiles.
    `step_fn.plan` is the `StepPlan`, or None for an eager step.
    """
    if cfg.quantize != "smooth":
        raise ValueError("training requires quantize='smooth' (match mode "
                         "clamps at every op and kills gradients)")
    n_tiles = 1 if mesh is None else mesh.shape[TILES]
    if loss_blur > 0.0 and n_tiles > 1:
        raise ValueError("loss_blur requires tiles=1 (the blur window "
                         "would straddle tile-shard boundaries)")
    if mesh is not None:
        mesh.require_member()
        check_shardable(scene, mesh)
    scene_group = None if mesh is None else mesh.scene_group
    tiles_group = None if mesh is None else mesh.tiles_group
    device = resolve_device(device)
    blocker = step_graph_blocker(cfg, mesh)
    if plan and blocker:
        raise ValueError(f"plan=True, but this step cannot be captured: {blocker}")
    use_plan = uses_step_graph(cfg, device, mesh) if plan is None else plan
    captured = use_plan and device.type == "cuda"
    optimizer = optimizer or _default_optimizer(learning_rate, captured)
    max_nr = float(scene.materials.nr.max())
    depth = required_depth(max_nr, cfg.reflect_cutoff, cfg.diff_max_depth)
    blur_taps = _blur_taps(loss_blur, device) if loss_blur > 0.0 else None

    def init_state(params: dict) -> TrainState:
        state = _new_state(params, optimizer, device, mesh)
        if captured:
            require_capturable(state.opt_state)
        return state

    def loss_and_grads(params, scene_fixed, coords, target, n_pixels,
                       in_plan=False):
        """This tile's loss; the free groups' gradients from its rays are
        left in their `.grad`. `in_plan`: the step of a `StepPlan`, which
        reads nothing back to the host (the camera basis on the device,
        every bounce step traced). Spans "forward" (each chunk's trace and
        loss) and "backward" (each backward pass)."""
        with annotate("forward"):
            scene_now = insert_params(scene_fixed, params)
            if cfg.partitioning != "none" and cfg.backend == "torch":
                scene_now, _ = with_accel(scene_now, cfg.partitioning)
            basis = (camera_ops.camera_basis_on_device if in_plan
                     else camera_ops.camera_basis)
            u, v, C = basis(scene_now.camera)
            origins, dirs = camera_ops.make_rays(u, v, C, params["cam_position"],
                                                 coords)
            chunks = trace_chunks(scene_now, origins, dirs, cfg, depth,
                                  scene_group=scene_group, fixed_depth=in_plan)
        scale = 1.0 / (3.0 * n_pixels)
        R = coords.shape[0]
        chunkwise = loss_blur <= 0.0 and min(cfg.ray_chunk, R) % 4 == 0
        total, kept = 0.0, []
        # one chunk of `trace_chunks` per pass, so that its trace falls in a span
        for _ in range(0, R, min(cfg.ray_chunk, R)):
            with annotate("forward"):
                c0, colors = next(chunks)
                if not chunkwise:
                    kept.append(colors)
                    continue
                pred = colors.reshape(-1, 4, 3).mean(1)
                err = pred - target[c0 // 4:c0 // 4 + pred.shape[0]]
                part = (err * err).sum() * scale
            with annotate("backward"):
                # the camera's and the pack's small graphs are shared by every chunk
                part.backward(retain_graph=True)
            total = total + part.detach()
            del colors, pred, err, part  # frees this chunk's graph
        chunks.close()
        if chunkwise:
            return total
        with annotate("forward"):
            err = torch.cat(kept).reshape(-1, 4, 3).mean(1) - target
            if loss_blur > 0.0:
                err = _blur_residual(err, n_pixels, loss_blur, blur_taps)
            loss = (err * err).sum() * scale
        with annotate("backward"):
            loss.backward()
        return loss.detach()

    def sum_over_tiles(params, loss):
        """The whole image's loss and gradients: one all_reduce(SUM) over
        the tiles group of the loss and every free group's gradient."""
        free = [p for p in params.values() if p.requires_grad]
        for p in free:
            if p.grad is None:  # no ray of this tile reached it
                p.grad = torch.zeros_like(p)
        flat = collectives.all_reduce(
            torch.cat([loss.reshape(1)] + [p.grad.reshape(-1) for p in free]),
            group=tiles_group)
        at = 1
        for p in free:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        return flat[0]

    step_plan = StepPlan(
        lambda params, scene_fixed, coords, target: loss_and_grads(
            params, scene_fixed, coords, target, target.shape[0], in_plan=True),
        device) if use_plan else None

    def step_fn(state: TrainState, *args):
        if len(args) == 4:
            fixed_geo, fixed_rest, coords, target = args
        elif len(args) == 3 and mesh is None:
            scene_fixed, coords, target = args
            fixed_geo, fixed_rest = scene_fixed.geometry, scene_fixed
        else:
            raise TypeError("step_fn(state, fixed_geo, fixed_rest, coords, target)"
                            + (" or step_fn(state, scene_fixed, coords, target)"
                               if mesh is None else ""))
        n_pixels = target.shape[0]
        if coords.shape[0] != 4 * n_pixels or n_pixels % n_tiles:
            raise ValueError(f"{coords.shape[0]} rays and {n_pixels} target pixels: "
                             f"need 4 rays a pixel and pixels divisible by {n_tiles} tiles")
        geo = dataclasses.replace(fixed_geo, obj_aabb=None, octree=None)
        if mesh is not None:
            geo = shard_geometry(geo, mesh)
            coords, target = shard_rows(coords, mesh, TILES), shard_rows(target, mesh, TILES)
        scene_fixed = dataclasses.replace(fixed_rest, geometry=geo).to(device)
        coords, target = coords.to(device), target.to(device)
        if step_plan is not None:
            loss = step_plan.step(state, scene_fixed, coords, target)
        else:
            opt = state.opt_state
            opt.zero_grad(set_to_none=True)
            loss = loss_and_grads(state.params, scene_fixed, coords, target, n_pixels)
            if tiles_group is not None:
                loss = sum_over_tiles(state.params, loss)
            opt.step()
        state.step += 1
        return state, loss

    step_fn.plan = step_plan
    return init_state, step_fn


def init_train_state(scene: Scene, optimizer=None, learning_rate: float = 1e-2,
                     device="cuda") -> TrainState:
    """A fresh TrainState at the scene's own parameters (the default Adam
    is capturable on a card, as a captured step needs)."""
    device = resolve_device(device)
    return _new_state(extract_params(scene),
                      optimizer or _default_optimizer(learning_rate,
                                                      device.type == "cuda"),
                      device)
