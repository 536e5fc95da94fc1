"""Differentiable inverse rendering on one device: the training step.

The JAX package's `parallel/train.py` without its mesh (the sharded form
waits for the port of `parallel/render.py` and `mesh.py`):

- `extract_params` / `insert_params`: the 13 differentiable leaf groups of a
  scene as a flat dict, by the same names;
- `predict_pixels`: the exact prediction the loss compares with its target;
- `make_train_step(cfg, scene, ...)` -> `(init_state, step_fn)`:
  `step_fn(state, scene_fixed, coords, target) -> (state, loss)` renders
  the current parameters in the smooth domain, takes
  `sum(err^2) / (3 n_pixels)`, differentiates it and lets the optimizer
  step.

`torch.optim.Adam` stands for `optax.adam`: the same update with the same
betas, epsilon outside the square root and bias correction. An optimizer
here is a factory `params dict -> torch.optim.Optimizer`; the groups it is
handed are the free ones (only they are recorded by autograd), every other
group stays frozen, which is what the JAX package does with `optax.masked`.
A step updates the state's tensors in place, as torch optimizers do, and
returns the same state object.

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
from raytracing_gpu_tpu_torch.partition.apply import with_accel
from raytracing_gpu_tpu_torch.render import (
    _trace_chunked,
    required_depth,
    resolve_device,
    trace_chunks,
)

PARAM_KEYS = ("vertices", "normals", "lights_rgb", "lights_v", "ka", "kd", "ks",
              "ns", "nr", "cam_position", "cam_u", "cam_v", "cam_fov")


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


def params_from_numpy(arrays: dict, device="cpu") -> dict:
    """The port's params from a dict of arrays under the same 13 names (the
    JAX package's `extract_params` through `np.asarray`), as float32."""
    return {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
            for k in PARAM_KEYS}


def params_to_numpy(params: dict) -> dict:
    """The way back: host float32 arrays under the same names (copies: a
    later step does not change them)."""
    return {k: params[k].detach().cpu().numpy().copy() for k in PARAM_KEYS}


@dataclasses.dataclass
class TrainState:
    params: dict   # name -> tensor; the free groups require grad
    opt_state: Any  # the torch.optim.Optimizer over the free groups
    step: int


def predict_pixels(scene: Scene, cfg: RenderConfig, depth: int, coords,
                   device="cuda"):
    """(R/4, 3) pixel colors in [0,1] on `device` (the scene and `coords`
    are moved there; `device="cuda"` raises without a card, only
    `device="cpu"` takes the plain path): the exact prediction the training
    loss compares with its target (camera rays -> smooth trace -> mean of
    the 2x2 subsamples, no final clamp). A target made here at the true
    parameters puts the loss's minimum exactly at those parameters, which a
    clamped render does not (a saturated pixel clamps in the image but not
    in this prediction)."""
    device = resolve_device(device)
    scene, coords = scene.to(device), coords.to(device)
    u, v, C = camera_ops.camera_basis(scene.camera)
    origins, dirs = camera_ops.make_rays(u, v, C, scene.camera.position, coords)
    colors = _trace_chunked(scene, origins, dirs, cfg, depth)
    return colors.reshape(-1, 4, 3).mean(1)


def _blur_residual(err, n_pixels: int, sigma: float):
    """Separable gaussian blur (edge-replicated, radius 3 sigma) of a
    per-pixel residual (n_pixels, 3) laid out as a row-major square image:
    an optional low-pass weighting of the image loss. Blur is linear, so the
    minimum stays at residual 0. It does not create gradients across hard
    visibility boundaries."""
    H = W = int(round(n_pixels ** 0.5))
    if H * W != n_pixels:
        raise ValueError(f"loss_blur needs a square image (n_pixels={n_pixels})")
    r = max(1, int(round(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = torch.from_numpy(k / k.sum()).to(err.device)

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


def _default_optimizer(learning_rate: float) -> Callable:
    return lambda params: torch.optim.Adam(list(params.values()), lr=learning_rate)


def _new_state(params: dict, optimizer: Callable, device) -> TrainState:
    """Own copies of `params` on `device`, the optimizer over them, and
    autograd recording exactly the groups the optimizer holds."""
    params = {k: params[k].detach().to(device, copy=True) for k in PARAM_KEYS}
    opt = optimizer(params)
    free = {id(p) for group in opt.param_groups for p in group["params"]}
    for p in params.values():
        p.requires_grad_(id(p) in free)
    return TrainState(params=params, opt_state=opt, step=0)


def make_train_step(cfg: RenderConfig, scene: Scene, optimizer=None,
                    learning_rate: float = 1e-2, loss_blur: float = 0.0,
                    device="cuda"):
    """Build (init_state, step_fn) for inverse rendering on `scene`'s
    structure, on one device (`device="cuda"` raises without a card).

    init_state(params) -> TrainState: copies of the 13 groups on the device.
    `optimizer` maps that params dict to a `torch.optim.Optimizer` over the
    groups to train (default: Adam at `learning_rate` over all of them).

    step_fn(state, scene_fixed, coords, target) -> (state, loss)
      scene_fixed: the scene whose non-parameter leaves (tri_obj, valid,
        light kinds, sizes) the step uses; coords (R,2) subpixel plane
        coordinates, R divisible by 4; target (R/4,3) pixel colors in [0,1].
      Updates `state` in place and returns it with the loss (a 0-d tensor
      on the device) of the parameters before the update.

    The pack of the kernel backends is rebuilt from the current vertices in
    every step (its table carries the gradient); backend "torch" with
    partitioning rebuilds its object-level boxes instead, without gradient.
    With `loss_blur == 0` the backward pass runs chunk by chunk
    (`cfg.ray_chunk` rays), so one chunk's graph is alive at a time; the
    gradient is the whole image's up to the order of the sums.
    """
    if cfg.quantize != "smooth":
        raise ValueError("training requires quantize='smooth' (match mode "
                         "clamps at every op and kills gradients)")
    device = resolve_device(device)
    optimizer = optimizer or _default_optimizer(learning_rate)
    max_nr = float(scene.materials.nr.max())
    depth = required_depth(max_nr, cfg.reflect_cutoff, cfg.diff_max_depth)

    def init_state(params: dict) -> TrainState:
        return _new_state(params, optimizer, device)

    def loss_and_grads(params, scene_fixed, coords, target):
        """The loss; the free groups' gradients are left in their `.grad`."""
        n_pixels = target.shape[0]
        scene_now = insert_params(scene_fixed, params)
        if cfg.partitioning != "none" and cfg.backend == "torch":
            scene_now, _ = with_accel(scene_now, cfg.partitioning)
        u, v, C = camera_ops.camera_basis(scene_now.camera)
        origins, dirs = camera_ops.make_rays(u, v, C, params["cam_position"],
                                             coords)
        scale = 1.0 / (3.0 * n_pixels)
        chunkwise = loss_blur <= 0.0 and min(cfg.ray_chunk, coords.shape[0]) % 4 == 0
        total, kept = 0.0, []
        for c0, colors in trace_chunks(scene_now, origins, dirs, cfg, depth):
            if not chunkwise:
                kept.append(colors)
                continue
            pred = colors.reshape(-1, 4, 3).mean(1)
            err = pred - target[c0 // 4:c0 // 4 + pred.shape[0]]
            part = (err * err).sum() * scale
            # the camera's and the pack's small graphs are shared by every chunk
            part.backward(retain_graph=True)
            total = total + part.detach()
            del colors, pred, err, part  # frees this chunk's graph
        if chunkwise:
            return total
        err = torch.cat(kept).reshape(-1, 4, 3).mean(1) - target
        if loss_blur > 0.0:
            err = _blur_residual(err, n_pixels, loss_blur)
        loss = (err * err).sum() * scale
        loss.backward()
        return loss.detach()

    def step_fn(state: TrainState, scene_fixed: Scene, coords, target):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_and_grads(state.params, scene_fixed.to(device),
                              coords.to(device), target.to(device))
        opt.step()
        state.step += 1
        return state, loss

    return init_state, step_fn


def init_train_state(scene: Scene, optimizer=None, learning_rate: float = 1e-2,
                     device="cuda") -> TrainState:
    """A fresh TrainState at the scene's own parameters."""
    return _new_state(extract_params(scene),
                      optimizer or _default_optimizer(learning_rate),
                      resolve_device(device))
