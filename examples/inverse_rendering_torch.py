"""Inverse rendering with the PyTorch port: recover perturbed scene
parameters by gradient descent through the differentiable renderer.

  true scene --> predict_pixels at the true parameters --> target pixels
  perturbed scene --> render (smooth mode, kernel backend, octree culling)
  --> MSE --> backward --> Adam --> recovered parameters

The scene is the procedural sphere scene (`make_sphere_scene`) and the
target is the port's own prediction at the true parameters, so the loss's
minimum lies exactly at those parameters (the `RGT_DEMO_TARGET=self` case
of `examples/inverse_rendering.py`; the corpus scenes and the C oracle's
images are not in this repository). The run writes a CSV of the convergence,
before/after/target PPMs and checkpoints under its output directory. An
existing output directory is resumed: the run restores the latest
checkpoint under its `ckpt/` and appends to the CSV, whatever options wrote
it, so give a run with other options a fresh RGT_DEMO_OUT.

Usage (on the GPU; add RGT_DEMO_DEVICE=cpu for the host, ~1 min at the
default size):
    python examples/inverse_rendering_torch.py
Options, by the names of `examples/inverse_rendering.py` where they apply:
RGT_DEMO_RES (default 32), RGT_DEMO_STEPS (80), RGT_DEMO_BACKEND (cuda; on
CPU tensors the kernels' plain versions run), RGT_DEMO_OUT (default
`rgt_inverse_demo_torch` under `tempfile.gettempdir()`, which honours TMPDIR), RGT_DEMO_FREE (comma list of the free
parameter groups among kd, vertices, lights_v, normals; default "kd"),
RGT_DEMO_KDNOISE / RGT_DEMO_VNOISE / RGT_DEMO_LNOISE (perturbation sizes),
RGT_DEMO_CHUNK (rays per chunk, default 4096), RGT_DEMO_LRS (per-group
learning rates, e.g. "vertices=1e-4,lights_v=1e-3"), RGT_DEMO_BLUR (sigma of
the loss's residual blur, default 0), RGT_DEMO_DEVICE (cuda), RGT_DEMO_SEED.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.parallel import (
    extract_params,
    insert_params,
    make_train_step,
    predict_pixels,
)
from raytracing_gpu_tpu_torch.parallel.checkpoint import (
    resume_or_init,
    save_train_state,
)
from raytracing_gpu_tpu_torch.render import required_depth
from raytracing_gpu_tpu_torch.utils.image import write_ppm

LEARNING_RATES = {"kd": 1e-2, "vertices": 1e-3, "lights_v": 3e-3, "normals": 3e-3}


def perturb(scene, free, rng, kd_noise, v_noise, l_noise):
    """The scene's parameters with every free group moved off its true
    value (padding rows and invalid triangles stay: they get no gradient)."""
    params = {k: v.clone() for k, v in extract_params(scene).items()}
    valid = scene.geometry.valid.numpy()
    if "kd" in free:
        kd = params["kd"].numpy()
        noise = rng.uniform(-kd_noise, kd_noise, kd.shape).astype(np.float32)
        noise[scene.n_objects:] = 0.0
        params["kd"] = torch.from_numpy(np.clip(kd + noise, 0.05, 1.0))
    if "vertices" in free:
        v = params["vertices"].numpy()
        ext = float(v[valid].max() - v[valid].min())
        noise = rng.normal(0.0, v_noise * ext, v.shape).astype(np.float32)
        noise[~valid] = 0.0
        params["vertices"] = torch.from_numpy(v + noise)
    if "lights_v" in free:
        lv = params["lights_v"].numpy()
        params["lights_v"] = torch.from_numpy(
            lv + rng.uniform(-l_noise, l_noise, lv.shape).astype(np.float32)
            * np.maximum(np.abs(lv), 1.0))
    if "normals" in free:
        n = params["normals"].numpy()
        noise = rng.normal(0.0, 0.15 * float(np.abs(n[valid]).mean()),
                           n.shape).astype(np.float32)
        noise[~valid] = 0.0
        params["normals"] = torch.from_numpy(n + noise)
    return params


def main() -> None:
    env = os.environ.get
    res = int(env("RGT_DEMO_RES", "32"))
    steps = int(env("RGT_DEMO_STEPS", "80"))
    backend = env("RGT_DEMO_BACKEND", "cuda")
    out_dir = env("RGT_DEMO_OUT") or os.path.join(tempfile.gettempdir(),
                                                   "rgt_inverse_demo_torch")
    free = tuple(env("RGT_DEMO_FREE", "kd").split(","))
    device = env("RGT_DEMO_DEVICE", "cuda")
    loss_blur = float(env("RGT_DEMO_BLUR", "0"))
    lr = dict(LEARNING_RATES)
    for kv in filter(None, env("RGT_DEMO_LRS", "").split(",")):
        k, _, v = kv.partition("=")
        lr[k.strip()] = float(v)
    unknown = [k for k in free if k not in lr]
    if unknown:
        raise SystemExit(f"RGT_DEMO_FREE: unknown groups {unknown}; "
                         f"choose among {sorted(lr)}")
    os.makedirs(out_dir, exist_ok=True)

    scene = make_sphere_scene(res, res, n_lat=16, n_lon=20)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend=backend,
                       partitioning="octree",
                       ray_chunk=int(env("RGT_DEMO_CHUNK", "4096")),
                       diff_max_depth=2)
    depth = required_depth(float(scene.materials.nr.max()), cfg.reflect_cutoff,
                           cfg.diff_max_depth)
    true_params = extract_params(scene)
    params = perturb(scene, free, np.random.RandomState(int(env("RGT_DEMO_SEED", "0"))),
                     float(env("RGT_DEMO_KDNOISE", "0.3")),
                     float(env("RGT_DEMO_VNOISE", "0.004")),
                     float(env("RGT_DEMO_LNOISE", "0.15")))

    # one Adam group per free parameter group, each at its own rate; every
    # other group is known exactly and stays frozen. On the card the step is
    # a captured CUDA graph, which needs Adam's step count on the device.
    def optimizer(p):
        return torch.optim.Adam([{"params": [p[k]], "lr": lr[k]} for k in free],
                                capturable=torch.device(device).type == "cuda")

    init_state, step_fn = make_train_step(None, cfg, scene, optimizer=optimizer,
                                          loss_blur=loss_blur, device=device)
    state = init_state(params)
    dev = state.params["kd"].device
    scene_d = scene.to(dev)
    coords = camera_ops.cpu_subpixel_coords_traced(
        res, res, torch.arange(res * res * 4, device=dev))
    with torch.no_grad():
        target = predict_pixels(scene_d, cfg, depth, coords, device=dev)

    match_cfg = dataclasses.replace(cfg, quantize="match")
    write_ppm(os.path.join(out_dir, "before.ppm"),
              render_scene(insert_params(scene, params), match_cfg, device=device))
    write_ppm(os.path.join(out_dir, "target.ppm"),
              (target.clamp(0.0, 1.0) * 255.0).reshape(res, res, 3).cpu().numpy())

    ckpt_dir = os.path.join(out_dir, "ckpt")
    state, resumed = resume_or_init(ckpt_dir, state)
    if resumed:
        print(f"resumed from checkpoint at step {state.step}")

    def errs(p):
        out = []
        for k in free:
            d = (p[k].detach().cpu() - true_params[k]).abs()
            if k in ("vertices", "normals"):
                d = d[scene.geometry.valid]
            elif k == "kd":
                d = d[:scene.n_objects]
            out.append(float(d.mean()))
        return out

    curve = []
    t0 = time.perf_counter()
    while state.step < steps:
        state, loss = step_fn(state, scene_d, coords, target)
        e = errs(state.params)
        curve.append((state.step, float(loss), *e))
        if state.step % 10 == 0 or state.step == steps:
            print(f"step {state.step:4d}  loss {float(loss):.3e}  "
                  + "  ".join(f"{k} err {v:.5f}" for k, v in zip(free, e)), flush=True)
        if state.step % 25 == 0:
            save_train_state(ckpt_dir, state)
    save_train_state(ckpt_dir, state)
    dt = time.perf_counter() - t0
    if not curve:
        print(f"nothing to do: the checkpoint is at step {state.step} of {steps}")
        return
    print(f"{len(curve)} steps in {dt:.1f}s ({dt / len(curve) * 1e3:.0f} ms/step, "
          f"{res}x{res}, backend={backend}, device={dev})")

    with open(os.path.join(out_dir, "convergence.csv"), "a" if resumed else "w") as f:
        if not resumed:
            f.write("step,loss," + ",".join(f"{k}_mean_abs_err" for k in free) + "\n")
        for row in curve:
            f.write(",".join(str(x) for x in row) + "\n")
    after = {k: v.detach().cpu() for k, v in state.params.items()}
    write_ppm(os.path.join(out_dir, "after.ppm"),
              render_scene(insert_params(scene, after), match_cfg, device=device))

    first, last = curve[0], curve[-1]
    print(f"\nloss {first[1]:.3e} -> {last[1]:.3e}")
    for ix, k in enumerate(free):
        print(f"  {k} err {first[2 + ix]:.5f} -> {last[2 + ix]:.5f}")
    print(f"artifacts in {out_dir}: before/after/target.ppm, convergence.csv, ckpt/")
    if not resumed and last[1] >= first[1] * 0.2:
        raise SystemExit("demo did not converge")


if __name__ == "__main__":
    main()
