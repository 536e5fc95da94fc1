"""The "frames" traffic kind: a closed loop of frames, one at a time, each
`SceneRenderer.render_device()` until the image is on the host as uint8
(`np.trunc`, what `rt` writes). A mix of this kind (`traffic/<mix>.json`)
gives the image size and `render`, the `RenderConfig` fields.

Set-up builds the renderer (its frame graph captured on a card) and renders
WARMUP_FRAMES frames. With `trace`, the window's frames are timed by CUDA
events as well, and after the window one eager frame of the same
configuration (`unroll="static"`, the same kernels one by one, where the
profiler sees them) runs under torch.profiler and the work count is taken.
The check: every window frame byte-equal to the last, and the last against
the plain reference on a sample of pixels drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench import common, harness, reference

WARMUP_FRAMES = 2


def run(cell, seed: int, seconds: float, trace: bool, device: str, ctx: dict,
        fault=None) -> dict:
    """One run of the cell; returns the compared numbers {name: value}.
    `fault(image)`, for the tests of the check, alters what a frame
    produced."""
    import torch

    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    tr = cell.traffic
    arrays, scene = common.load_scene(cell, seed, ctx)
    cfg = RenderConfig(**tr["render"])
    renderer = SceneRenderer(scene, cfg, device)
    common.stamp(ctx, "renderer built and captured")
    plan = renderer.plan
    if plan is not None:
        ctx["counters"]["capture_ms"] = plan.capture_ms
    steps = []
    events = common.Events(False)

    def frame():
        img = events.around(renderer.render_device)
        if fault is not None:
            img = fault(img)
        out = np.trunc(img.cpu().numpy()).astype(np.uint8)
        if plan is not None:
            steps.append(sum(plan.last_frame.steps))
        return out

    images = []
    for _ in range(WARMUP_FRAMES):
        frame()
    steps.clear()
    common.stamp(ctx, "frames warmed up")
    ctx["setup_s"] = time.perf_counter() - ctx["t_start"]
    events.on = trace
    wall, times = common.window(lambda: images.append(frame()), seconds, torch, device)
    events.on = False
    ctx["window"] = {"seconds": wall, "times": times, "items": len(times),
                     "unit": "frame", "events_ms": events.ms()}
    ctx["counters"]["steps_per_frame"] = (sum(steps) / len(steps)) if steps else None
    ctx["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if torch.device(device).type == "cuda" else 0)
    if trace:
        # the device's busy time from the events: torch.profiler records none
        # of the kernels that the frame graph's WHILE bodies launch
        ctx["device_busy"] = {"busy_s": sum(ctx["window"]["events_ms"]) * 1e-3,
                              "window_s": wall}
        ctx["idle_gaps"] = [("between frames: image to the host, np.trunc", g * 1e-3)
                            for g in sorted(events.gaps_ms(), reverse=True)[:10]]
        before = dict(ck.LAUNCHES)
        frame()
        ctx["launches"] = common.launch_delta(before, ck.LAUNCHES)
        del renderer, plan
        common.free(torch, device)
        # the same configuration's eager frame launches the same kernels one
        # by one, where the profiler sees and names them
        eager = SceneRenderer(scene, dataclasses.replace(cfg, unroll="static"), device)
        eager.render_device()
        before = dict(ck.LAUNCHES)
        ctx["profile"] = common.profiled(eager.render_device, 1, torch)
        ctx["profile_launches"] = common.launch_delta(before, ck.LAUNCHES)
        del eager
    else:
        del renderer, plan
    del scene
    common.free(torch, device)

    last = images[-1]
    checks = {"frames_differ": float(sum(not np.array_equal(im, last) for im in images))}
    rng = np.random.default_rng([seed % (1 << 64), 2])
    n_pix = arrays.width * arrays.height
    pix = np.sort(rng.choice(n_pix, size=min(cell.check["pixels"], n_pix), replace=False))
    t = time.perf_counter()
    sc = reference.ref_scene(arrays, device)
    ref = reference.frame_pixels(sc, tr["render"], torch.from_numpy(pix).to(device))
    ref = ref.cpu().numpy().astype(np.int64)
    got = last.reshape(-1, 3)[pix].astype(np.int64)
    diff = np.abs(got - ref)
    checks["mismatch_pct"] = float((diff > 0).mean() * 100.0)
    harness.log(f"reference: {len(pix)} pixels in {time.perf_counter() - t:.2f} s; "
                f"channels off by 1: {int((diff == 1).sum())}, by more: "
                f"{int((diff > 1).sum())}, largest {int(diff.max())}")
    if trace:
        t = time.perf_counter()
        ctx["work"] = reference.frame_work(sc, tr["render"])
        harness.log(f"work count: {ctx['work']} in {time.perf_counter() - t:.2f} s")
    return checks
