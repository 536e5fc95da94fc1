"""The program's own spans and counters over a recorded stretch of a traced
run: the recorder of `raytracing_gpu_tpu_torch.utils.profiling`, read by
`span_cull_ms.frame`, `span_shade_ms.frame`, `span_sweep_ms.frame`,
`live_ray_pct.frame`, `live_ray_pct.train` and `step_idle_pct.train`.

The first of those readers to run records the stretch (`export(ctx)`), so
it runs after the window, the check and every reader listed before it in
BENCHMARK.json, and nothing those read moves. The others read what it left
in `ctx["spans"]`:

- frames: a fresh `SceneRenderer` of the cell's configuration built inside
  `recording()` (so its frame graph is captured with the stamps and
  counters), WARMUP_FRAMES frames, then RECORDED_FRAMES frames, each ending
  with its uint8 image on the host as the window's do, with CUDA events
  around each call. On the CPU, where `SceneRenderer` renders eagerly, the
  frame plan of the same frame runs, interpreted;
- train: the cell's step built, its start drawn and its first step (on a
  card the capture) taken inside `recording()`, then RECORDED_STEPS steps
  (replays), each ending in a sync, with no profiler running.

The cell, seed and device are those of the enclosing `run.run` call. Where
there is none, or where the program has no recorder (`profiling.recording`
missing, as before it existed), `export` gives None and every reader
returns None. The stretch is logged to standard error: each span's device
ms per frame or step, the loop residual, the idle gaps by name, the clock's
calibration and resolution.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from portbench import common, harness, reference

WARMUP_FRAMES = 2
RECORDED_FRAMES = 10
RECORDED_STEPS = 20
RUN_PY = Path(__file__).resolve().parent / "run.py"


def _enclosing_run():
    """(cell, seed, device) of the `run.run` call this reader runs under, or
    None."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run" and Path(f.f_code.co_filename).resolve() == RUN_PY:
            loc = f.f_locals
            if "cell" in loc and "seed" in loc:
                return loc["cell"], loc["seed"], loc.get("device", "cuda")
        f = f.f_back
    return None


def export(ctx: dict):
    """The recorded stretch of this run (recorded at the first call), or
    None."""
    if "spans" not in ctx:
        from raytracing_gpu_tpu_torch.utils import profiling

        ctx["spans"] = None
        found = _enclosing_run()
        unit = ctx.get("window", {}).get("unit")
        if hasattr(profiling, "recording") and found and unit in ("frame", "step"):
            cell, seed, device = found
            ctx["spans"] = (record_frames if unit == "frame" else record_steps)(
                cell, seed, device, ctx["t_start"])
            summarize(ctx["spans"])
    return ctx["spans"]


def sound(ctx: dict, unit: str):
    """`export(ctx)` where the run is of `unit` ("frame" or "step") and no
    stamp was dropped; else None."""
    if ctx.get("window", {}).get("unit") != unit:
        return None
    spans = export(ctx)
    if spans is None or spans["unit"] != unit or spans["dropped"]:
        return None
    return spans


def record_frames(cell, seed: int, device: str, t_start: float) -> dict:
    """The frames' stretch (module docstring): the recorder's export, with
    `unit` "frame", `steps` (the bounce steps of a frame) and `events_ms` (CUDA events around each recorded frame's call, None on the
    CPU)."""
    import torch

    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu_torch.render import frame_plan
    from raytracing_gpu_tpu_torch.utils import profiling

    _, scene = common.load_scene(cell, seed, {"t_start": t_start, "counters": {}})
    cfg = RenderConfig(**cell.traffic["render"])
    cuda = torch.device(device).type == "cuda"
    events = common.Events(False)
    with profiling.recording(device) as rec:
        renderer = SceneRenderer(scene, cfg, device)
        plan = renderer.plan or frame_plan(renderer.scene, cfg, renderer.depth,
                                           renderer.pack)

        def frame():
            img = events.around(plan.render)
            return np.trunc(img.cpu().numpy()).astype(np.uint8)

        for _ in range(WARMUP_FRAMES):
            frame()
        common.sync(torch, device)
        rec.clear()
        events.on = cuda
        for _ in range(RECORDED_FRAMES):
            frame()
        common.sync(torch, device)
    out = rec.export()
    out["unit"] = "frame"
    out["events_ms"] = events.ms()
    out["steps"] = sum(plan.last_frame.steps)
    del renderer, plan, rec
    common.free(torch, device)
    return out


def record_steps(cell, seed: int, device: str, t_start: float) -> dict:
    """The training stretch (module docstring): the recorder's export, with
    `unit` "step", `last_call` (the plan's, "replay" on a card) and `window_ns` (host ns at the first recorded step's start and after the
    last one's sync)."""
    import torch

    from raytracing_gpu_tpu_torch import RenderConfig
    from raytracing_gpu_tpu_torch.parallel import (
        extract_params,
        make_train_step,
        predict_pixels,
    )
    from raytracing_gpu_tpu_torch.render import required_depth
    from raytracing_gpu_tpu_torch.utils import profiling

    train = harness.plugin("traffic", "train")
    tr = cell.traffic
    arrays, scene = common.load_scene(cell, seed, {"t_start": t_start, "counters": {}})
    cfg = RenderConfig(**tr["render"])
    cuda = torch.device(device).type == "cuda"
    start = train.perturbed_start(arrays, tr["perturb"], seed)
    n_obj, n_tri = len(arrays.objects), arrays.n_triangles
    scene_d = scene.to(device)
    W, H = arrays.width, arrays.height
    coords = reference.cpu_coords(W, H, torch.arange(W * H * 4)).to(device)
    depth = required_depth(float(scene.materials.nr.max()), cfg.reflect_cutoff,
                           cfg.diff_max_depth)
    with torch.no_grad():
        target = predict_pixels(scene_d, cfg, depth, coords, device=device)

    def optimizer(p):
        return torch.optim.Adam([{"params": [p[k]], "lr": lr}
                                 for k, lr in tr["free"].items()], capturable=cuda)

    with profiling.recording(device) as rec:
        # a plan on the CPU too, so that the step has its spans there
        init_state, step_fn = make_train_step(None, cfg, scene, optimizer=optimizer,
                                              device=device, plan=True)
        params = {k: v.clone() for k, v in extract_params(scene).items()}
        params["kd"][:n_obj] = torch.from_numpy(start["kd"])
        params["vertices"][:n_tri] = torch.from_numpy(start["vertices"])
        state = init_state(params)
        state, _ = step_fn(state, scene_d, coords, target)  # on a card: the capture
        common.sync(torch, device)
        rec.clear()
        t0 = time.perf_counter_ns()
        for _ in range(RECORDED_STEPS):
            state, _ = step_fn(state, scene_d, coords, target)
            common.sync(torch, device)
        t1 = time.perf_counter_ns()
    out = rec.export()
    out["unit"] = "step"
    out["window_ns"] = (t0, t1)
    out["last_call"] = step_fn.plan.last_call
    del state, step_fn, init_state, scene_d, target, rec
    common.free(torch, device)
    return out


# ---- what the readers compute ----------------------------------------------

def frames(spans: dict) -> list:
    """Indices into `spans["device"]` of each recorded frame's spans: those
    that start between its `frame.launch` host span's start and the next
    one's."""
    starts = sorted(s.start for s in spans["host"] if s.name == "frame.launch")
    out = [[] for _ in starts]
    for i, s in enumerate(spans["device"]):
        k = bisect.bisect_right(starts, s.start) - 1
        if k >= 0:
            out[k].append(i)
    return out


def per_frame_ms(spans: dict, name: str, self_time: bool = False,
                 parent: str | None = None) -> list:
    """ms of the device spans named `name` in each recorded frame (only those
    directly inside a span named `parent`, if given); with `self_time`, less
    the ms of the spans directly inside them."""
    device = spans["device"]
    child_ns = {}
    if self_time:
        for s in device:
            if s.parent >= 0:
                child_ns[s.parent] = child_ns.get(s.parent, 0) + s.ns
    return [sum(device[i].ns - child_ns.get(i, 0) for i in f if device[i].name == name
                and (parent is None or device[device[i].parent].name == parent))
            * 1e-6 for f in frames(spans)]


def median_ms(spans, name: str, self_time: bool = False, parent: str | None = None):
    ms = per_frame_ms(spans, name, self_time, parent) if spans else []
    return statistics.median(ms) if ms else None


def live_ray_pct(spans):
    if spans is None or not spans["counters"].get("ray_slots"):
        return None
    c = spans["counters"]
    return 100.0 * c["live_rays"] / c["ray_slots"]


def union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def step_idle_pct(spans):
    """100 x (the stretch's host wall time minus the union of the `step`
    device spans within it) / wall time."""
    if spans is None or "window_ns" not in spans:
        return None
    t0, t1 = spans["window_ns"]
    steps = [(max(s.start, t0), min(s.end, t1)) for s in spans["device"]
             if s.name == "step" and s.end > t0 and s.start < t1]
    if not steps or t1 <= t0:
        return None
    return 100.0 * (t1 - t0 - union_ns(steps)) / (t1 - t0)


def summarize(spans) -> None:
    """Log the stretch to standard error."""
    if spans is None:
        return
    names = sorted({s.name for s in spans["device"]})
    if "window_ns" in spans:
        n = len([s for s in spans["device"] if s.name == "step"])
        per = {k: sum(s.ns for s in spans["device"] if s.name == k) * 1e-6 / max(n, 1)
               for k in names}
        what = f"{n} recorded steps, device ms per step"
    else:
        per = {k: median_ms(spans, k) for k in names}
        for k in ("shade", "collide", "shadow", "bounce"):
            per[f"{k} (self)"] = median_ms(spans, k, True)
        for k in ("cull", "sweep"):
            for p in ("collide", "shadow"):
                per[f"{k} (in {p})"] = median_ms(spans, k, parent=p)
        device = spans["device"]
        top = [sum(device[i].ns for i in f if device[i].depth == 0) * 1e-6
               for f in frames(spans)]
        ev = spans.get("events_ms")
        what = f"{len(top)} recorded frames, median device ms per frame"
        if ev:
            cover = [t / e for t, e in zip(top, ev)]
            harness.log(f"spans: rays+bounce+fold cover {min(cover):.4f}-{max(cover):.4f} of "
                        f"each frame's CUDA-event ms (median {statistics.median(ev):.3f} ms); "
                        f"loop residual median {statistics.median(e - t for t, e in zip(top, ev)):.3f}"
                        f" ms a frame")
    harness.log(f"spans: {what}: " + "; ".join(
        f"{k} {v:.3f}" for k, v in per.items() if v is not None))
    gaps = {}
    for name, _, ns in spans["gaps"]:
        gaps[name] = gaps.get(name, 0) + ns
    harness.log(f"spans: {spans['stamps']} stamps, {spans['dropped']} dropped; counters "
                f"{spans['counters']}; idle gaps between top-level device spans, ms by "
                f"host span: { {k: v * 1e-6 for k, v in gaps.items()} }; calibration "
                f"{spans['calibration']}; clock resolution {spans['resolution_ns']}")
