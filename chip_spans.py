#!/usr/bin/env python3
"""The program recorder (`utils/profiling.py`) measured on one NVIDIA GPU,
on the benchmark's `spheres` cells (`portbench/`).

    python3 chip_spans.py nodes [--root DIR] [--out DIR]
    python3 chip_spans.py cost [--seconds S] [--out DIR]
    python3 chip_spans.py long [--seconds S] [--out DIR]

- `nodes`: each piece's node types in the frame graph of
  `spheres-cpu512-frames` and `spheres-gpu3-frames` (`FramePlan.piece_nodes`)
  with the recorder off and, where the program has one, on. `--root DIR`
  imports the program from another checkout (a parent commit's), so that the
  two can be compared on the card.
- `cost`: the recorder's cost. Two renderers of `spheres-cpu512-frames`, one
  captured with the recorder off and one inside `recording()`, render
  frames in turns (off, on, on, off, ...) for `--seconds` after a settling
  stretch, each frame ending with its uint8 image on the host as the cell's
  do, timed by the host clock and by CUDA events around the call; the
  recorder is on around each "on" frame only. Then the same for two
  captured steps of `spheres-train256-steps`, each ending in a sync. Prints
  the medians and the recorded stretch's stamps, drift and clock resolution.
- `long`: one recorded run of `spheres-cpu512-frames` for `--seconds`
  (60 by default) from its capture: device ms per frame of each span
  (`rays`, `bounce`, `collide`, `cull`, `sweep`, `shade`, `shadow`,
  `update`, `fold`) and the loop residual against the seconds since the
  capture, in bins of 5 s.

Each prints its lines and, with `--out DIR`, writes its numbers to
`DIR/<phase>.<change|parent>.json`. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 16
BINS_S = 5.0


def _args(argv):
    phase = argv[0] if argv else "cost"
    opts = dict(zip(argv[1::2], argv[2::2]))
    return phase, opts


def say(msg: str) -> None:
    print(msg, flush=True)


def _cell(name):
    from portbench import common, harness

    cell = harness.load_cell(name)
    ctx = {"t_start": time.perf_counter(), "counters": {}}
    arrays, scene = common.load_scene(cell, SEED, ctx)
    return cell, arrays, scene


def _frame(renderer):
    """One frame as the cell's: (host ms, event ms)."""
    import numpy as np
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    img = renderer.render_device()
    e1.record()
    np.trunc(img.cpu().numpy()).astype(np.uint8)
    t1 = time.perf_counter()
    return (t1 - t0) * 1e3, e0.elapsed_time(e1)


def nodes(opts) -> dict:
    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu_torch.utils import profiling

    out = {}
    for name in ("spheres-cpu512-frames", "spheres-gpu3-frames"):
        cell, _, scene = _cell(name)
        cfg = RenderConfig(**cell.traffic["render"])
        out[name] = {"off": SceneRenderer(scene, cfg, "cuda").plan.piece_nodes}
        if hasattr(profiling, "recording"):
            with profiling.recording():
                out[name]["on"] = SceneRenderer(scene, cfg, "cuda").plan.piece_nodes
        say(f"{name}: {out[name]}")
    return out


def _turns(sides: dict, call, seconds: float, settle: float) -> dict:
    """`call(side)` for the sides in turns (a, b, b, a, ...) for `settle`
    seconds unrecorded, then `seconds`: {side: [(seconds since start,
    host ms, event ms)]}."""
    from raytracing_gpu_tpu_torch.utils import profiling

    names = list(sides)
    got = {n: [] for n in names}
    t0 = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter() - t0
        if now >= settle + seconds:
            break
        for n in (names if k % 2 == 0 else names[::-1]):
            if n == "on":  # host spans and the sync count as a user sees them
                with profiling.recording():
                    ms = call(n)
            else:
                ms = call(n)
            if now >= settle:
                got[n].append((now, *ms))
        k += 1
    return got


def _summary(got: dict, what: str) -> dict:
    out = {}
    for n, rows in got.items():
        out[n] = {"n": len(rows), "host_ms": statistics.median(r[1] for r in rows),
                  "event_ms": statistics.median(r[2] for r in rows)}
    off, on = out["off"], out["on"]
    out["on_over_off"] = {k: on[k] / off[k] - 1 for k in ("host_ms", "event_ms")}
    say(f"{what}: off {off}; on {on}; on/off - 1: {out['on_over_off']}")
    return out


def cost(opts) -> dict:
    import torch

    from portbench import harness, reference, spans
    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu_torch.parallel import (
        extract_params,
        make_train_step,
        predict_pixels,
    )
    from raytracing_gpu_tpu_torch.render import required_depth
    from raytracing_gpu_tpu_torch.utils import profiling

    seconds = float(opts.get("--seconds", 30))
    out = {}
    cell, _, scene = _cell("spheres-cpu512-frames")
    cfg = RenderConfig(**cell.traffic["render"])
    off = SceneRenderer(scene, cfg, "cuda")
    with profiling.recording() as rec:
        on = SceneRenderer(scene, cfg, "cuda")
        _frame(on)
        torch.cuda.synchronize()
        rec.clear()
        _frame(on)
        torch.cuda.synchronize()
    ex = rec.export()
    ex["unit"], ex["events_ms"], ex["steps"] = "frame", None, sum(on.plan.last_frame.steps)
    out["one_frame"] = {"stamps": ex["stamps"], "dropped": ex["dropped"],
                        "resolution_ns": ex["resolution_ns"],
                        "calibration": ex["calibration"], "steps": ex["steps"],
                        "piece_nodes_off": off.plan.piece_nodes,
                        "piece_nodes_on": on.plan.piece_nodes}
    say(f"frames: one recorded frame {out['one_frame']}")
    spans.summarize(ex)
    renderers = {"off": off, "on": on}
    out["frames"] = _summary(_turns(renderers, lambda n: _frame(renderers[n]), seconds,
                                    10.0), "spheres-cpu512-frames, ms a frame")
    del off, on, renderers
    torch.cuda.empty_cache()

    cell = harness.load_cell("spheres-train256-steps")
    train = harness.plugin("traffic", "train")
    _, arrays, scene = _cell("spheres-train256-steps")
    tr = cell.traffic
    cfg = RenderConfig(**tr["render"])
    start = train.perturbed_start(arrays, tr["perturb"], SEED)
    scene_d = scene.to("cuda")
    W, H = arrays.width, arrays.height
    coords = reference.cpu_coords(W, H, torch.arange(W * H * 4)).to("cuda")
    depth = required_depth(float(scene.materials.nr.max()), cfg.reflect_cutoff,
                           cfg.diff_max_depth)
    with torch.no_grad():
        target = predict_pixels(scene_d, cfg, depth, coords, device="cuda")

    def build():
        init_state, step_fn = make_train_step(
            None, cfg, scene, device="cuda",
            optimizer=lambda p: torch.optim.Adam(
                [{"params": [p[k]], "lr": lr} for k, lr in tr["free"].items()],
                capturable=True))
        params = {k: v.clone() for k, v in extract_params(scene).items()}
        params["kd"][:len(arrays.objects)] = torch.from_numpy(start["kd"])
        params["vertices"][:arrays.n_triangles] = torch.from_numpy(start["vertices"])
        state = init_state(params)
        state, _ = step_fn(state, scene_d, coords, target)
        torch.cuda.synchronize()
        return [state, step_fn]

    steps = {"off": build()}
    with profiling.recording() as rec:
        steps["on"] = build()

    def step(n):
        state, step_fn = steps[n]
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        steps[n][0], _ = step_fn(state, scene_d, coords, target)
        e1.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)

    out["steps"] = _summary(_turns(steps, step, seconds, 5.0),
                            "spheres-train256-steps, ms a step")
    ex = rec.export()
    out["steps"]["stamps_per_step"] = ex["stamps"] / max(
        1, sum(s.name == "step" for s in ex["device"]))
    out["steps"]["dropped"] = ex["dropped"]
    return out


class Clocks:
    """nvidia-smi's SM and memory clocks, power draw and performance state,
    sampled every `every` seconds on a thread while the block runs."""

    QUERY = "clocks.sm,clocks.mem,power.draw,pstate"

    def __init__(self, every: float = 0.5):
        import threading

        self.every, self.rows, self._stop = every, [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import subprocess

        t0 = time.perf_counter()
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", f"--query-gpu={self.QUERY}",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.strip()
            self.rows.append((time.perf_counter() - t0, out.splitlines()[0] if out else ""))
            self._stop.wait(self.every)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        return False


def long(opts) -> dict:
    import torch

    from portbench import spans
    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu_torch.utils import profiling

    seconds = float(opts.get("--seconds", 60))
    cell, _, scene = _cell("spheres-cpu512-frames")
    cfg = RenderConfig(**cell.traffic["render"])
    events = []
    with profiling.recording() as rec, Clocks() as clocks:
        t_cap = time.perf_counter()
        r = SceneRenderer(scene, cfg, "cuda")
        t_built = time.perf_counter()
        while time.perf_counter() - t_built < seconds:
            events.append((time.perf_counter() - t_built, *_frame(r)))
        torch.cuda.synchronize()
    # the clocks' samples on the frames' time line (seconds since the build)
    clock_rows = [(t - (t_built - t_cap), row) for t, row in clocks.rows]
    ex = rec.export()
    ex["unit"], ex["events_ms"] = "frame", [e[2] for e in events]
    per = {}
    names = ("rays", "bounce", "collide", "cull", "sweep", "shade", "shadow", "update",
             "fold")
    for n in names:
        per[n] = spans.per_frame_ms(ex, n)
    for k in ("shade", "collide", "shadow"):
        per[f"{k} (self)"] = spans.per_frame_ms(ex, k, True)
    for k in ("cull", "sweep"):
        for p in ("collide", "shadow"):
            per[f"{k} (in {p})"] = spans.per_frame_ms(ex, k, parent=p)
    dev = ex["device"]
    top = [sum(dev[i].ns for i in f if dev[i].depth == 0) * 1e-6 for f in spans.frames(ex)]
    n = min(len(top), len(events))
    per["residual"] = [events[i][2] - top[i] for i in range(n)]
    per["events"] = [e[2] for e in events]
    per["host"] = [e[1] for e in events]
    since = [e[0] for e in events]
    out = {"capture_s": t_built - t_cap, "frames": len(events), "stamps": ex["stamps"],
           "dropped": ex["dropped"], "calibration": ex["calibration"],
           "resolution_ns": ex["resolution_ns"], "counters": ex["counters"],
           "bins": []}
    say(f"long: {len(events)} frames in {seconds} s after a {t_built - t_cap:.2f} s "
        f"build; {ex['stamps']} stamps, {ex['dropped']} dropped; calibration "
        f"{ex['calibration']}; resolution {ex['resolution_ns']}")
    b = 0.0
    while b < seconds:
        idx = [i for i in range(n) if b <= since[i] < b + BINS_S]
        if idx:
            row = {"from_s": b, "frames": len(idx)}
            for k, v in per.items():
                row[k] = statistics.median(v[i] for i in idx)
            out["bins"].append(row)
            say("long: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in row.items()))
        b += BINS_S
    out["per_frame"] = {k: v[:n] for k, v in per.items()}
    out["since_s"] = since[:n]
    out["clocks"] = {"query": Clocks.QUERY, "rows": clock_rows}
    switch = [i for i in range(1, n) if per["events"][i] < 0.95 * per["events"][i - 1]]
    for i in switch[:3]:  # the frames around each step down, with the clocks near it
        near = [r for r in clock_rows if since[i] - 2 <= r[0] <= since[i] + 1]
        say(f"long: step down at {since[i]:.2f} s ({per['events'][i - 1]:.2f} -> "
            f"{per['events'][i]:.2f} ms); {Clocks.QUERY} around it: {near}")
    say(f"long: {Clocks.QUERY} first / last: {clock_rows[:2]} / {clock_rows[-2:]}")
    return out


def main(argv) -> int:
    phase, opts = _args(argv)
    root = opts.get("--root", ROOT)
    sys.path.insert(0, os.path.abspath(root))
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_spans: CUDA is not available", file=sys.stderr)
        return 1
    import raytracing_gpu_tpu_torch

    say(f"{phase}: program from {os.path.dirname(raytracing_gpu_tpu_torch.__file__)}; "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    from portbench import harness

    say(f"card: {harness.power_limit()}")
    out = {"nodes": nodes, "cost": cost, "long": long}[phase](opts)
    if "--out" in opts:
        os.makedirs(opts["--out"], exist_ok=True)
        tag = "parent" if root != ROOT else "change"
        with open(os.path.join(opts["--out"], f"{phase}.{tag}.json"), "w") as f:
            json.dump(out, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
