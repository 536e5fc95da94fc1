"""What the traffic kinds' loops (`traffic/<kind>.py`) share: the scene
written as `.svati` and read back by the program's parser, the closed-loop
window, CUDA events around each item, a stretch under torch.profiler.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

from portbench import harness, scenes


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stamp(ctx: dict, stage: str) -> None:
    """Note the seconds since the process started at the end of a set-up
    stage (`run.py` logs them once the run is over)."""
    ctx.setdefault("stamps", []).append((stage, time.perf_counter() - ctx["t_start"]))


def load_scene(cell, seed: int, ctx: dict):
    """(SceneArrays, the program's Scene): the configuration written as
    `.svati` text into TMPDIR and read back by the program's parser."""
    from raytracing_gpu_tpu_torch import parse_scene

    tr = cell.traffic
    arrays = scenes.build(cell.config, tr["width"], tr["height"], seed)
    text = scenes.svati_text(arrays)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{cell.config['name']}.svati")
        with open(path, "w") as f:
            f.write(text)
        t = time.perf_counter()
        scene = parse_scene(path, native="force")
        ctx["counters"]["scene_load_ms"] = (time.perf_counter() - t) * 1e3
    stamp(ctx, "scene parsed")
    return arrays, scene


class Events:
    """CUDA events around the program's call in each item of a traced
    window (the frame graph's launch and finish, or the step), or nothing."""

    def __init__(self, on: bool):
        self.on, self.pairs = on, []

    def around(self, call):
        if not self.on:
            return call()
        import torch

        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = call()
        e1.record()
        self.pairs.append((e0, e1))
        return out

    def ms(self):
        return [e0.elapsed_time(e1) for e0, e1 in self.pairs] if self.pairs else None

    def gaps_ms(self):
        """The device's idle ms between one item's call and the next."""
        return [a[1].elapsed_time(b[0]) for a, b in zip(self.pairs, self.pairs[1:])]


def window(item, seconds: float, torch, device):
    """Run `item()` back to back until `seconds` have passed at the end of
    one: (wall seconds, each item's seconds)."""
    times = []
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        item()
        b = time.perf_counter()
        times.append(b - a)
        if b - w0 >= seconds:
            break
    wall = time.perf_counter() - w0
    sync(torch, device)
    return wall, times


def profiled(fn, n: int, torch):
    """fn() n times under torch.profiler: the reduced trace, its window by
    the host clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = harness.reduce_profile(prof)
    out["window_s"], out["items"] = wall, n
    return out


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def free(torch, device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


