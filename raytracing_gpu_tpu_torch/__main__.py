"""Command line: render a `.svati` scene to a PPM or PNG.

    python -m raytracing_gpu_tpu_torch scene.svati out.ppm [--mode cpu|gpu]
        [--backend cuda|cuda_matmul|torch] [--device cuda|cpu] ...

`--device` defaults to cuda and fails when CUDA is not available; only an
explicit `--device cpu` renders on the CPU (with the kernels' plain versions).
`--profile DIR` writes two Chrome traces of the render into DIR, each one
file per process: torch.profiler's (`trace.*.json`: host calls and the
kernels it sees) and the program recorder's (`program.*.json`,
`utils.profiling.recording`: the program's spans, on a host track and a
device track on the one clock, and the device's idle gaps), which also sees
inside the frame graph's WHILE bodies, where torch.profiler records nothing:
the rays, bounce and fold pieces and, in each bounce step, collide (cull,
sweep), shade (shadow) and update.

Sharded over N * S processes, one per device, rays over N tiles and the
triangles over S scene shards; rank 0 writes the image:

    torchrun --nproc-per-node N*S -m raytracing_gpu_tpu_torch scene.svati \
        out.ppm --tiles N --scene-shards S
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracing_gpu_tpu_torch",
        description="Whitted-style triangle-mesh ray tracer reproducing the "
        "reference's CPU and GPU pipelines (PyTorch + CUDA port of "
        "raytracing_gpu_tpu).")
    p.add_argument("input", help=".svati scene file")
    p.add_argument("output", help="output image (.ppm ASCII P3 or .png)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--mode", choices=["cpu", "gpu"], default="cpu",
                   help="reference pipeline to reproduce: cpu = 2x2 "
                   "supersampling + recursion; gpu = aliasing-x upscale + "
                   "box downscale + bounce cap (default: cpu)")
    p.add_argument("--quantize", choices=["match", "smooth"], default="match",
                   help="match = clamp at every color op like cpu/colors.c; "
                   "smooth = linear f32, clamp once")
    p.add_argument("--partitioning", choices=["none", "aabb", "octree"],
                   default="octree", help="tile culling structure")
    p.add_argument("--backend", choices=["cuda", "cuda_matmul", "torch"],
                   default="cuda",
                   help="cuda = hand-written kernels (plain versions on the "
                   "CPU); cuda_matmul = the same path with the sweeps in "
                   "matmul form; torch = all-pairs reference")
    p.add_argument("--aliasing", type=int, default=3,
                   help="gpu-mode supersampling factor (gpu/rt.cpp:67)")
    p.add_argument("--max-bounce", type=int, default=10,
                   help="gpu-mode bounce cap (gpu/raytracer.cu:113)")
    p.add_argument("--ray-chunk", type=int, default=65536,
                   help="rays traced per chunk")
    p.add_argument("--unroll", choices=["auto", "while", "static"],
                   default="auto",
                   help="bounce-loop strategy: static (or auto with "
                   "quantize=smooth) renders eagerly and lets remat "
                   "checkpoint each bounce step; otherwise the GPU launches "
                   "the frame as one CUDA graph captured once")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard rays over N processes (0 = one process); "
                   "launch the processes with torchrun")
    p.add_argument("--scene-shards", type=int, default=1,
                   help="shard triangles over S processes (scene axis)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write two Chrome traces of the render to DIR, one file "
                   "each per process: torch.profiler's (trace.*.json) and the "
                   "program recorder's spans, host and device on one clock, "
                   "bounce steps inside the frame graph included (program.*.json)")
    p.add_argument("--time", action="store_true", help="print render time")
    return p


def _sharded_mesh(args):
    """The (tiles, scene) mesh of a `--tiles` run, in the process group
    torchrun started (env://); raises where the group is missing or too
    small."""
    import torch.distributed as dist

    from raytracing_gpu_tpu_torch.parallel import make_mesh, multihost

    need = args.tiles * args.scene_shards
    if "WORLD_SIZE" in os.environ:
        multihost.initialize(backend="gloo" if args.device == "cpu" else None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise SystemExit(
            f"--tiles {args.tiles} --scene-shards {args.scene_shards} needs {need} "
            f"processes, this run has {world}: launch it as torchrun "
            f"--nproc-per-node {need} -m raytracing_gpu_tpu_torch {args.input} "
            f"{args.output} --tiles {args.tiles} --scene-shards {args.scene_shards}")
    return make_mesh(args.tiles, args.scene_shards)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch.config import RenderConfig
    from raytracing_gpu_tpu_torch.models.parser import parse_scene
    from raytracing_gpu_tpu_torch.render import render_scene
    from raytracing_gpu_tpu_torch.utils import image as image_io
    from raytracing_gpu_tpu_torch.utils import profiling

    cfg = RenderConfig(mode=args.mode, quantize=args.quantize,
                       partitioning=args.partitioning, backend=args.backend,
                       aliasing=args.aliasing, max_bounce=args.max_bounce,
                       ray_chunk=args.ray_chunk, unroll=args.unroll)
    scene = parse_scene(args.input)
    mesh = _sharded_mesh(args) if args.tiles else None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as profiled:
        if args.profile:
            profiled.enter_context(profiling.trace(args.profile))
            recorder = profiled.enter_context(profiling.recording(args.device))
        if mesh is None:
            img = render_scene(scene, cfg, device=args.device)
        else:
            from raytracing_gpu_tpu_torch.parallel import render_scene_sharded

            img = render_scene_sharded(scene, cfg, mesh, device=args.device)
    dt = time.perf_counter() - t0
    if args.profile:
        profiling.write_chrome_trace(recorder.export(), args.profile)
    if _rank() != 0:
        return 0  # every rank holds the image; rank 0 writes it
    if args.output.endswith(".png"):
        image_io.write_png(args.output, np.trunc(img).astype(np.uint8))
    else:
        image_io.write_ppm(args.output, img)
    if args.time:
        w, h = scene.camera.width, scene.camera.height
        dev = torch.device(args.device)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        per_pixel = 4 if cfg.mode == "cpu" else cfg.aliasing ** 2
        print(f"{w}x{h} in {dt:.3f}s on {name} "
              f"({w * h * per_pixel / dt:,.0f} primary rays/s)",
              file=sys.stderr)
    return 0


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    code = main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(code)
