"""Command line: render a `.svati` scene to a PPM or PNG.

    python -m raytracing_gpu_tpu_torch scene.svati out.ppm [--mode cpu|gpu]
        [--backend cuda|cuda_matmul|torch] [--device cuda|cpu] ...

`--device` defaults to cuda and fails when CUDA is not available; only an
explicit `--device cpu` renders on the CPU (with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--time", action="store_true", help="print render time")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from raytracing_gpu_tpu_torch.config import RenderConfig
    from raytracing_gpu_tpu_torch.models.parser import parse_scene
    from raytracing_gpu_tpu_torch.render import render_scene
    from raytracing_gpu_tpu_torch.utils import image as image_io

    cfg = RenderConfig(mode=args.mode, quantize=args.quantize,
                       partitioning=args.partitioning, backend=args.backend,
                       aliasing=args.aliasing, max_bounce=args.max_bounce,
                       ray_chunk=args.ray_chunk)
    scene = parse_scene(args.input)
    t0 = time.perf_counter()
    img = render_scene(scene, cfg, device=args.device)
    dt = time.perf_counter() - t0
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


if __name__ == "__main__":
    sys.exit(main())
