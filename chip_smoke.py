#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from raytracing_gpu_tpu_torch/csrc with nvcc,
checks each against its plain PyTorch version on the card at the shapes the
render gives it, renders the 4,962-triangle sphere scene and the
96,000-triangle sphere grid at 512x512 through the kernel backend, and checks
the kernel render against the all-pairs "torch" backend at 128x128. Any
failure raises and the script exits non-zero; it also exits non-zero when
CUDA is not available. On success the last two lines of stdout are a JSON
object with one entry per kernel and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Timings are CUDA-event times (kernels) and host wall-clock times around
synchronised frames (renders), printed beside the card's nvidia-smi name and
power limit. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
from raytracing_gpu_tpu_torch.csrc import build
from raytracing_gpu_tpu_torch.models.procedural import (
    make_sphere_grid_scene,
    make_sphere_scene,
)
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.intersect import collide
from raytracing_gpu_tpu_torch.ops.shading import shadow_rays
from raytracing_gpu_tpu_torch.render import _pick_block, _swiz_ray_ids

SOURCE = "raytracing_gpu_tpu_torch/csrc/intersect.cu"
PALLAS = "raytracing_gpu_tpu/ops/pallas_intersect.py"
EPS = dict(mt_eps=1e-7, self_hit_eps=0.01)
SPHERES = dict(n_lat=32, n_lon=40)  # 4,962 triangles


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds per call over `iters` calls, after one
    warm-up call."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def primary_rays(scene, n: int):
    """n primary rays, in the render's block-swizzled order, from the pixel
    blocks around the image centre."""
    w, h = scene.camera.width, scene.camera.height
    bx, by = _pick_block(w, h)
    nbx, block = w // bx, 4 * bx * by  # blocks per block row, rays per block
    first = (h // by // 2) * nbx + nbx // 2 - n // block // 2
    start = max(first, 0) * block
    r = _swiz_ray_ids(torch.arange(start, start + n, device=scene.device), w, bx, by)
    coords = camera_ops.cpu_subpixel_coords_traced(w, h, r)
    u, v, C = camera_ops.camera_basis(scene.camera)
    return camera_ops.make_rays(u, v, C, scene.camera.position, coords)


def ulp_histogram(a, b) -> str:
    ai = a.view(torch.int32).long()
    bi = b.view(torch.int32).long()
    d = (ai - bi).abs().clamp(max=16).cpu().numpy()
    return str(np.bincount(d, minlength=2).tolist())


def check_sweep(name, rays, pack, iters):
    """K1 or K2 against its plain version on one packed ray batch:
    bit-equal distances (and equal slots for K1). Returns (max_abs_err,
    kernel ms, plain ms)."""
    o, d = rays
    op, dp, _ = ck.pack_rays(o, d)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])
    kern = {"nearest_hit": ck.nearest_hit, "nearest_dist": ck.nearest_dist}[name]
    plain = {"nearest_hit": ck.nearest_hit_plain,
             "nearest_dist": ck.nearest_dist_plain}[name]
    got, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    if name == "nearest_hit":
        (got, got_idx), (ref, ref_idx) = got, ref
        n_idx = int((got_idx != ref_idx).sum())
        if n_idx:
            raise AssertionError(f"{name}: {n_idx} winner slots differ")
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"{name}: distances not bit-equal; ulp histogram "
                             f"(0..16+) {ulp_histogram(got, ref)}")
    fin = torch.isfinite(ref)
    err = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    ms = cuda_ms(lambda: kern(*args), iters)
    plain_ms = cuda_ms(lambda: plain(*args), 2)
    hits = int(fin.sum())
    if not hits:
        raise AssertionError(f"{name}: no ray hits anything; the check is vacuous")
    say("kernels", f"{name}: {op.shape[1]} rays x {pack.v0.shape[0]} triangles, "
        f"{int(mask.sum())}/{mask.numel()} pair tiles kept, {hits} hits: "
        f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_fetch(pack, idx, iters):
    """K3 against table[idx]: rows must be equal exactly."""
    got = ck.fetch_rows(pack.table, idx)
    ref = ck.fetch_rows_plain(pack.table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("fetch_rows: rows differ from table[idx]")
    ms = cuda_ms(lambda: ck.fetch_rows(pack.table, idx), iters)
    plain_ms = cuda_ms(lambda: ck.fetch_rows_plain(pack.table, idx), iters)
    mb = pack.table.numel() * 4 / 2**20
    say("kernels", f"fetch_rows: {idx.shape[0]} rows of a {tuple(pack.table.shape)} "
        f"table ({mb:.1f} MB): equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return 0.0, ms, plain_ms


def scene_pack(scene):
    g = scene.geometry
    return ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj,
                            scene.materials)


def time_frames(renderer, n: int):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = renderer.render_device()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return img, times


def check_image(img, w, h):
    if tuple(img.shape) != (h, w, 3):
        raise AssertionError(f"image shape {tuple(img.shape)} != {(h, w, 3)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("image has non-finite pixels")
    if float(img.min()) < 0.0 or float(img.max()) > 255.0:
        raise AssertionError("image outside [0, 255]")


def check_kernels(dev):
    """K1, K2 and K3 against their plain versions on the card, at the
    shapes the render gives them: one 65,536-ray chunk of the sphere
    scene's primary rays, its 131,072 shadow rays, and 4,096 rays of the
    96k-triangle grid (interval hierarchy, 12 MB table). Returns
    {kernel: (max_abs_err, ms, plain_ms)} at the sphere scene's shapes."""
    sph = make_sphere_scene(512, 512, **SPHERES).to(dev)
    sph_pack = scene_pack(sph)
    grid = make_sphere_grid_scene(512, 512).to(dev)
    grid_pack = scene_pack(grid)
    say("kernels", f"sphere scene {sph.n_triangles} triangles; grid "
        f"{grid.n_triangles} triangles ({grid_pack.table.numel() * 4 / 2**20:.1f} MB table)")
    results = {}
    prim = primary_rays(sph, RenderConfig().ray_chunk)
    results["nearest_hit"] = check_sweep("nearest_hit", prim, sph_pack, 20)
    hit = collide(*prim, sph.geometry, backend="cuda", pack=sph_pack)
    op, dp, _ = ck.pack_rays(*prim)
    mask = ck.tile_cull_mask_hierarchical(op, dp, sph_pack, "octree")
    idx = ck.nearest_hit(op, dp, sph_pack.v0, sph_pack.e1, sph_pack.e2, mask,
                         **EPS)[1][:prim[0].shape[0]]
    results["fetch_rows"] = check_fetch(sph_pack, idx, 50)
    so, sd, _ = shadow_rays(sph.lights, hit)
    results["nearest_dist"] = check_sweep("nearest_dist", (so, sd), sph_pack, 20)
    gprim = primary_rays(grid, 4096)
    check_sweep("nearest_hit", gprim, grid_pack, 10)
    check_sweep("nearest_dist", gprim, grid_pack, 10)
    gop, gdp, _ = ck.pack_rays(*gprim)
    gmask = ck.tile_cull_mask_hierarchical(gop, gdp, grid_pack, "octree")
    gidx = ck.nearest_hit(gop, gdp, grid_pack.v0, grid_pack.e1, grid_pack.e2,
                          gmask, **EPS)[1]
    check_fetch(grid_pack, gidx, 50)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say("device", f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path = build.library_path()
    ck.build_kernels()
    say("build", f"{path} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "bytes smem" in line:
            say("build", line.strip())

    results = check_kernels(dev)
    cfg = RenderConfig(backend="cuda")

    # ---- the main path: a 512x512 frame of the sphere scene on the kernels
    renderer = SceneRenderer(make_sphere_scene(512, 512, **SPHERES), cfg, dev)
    ck.reset_launch_counts()
    img = renderer.render_device()
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    say("render", f"sphere 512x512 launches in one frame: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the render never launched {name}")
    check_image(img, 512, 512)
    img, times = time_frames(renderer, 3)
    check_image(img, 512, 512)
    ms = float(np.median(times))
    say("render", f"sphere 512x512 ({renderer.scene.n_triangles} tris, depth "
        f"{renderer.depth}): frames {[round(t, 3) for t in times]} ms, median "
        f"{ms:.3f} ms/frame, {512 * 512 * 4 / ms * 1e3 / 1e6:.3f} M primary "
        f"rays/s; {smi}")

    small = make_sphere_scene(128, 128, **SPHERES)
    ref = SceneRenderer(small, RenderConfig(backend="torch"), dev).render()
    got = SceneRenderer(small, cfg, dev).render()
    a, b = np.trunc(got).astype(np.int32), np.trunc(ref).astype(np.int32)
    n_diff = int((a != b).any(-1).sum())
    if n_diff:
        raise AssertionError(f"128x128 cuda render differs from the torch "
                             f"backend on {n_diff} pixels (max |d| "
                             f"{int(np.abs(a - b).max())})")
    say("render", "sphere 128x128: cuda backend uint8-equal to the torch backend")

    # ---- the 96k-triangle grid: interval hierarchy, large-table fetch
    grenderer = SceneRenderer(make_sphere_grid_scene(512, 512), cfg, dev)
    img, times = time_frames(grenderer, 3)
    check_image(img, 512, 512)
    gms = float(np.median(times[1:]))
    say("render", f"grid 512x512 ({grenderer.scene.n_triangles} tris): frames "
        f"{[round(t, 3) for t in times]} ms, median of warm {gms:.3f} ms/frame, "
        f"{512 * 512 * 4 / gms * 1e3 / 1e6:.3f} M primary rays/s; {smi}")

    replaces = {"nearest_hit": f"{PALLAS}:230", "nearest_dist": f"{PALLAS}:316",
                "fetch_rows": f"{PALLAS}:523"}
    kernels = []
    for name in ("nearest_hit", "nearest_dist", "fetch_rows"):
        err, kms, pms = results[name]
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": replaces[name], "launches": launches[name],
                 "max_abs_err": err, "ms": kms, "plain_ms": pms}
        if name == "fetch_rows":
            entry["also_replaces"] = f"{PALLAS}:568"
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
