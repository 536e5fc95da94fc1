#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from raytracing_gpu_tpu_torch/csrc with nvcc,
checks each of the six against its plain PyTorch version on the card at the
shapes the renders give it, and drives every ported path through
`SceneRenderer`:

- CPU mode, backend "cuda": the 4,962-triangle sphere scene and the
  96,000-triangle sphere grid at 512x512 (K1, K2, K3), the kernel render
  against the all-pairs "torch" backend at 128x128 (equal without that
  backend's object-level cull, and up to the hits on an object's box edges
  with it), and the grid again with
  the two-round front-to-back sweep (`f2b_tiles=8`), equal to the frame
  without it;
- GPU mode: the sphere scene at 512x512 output and aliasing 3 (2,359,296
  primary rays) with the any-hit shadow sweep forced on (K1, K3, K4), equal
  to the same frame through the distance sweep, and a 64x64 GPU-mode frame
  against the "torch" backend;
- backend "cuda_matmul": the sphere scene at 512x512 in CPU mode (K5, K6,
  K3), held against the "cuda" frame by the edge-aware comparator;
- training (`parallel.make_train_step`): K3's gradient (`FetchRows`) against
  autograd of the plain `table[idx]`; the gradient of `mean(render_image)` on
  the card against the same backend on CPU tensors (the kernels' plain
  versions) for all 13 parameter groups at 32x32 and 3 bounces, twice on the
  card; 20 Adam
  steps on the sphere scene at 256x256 (262,144 rays in 4 chunks, depth 6,
  `remat=True`; K1, K2, K3 and K3's gradient) recovering perturbed `kd` and
  `lights_rgb` from a target rendered at the true parameters, the same first
  3 steps with `remat=False` beside them, one step with the vertices free too, and a
  save / resume round trip of the train state.

Before each of these paths the launch counts are set to 0 and read just
after its frame. Any failure raises and the script exits non-zero; it also
exits non-zero when CUDA is not available. On success the last three lines
of stdout are a JSON object with one entry per kernel, the card's nvidia-smi
name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

A kernel has two times. `ms` is the wrapper's: CUDA events around a loop of
eager calls, so it holds the wrapper's host work and its launch gaps
whenever those outlast the kernel. `device_ms` is the device's alone: the
same calls captured into one CUDA graph and replayed between two events.
`library_ms` and `library_device_ms` are the same two readings of the one
PyTorch call that computes the same function (K3: `torch.index_select`).
Frames and training steps are host wall-clock times around synchronised
calls. Every sweep
(K1, K2, K4, K5, K6) is also run twice on the same inputs (its combine across
blocks must not depend on their order) and on one full 65,536-ray chunk of
the grid, K1 on rays that tie exactly across triangle tiles too. K4's count
of scanned units depends on how its blocks overlap in time, so it is held to
inequalities only: never more than 4 per kept pair tile, and fewer than that
on ray tiles that saturate. A kernel's `bound_ms` is the least time the
card could take for the same call: the larger of its floating-point
operations over 67 TFLOP/s and its bytes (inputs read once, outputs written
once) over 3.35 TB/s, the published peaks of an H100 SXM at 700 W; the work
is counted for this run's data (pair tiles kept by the culling, the
64-triangle units the any-hit sweep scanned before its early exit).
`--profile` also traces one warm frame of each path with torch.profiler and
prints kernel launches (the three paths' side by side at the end) and the
device's busy share, and K3's wrapper's host time by its parts at 4,096 and
65,536 rows. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, render_image
from raytracing_gpu_tpu_torch.csrc import build
from raytracing_gpu_tpu_torch.models.procedural import (
    make_sphere_grid_scene,
    make_sphere_scene,
)
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.intersect import collide
from raytracing_gpu_tpu_torch.ops.shading import shadow_rays
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
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS
from raytracing_gpu_tpu_torch.render import _pick_block, _swiz_ray_ids
from raytracing_gpu_tpu_torch.utils.compare import assert_images_close

SOURCE = "raytracing_gpu_tpu_torch/csrc/intersect.cu"
PALLAS = "raytracing_gpu_tpu/ops/pallas_intersect.py"
REPLACES = {"nearest_hit": f"{PALLAS}:230", "nearest_dist": f"{PALLAS}:316",
            "fetch_rows": f"{PALLAS}:523", "any_hit": f"{PALLAS}:407",
            "nearest_hit_matmul": f"{PALLAS}:794",
            "nearest_dist_matmul": f"{PALLAS}:844"}
EPS = dict(mt_eps=1e-7, self_hit_eps=0.01)
SPHERES = dict(n_lat=32, n_lon=40)  # 4,962 triangles
ALIASING = 3

# published peaks of one H100 SXM (700 W): FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (ray, triangle) pair: Möller–Trumbore in scalar form
# (the JAX package's cost estimate) and in matmul form (34 in the four
# products over the 19 non-zero feature rows, 20 in the epilogue)
OPS_PER_PAIR = 60
OPS_PER_PAIR_MATMUL = 54
PAIRS_PER_TILE = ck.TILE_R * ck.TILE_T
# the matmul backend may flip winners on exact geometry edges only: more than
# this share of a chunk's rays disagreeing with K1 fails
MAX_EDGE_FLIP_SHARE = 1e-3


T_START = time.perf_counter()


def say(phase: str, msg: str) -> None:
    """One line of the report, with the seconds since the script started."""
    print(f"[{phase}] {time.perf_counter() - T_START:6.1f}s {msg}", flush=True)


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


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call of `fn`."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device-only milliseconds per call: `launches` calls captured into one
    CUDA graph, the graph replayed `replays` times between two events. No
    host work of the wrapper is inside the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds the card could take, which side binds)."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_bytes(Rp: int, Tp: int, out_per_ray: int) -> int:
    """Bytes a sweep must move: packed rays (24 bytes each), triangles (36),
    the pair-tile mask and the per-ray outputs."""
    nR, nT = Rp // ck.TILE_R, Tp // ck.TILE_T
    return Rp * 24 + Tp * 36 + nR * nT * 4 + Rp * out_per_ray


def cpu_primary_rays(scene, n: int):
    """n CPU-mode primary rays, in the render's block-swizzled order, from
    the pixel blocks around the image centre."""
    w, h = scene.camera.width, scene.camera.height
    bx, by = _pick_block(w, h)
    nbx, block = w // bx, 4 * bx * by  # blocks per block row, rays per block
    first = (h // by // 2) * nbx + nbx // 2 - n // block // 2
    start = max(first, 0) * block
    r = _swiz_ray_ids(torch.arange(start, start + n, device=scene.device), w, bx, by)
    coords = camera_ops.cpu_subpixel_coords_traced(w, h, r)
    u, v, C = camera_ops.camera_basis(scene.camera)
    return camera_ops.make_rays(u, v, C, scene.camera.position, coords)


def gpu_primary_rays(scene_hi, n: int):
    """The n-ray chunk of GPU-mode primary rays (row-major hi-res pixels)
    that holds the image centre; `scene_hi` carries the hi-res camera."""
    w, h = scene_hi.camera.width, scene_hi.camera.height
    start = (w * h // 2) // n * n
    r = torch.arange(start, start + n, device=scene_hi.device)
    coords = camera_ops.gpu_pixel_coords_traced(w, h, r)
    u, v, C = camera_ops.camera_basis(scene_hi.camera)
    return camera_ops.make_rays(u, v, C, scene_hi.camera.position, coords)


def ulp_histogram(a, b) -> str:
    ai = a.view(torch.int32).long()
    bi = b.view(torch.int32).long()
    d = (ai - bi).abs().clamp(max=16).cpu().numpy()
    return str(np.bincount(d, minlength=2).tolist())


def require_bit_equal(name, got, ref):
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"{name}: distances not bit-equal; ulp histogram "
                             f"(0..16+) {ulp_histogram(got, ref)}")


def max_err(got, ref) -> float:
    fin = torch.isfinite(ref)
    if not bool(fin.any()):
        raise AssertionError("no ray hits anything; the check is vacuous")
    return float((got[fin] - ref[fin]).abs().max())


SWEEPS = {"nearest_hit": (ck.nearest_hit, ck.nearest_hit_plain),
          "nearest_dist": (ck.nearest_dist, ck.nearest_dist_plain)}


def sweep_args(rays, pack):
    op, dp, _ = ck.pack_rays(*rays)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    return (op, dp, pack.v0, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])


def require_sweep_equal(name, got, ref, what):
    """Bit-equal distances, and equal slots for K1."""
    if name == "nearest_hit":
        n_idx = int((got[1] != ref[1]).sum())
        if n_idx:
            raise AssertionError(f"{name} ({what}): {n_idx} winner slots differ")
        got, ref = got[0], ref[0]
    require_bit_equal(f"{name} ({what})", got, ref)
    return got, ref


def check_sweep(name, rays, pack, iters, what, plain_once=False):
    """K1 or K2 against its plain version on one packed ray batch:
    bit-equal distances (and equal slots for K1), and the kernel against
    itself on a second run. `plain_once` times the plain version by its one
    reference run (a full chunk against the grid takes seconds)."""
    args = sweep_args(rays, pack)
    kern, plain = SWEEPS[name]
    ref, plain_ms = timed_once(lambda: plain(*args))
    got, again = kern(*args), kern(*args)
    torch.cuda.synchronize()
    require_sweep_equal(name, again, got, what + ", second run against first")
    got, ref = require_sweep_equal(name, got, ref, what)
    mask = args[5]
    Rp, Tp, kept = args[0].shape[1], pack.v0.shape[0], int(mask.sum())
    bms, by = bound(kept * PAIRS_PER_TILE * OPS_PER_PAIR,
                    sweep_bytes(Rp, Tp, 8 if name == "nearest_hit" else 4))
    res = dict(max_abs_err=max_err(got, ref), ms=cuda_ms(lambda: kern(*args), iters),
               device_ms=device_ms(lambda: kern(*args)),
               plain_ms=plain_ms if plain_once else cuda_ms(lambda: plain(*args), 2),
               bound_ms=bms, bound_by=by, library_ms=None, library_device_ms=None)
    say("kernels", f"{name} ({what}): {Rp} rays x {Tp} triangles, {kept}/"
        f"{mask.numel()} pair tiles kept, {int(torch.isfinite(ref).sum())} hits: "
        f"bit-equal, and to its own second run; wrapper {res['ms']:.4f} ms, "
        f"device only {res['device_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"bound {bms:.5f} ms ({by})")
    return res


def tie_case(dev, n_tiles: int = 64, n_rays: int = 1024):
    """Rays and triangles with exact ties across triangle tiles: four
    coincident copies of one quad (y = 0), each in another tile and at
    another place in it, a fifth copy below them (y = -0.5) in the lowest
    slots of all, every other slot degenerate; rays fall straight down on
    and around the quads from several heights. Returns (sweep arguments, the two slots that must win)."""
    Tp = n_tiles * ck.TILE_T
    v0, e1, e2 = (torch.zeros((Tp, 3)) for _ in range(3))

    def put_quad(slot, y):
        v0[slot:slot + 2] = torch.tensor([-1.0, y, -1.0])
        e1[slot], e2[slot] = torch.tensor([2.0, 0, 0]), torch.tensor([2.0, 0, 2.0])
        e1[slot + 1], e2[slot + 1] = torch.tensor([2.0, 0, 2.0]), torch.tensor([0, 0, 2.0])

    first = 3 * ck.TILE_T + 17
    for slot in (first, 9 * ck.TILE_T + 200, 40 * ck.TILE_T, 63 * ck.TILE_T + 254):
        put_quad(slot, 0.0)
    put_quad(5, -0.5)
    gen = torch.Generator().manual_seed(11)
    xz = torch.rand((n_rays, 2), generator=gen) * 2.6 - 1.3
    height = torch.rand((n_rays,), generator=gen) * 2.0 + 2.0
    o = torch.stack([xz[:, 0], height, xz[:, 1]], 1)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n_rays, 3)
    op, dp, _ = ck.pack_rays(o.to(dev), d.to(dev))
    mask = torch.ones((n_tiles, op.shape[1] // ck.TILE_R), dtype=torch.int32,
                      device=dev)
    return ((op, dp, v0.to(dev), e1.to(dev), e2.to(dev), mask, EPS["mt_eps"],
             EPS["self_hit_eps"]), (first, first + 1))


def check_ties(dev):
    """K1 where several triangle tiles hold a hit at exactly the same
    distance: the lowest slot wins, as in the plain version."""
    args, winners = tie_case(dev)
    got, ref = ck.nearest_hit(*args), ck.nearest_hit_plain(*args)
    torch.cuda.synchronize()
    require_sweep_equal("nearest_hit", got, ref, "ties across tiles")
    hit = torch.isfinite(got[0])
    n_hit = int(hit.sum())
    if not 0 < n_hit < hit.numel():
        raise AssertionError(f"ties: {n_hit} of {hit.numel()} rays hit; vacuous")
    won = got[1][hit]
    if not bool(((won == winners[0]) | (won == winners[1])).all()):
        raise AssertionError("ties: a winner outside the lowest coincident quad: "
                             f"{sorted(set(won.tolist()))}")
    say("kernels", f"nearest_hit (exact ties across 4 of {args[5].shape[0]} triangle "
        f"tiles): {n_hit} hits, all won by slots {winners}, equal to the plain version")


UNITS_PER_TILE = 4  # a kept pair tile is scanned as four 64-triangle units
PAIRS_PER_UNIT = PAIRS_PER_TILE // UNITS_PER_TILE


def check_any_hit(rays, pack, iters, what, plain_once=False):
    """K4 against its plain version and against `nearest_dist < inf`, and
    against itself on a second run: equal exactly. Some ray tile must hold
    occluded and unoccluded live rays together (the flag flip and the live
    count are per ray, within a tile). Also times K2 on the same inputs
    (`k2_ms`, `k2_device_ms`)."""
    op, dp, R = ck.pack_rays(*rays)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])
    got, walked = ck.any_hit_walked(*args)
    again = ck.any_hit(*args)
    ref, plain_ms = timed_once(lambda: ck.any_hit_plain(*args))
    via_dist = torch.isfinite(ck.nearest_dist(*args)) & ck.live_rays(op)
    torch.cuda.synchronize()
    for other, label in ((ref, "its plain version"), (via_dist, "nearest_dist < inf"),
                         (again, "its own second run")):
        n = int((got != other).sum())
        if n:
            raise AssertionError(f"any_hit ({what}): {n} rays differ from {label}")
    live = ck.live_rays(op)
    occ_t = (got & live).reshape(-1, ck.TILE_R).any(1)
    free_t = (~got & live).reshape(-1, ck.TILE_R).any(1)
    n_occ, n_free, n_mixed = int((got & live).sum()), int((~got & live).sum()), \
        int((occ_t & free_t).sum())
    if not n_mixed:
        raise AssertionError(f"any_hit ({what}): {n_occ} occluded and {n_free} "
                             "unoccluded live rays, in no ray tile together; "
                             "the check is vacuous")
    Rp, Tp = op.shape[1], pack.v0.shape[0]
    kept = mask.sum(0) * UNITS_PER_TILE
    if bool((walked > kept).any()) or bool((walked < 0).any()):
        raise AssertionError(f"any_hit ({what}): scanned {walked.tolist()} units "
                             f"of {kept.tolist()} kept")
    kept, n_walked = int(kept.sum()), int(walked.sum())
    bms, by = bound(n_walked * PAIRS_PER_UNIT * OPS_PER_PAIR, sweep_bytes(Rp, Tp, 1))
    res = dict(max_abs_err=0.0, ms=cuda_ms(lambda: ck.any_hit(*args), iters),
               device_ms=device_ms(lambda: ck.any_hit(*args)),
               plain_ms=plain_ms if plain_once
               else cuda_ms(lambda: ck.any_hit_plain(*args), 2),
               bound_ms=bms, bound_by=by, library_ms=None, library_device_ms=None,
               k2_ms=cuda_ms(lambda: ck.nearest_dist(*args), iters),
               k2_device_ms=device_ms(lambda: ck.nearest_dist(*args)))
    say("kernels", f"any_hit ({what}): {Rp} rays ({int(live.sum())} live) x {Tp} "
        f"triangles, scanned {n_walked} of {kept} kept units, {n_occ} occluded "
        f"/ {n_free} not, {n_mixed} ray tiles hold both: equal, and to its own "
        f"second run; wrapper {res['ms']:.4f} ms, device only "
        f"{res['device_ms']:.4f} ms (nearest_dist on the same rays "
        f"{res['k2_ms']:.4f} / {res['k2_device_ms']:.4f} ms), plain "
        f"{res['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by})")
    return res


def check_any_hit_early_exit(pack, dev, n_rays: int):
    """K4 on ray tiles that saturate: one chunk of rays straight down onto
    the sphere scene's ground, every pair tile kept. Every ray is occluded,
    the answer equals the plain version's, and units must have been dropped:
    fewer scanned than kept. (The chunk gives the queue several times more
    units than blocks fit on the card; a batch whose units are all drawn at
    once has nothing left to drop.)"""
    gen = torch.Generator().manual_seed(7)
    xz = torch.rand((n_rays, 2), generator=gen) * 2.0 - 1.0
    o = torch.stack([xz[:, 0], torch.full((n_rays,), 5.0), xz[:, 1]], 1).to(dev)
    d = torch.tensor([0.0, -1.0, 0.0], device=dev).expand(n_rays, 3)
    op, dp, _ = ck.pack_rays(o, d)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "none")
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])
    got, walked = ck.any_hit_walked(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, ck.any_hit_plain(*args)) or not bool(got.all()):
        raise AssertionError("any_hit (saturated tiles): wrong answer")
    kept = mask.sum(0) * UNITS_PER_TILE
    if bool((walked > kept).any()) or not bool((walked > 0).all()):
        raise AssertionError("any_hit (saturated tiles): scanned "
                             f"{walked.tolist()} of {kept.tolist()} units")
    n_walked, n_kept = int(walked.sum()), int(kept.sum())
    if not n_walked < n_kept:
        raise AssertionError("any_hit (saturated tiles): no early exit, scanned "
                             f"{n_walked} of {n_kept} units")
    say("kernels", f"any_hit (saturated tiles): all {got.numel()} rays occluded, "
        f"equal; scanned {n_walked} of {n_kept} units, {int((walked < kept).sum())} "
        f"of {kept.numel()} ray tiles dropped some (per ray tile {int(walked.min())}"
        f"-{int(walked.max())} of {int(kept.max())}); wrapper "
        f"{cuda_ms(lambda: ck.any_hit(*args), 10):.4f} ms, nearest_dist "
        f"{cuda_ms(lambda: ck.nearest_dist(*args), 10):.4f} ms")


MATMULS = {"nearest_hit_matmul": (ck.nearest_hit_matmul, ck.nearest_hit_matmul_plain),
           "nearest_dist_matmul": (ck.nearest_dist_matmul, ck.nearest_dist_matmul_plain)}


def check_matmul(name, rays, pack, iters, what, plain_once=False):
    """K5 or K6 against its plain version on one recentred ray batch:
    bit-equal distances and slots, also on a second run; K5's winners
    against K1's."""
    o, d = rays
    c = ck.live_centroid(o)
    op, dp, R = ck.pack_rays(o, d)
    oc = op - c[:, None]
    mask = ck.tile_cull_mask_hierarchical(
        oc, dp, pack._replace(tile_aabb=pack.tile_aabb - c), "octree")
    args = (oc, dp, pack.v0 - c, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])
    want_idx = name == "nearest_hit_matmul"
    kern, plain = MATMULS[name]
    ref, plain_ms = timed_once(lambda: plain(*args))
    got, again = kern(*args), kern(*args)
    torch.cuda.synchronize()
    note = ""
    if want_idx:
        (got, got_idx), (ref, ref_idx), (again, again_idx) = got, ref, again
        for other, label in ((ref_idx, "the plain version"),
                             (again_idx, "its own second run")):
            n_idx = int((got_idx != other).sum())
            if n_idx:
                raise AssertionError(f"{name} ({what}): {n_idx} winner slots "
                                     f"differ from {label}")
        m1 = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
        d1, i1 = ck.nearest_hit(op, dp, pack.v0, pack.e1, pack.e2, m1, **EPS)
        flips = int(((got_idx != i1) | (torch.isfinite(got) != torch.isfinite(d1)))[:R].sum())
        note = f"; {flips} of {R} winners differ from K1's"
        if flips > MAX_EDGE_FLIP_SHARE * R:
            raise AssertionError(f"{name}: {flips} of {R} winners differ from "
                                 f"K1's, more than {MAX_EDGE_FLIP_SHARE:.0e} of the rays")
    require_bit_equal(f"{name} ({what})", got, ref)
    require_bit_equal(f"{name} ({what}), second run against first", again, got)
    Rp, Tp, kept = oc.shape[1], pack.v0.shape[0], int(mask.sum())
    bms, by = bound(kept * PAIRS_PER_TILE * OPS_PER_PAIR_MATMUL,
                    sweep_bytes(Rp, Tp, 8 if want_idx else 4))
    res = dict(max_abs_err=max_err(got, ref), ms=cuda_ms(lambda: kern(*args), iters),
               device_ms=device_ms(lambda: kern(*args)),
               plain_ms=plain_ms if plain_once else cuda_ms(lambda: plain(*args), 2),
               bound_ms=bms, bound_by=by, library_ms=None, library_device_ms=None)
    say("kernels", f"{name} ({what}): {Rp} rays x {Tp} triangles, {kept}/"
        f"{mask.numel()} pair tiles kept, {int(torch.isfinite(ref).sum())} hits: "
        f"bit-equal, and to its own second run{note}; wrapper {res['ms']:.4f} ms, "
        f"device only {res['device_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"bound {bms:.5f} ms ({by})")
    return res


def check_fetch(pack, idx, iters):
    """K3 against table[idx]: rows must be equal exactly. The library call
    timed beside it is torch.index_select."""
    got = ck.fetch_rows(pack.table, idx)
    ref = ck.fetch_rows_plain(pack.table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("fetch_rows: rows differ from table[idx]")
    n, (Tp, C) = idx.shape[0], pack.table.shape
    long_idx = idx.long()
    bms, by = bound(0, min(Tp, n) * C * 4 + n * 4 + n * C * 4)

    def kern():
        return ck.fetch_rows(pack.table, idx)

    def library():
        return torch.index_select(pack.table, 0, long_idx)

    res = dict(max_abs_err=0.0, ms=cuda_ms(kern, iters), device_ms=device_ms(kern),
               plain_ms=cuda_ms(lambda: ck.fetch_rows_plain(pack.table, idx), iters),
               bound_ms=bms, bound_by=by, library_ms=cuda_ms(library, iters),
               library_device_ms=device_ms(library))
    say("kernels", f"fetch_rows: {n} rows (stride {idx.stride(0)}) of a {(Tp, C)} "
        f"table ({Tp * C * 4 / 2**20:.1f} MB): equal; wrapper {res['ms']:.4f} ms, "
        f"device only {res['device_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
        f"index_select {res['library_ms']:.4f} ms, device only "
        f"{res['library_device_ms']:.4f} ms, bound {bms:.5f} ms ({by})")
    return res


def check_fetch_edges(dev):
    """K3 on a 24-wide table, on slots outside the table (NaN rows) and on
    a row count that is no multiple of its block."""
    gen = torch.Generator().manual_seed(5)
    table = torch.rand((512, ck.TABLE_WIDTH_NOMAT), generator=gen).to(dev)
    idx = torch.randint(0, 512, (1001,), generator=gen, dtype=torch.int32).to(dev)
    idx[::97] = 512
    idx[5] = -1
    got = ck.fetch_rows(table, idx)
    torch.cuda.synchronize()
    bad = (idx < 0) | (idx >= 512)
    if not torch.equal(got[~bad], table[idx[~bad].long()]):
        raise AssertionError("fetch_rows (24 wide): rows differ from table[idx]")
    if not bool(torch.isnan(got[bad]).all()) or not bool(bad.any()):
        raise AssertionError("fetch_rows: a slot outside the table must give NaN")
    say("kernels", f"fetch_rows: 1001 rows of a (512, 24) table equal; "
        f"{int(bad.sum())} slots outside the table gave NaN rows")


def scene_pack(scene):
    g = scene.geometry
    return ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj,
                            scene.materials)


def winners(rays, pack):
    """K1's winner slots of a ray batch (its first R entries)."""
    op, dp, R = ck.pack_rays(*rays)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    return ck.nearest_hit(op, dp, pack.v0, pack.e1, pack.e2, mask, **EPS)[1][:R]


def shadows_of(scene, rays, pack):
    """The shadow rays the shading pass sends for a batch of primary rays."""
    hit = collide(*rays, scene.geometry, backend="cuda", pack=pack)
    so, sd, _ = shadow_rays(scene.lights, hit)
    return so, sd


def check_kernels(dev):
    """All six kernels against their plain versions on the card, at the
    shapes the renders give them. Returns {kernel: result dict} at the shapes
    of the path that claims the kernel: K1-K3 and K5/K6 on one 65,536-ray
    chunk of the sphere scene's CPU-mode primary rays and its 131,072 shadow
    rays, K4 on the shadow rays of one GPU-mode chunk. Every kernel is also
    held on 4,096 rays of the 96k-triangle grid (interval hierarchy, 12 MB
    table) and every sweep on one full chunk of it (`grid_4096` and
    `grid_chunk` in the result), K1 on exact ties and K3 on its edge cases."""
    chunk = RenderConfig().ray_chunk
    sph = make_sphere_scene(512, 512, **SPHERES).to(dev)
    sph_pack = scene_pack(sph)
    grid = make_sphere_grid_scene(512, 512).to(dev)
    grid_pack = scene_pack(grid)
    say("kernels", f"sphere scene {sph.n_triangles} triangles; grid "
        f"{grid.n_triangles} triangles ({grid_pack.table.numel() * 4 / 2**20:.1f} MB table)")
    results = {}
    prim = cpu_primary_rays(sph, chunk)
    shad = shadows_of(sph, prim, sph_pack)
    results["nearest_hit"] = check_sweep("nearest_hit", prim, sph_pack, 20,
                                         "spheres, CPU-mode primary chunk")
    results["fetch_rows"] = check_fetch(sph_pack, winners(prim, sph_pack), 50)
    results["nearest_dist"] = check_sweep("nearest_dist", shad, sph_pack, 20,
                                          "spheres, its shadow rays")
    results["nearest_hit_matmul"] = check_matmul(
        "nearest_hit_matmul", prim, sph_pack, 20, "spheres, CPU-mode primary chunk")
    results["nearest_dist_matmul"] = check_matmul(
        "nearest_dist_matmul", shad, sph_pack, 20, "spheres, its shadow rays")
    check_any_hit(shad, sph_pack, 20, "spheres, CPU-mode chunk's shadow rays")
    check_any_hit_early_exit(sph_pack, dev, chunk)

    sph_hi = make_sphere_scene(512 * ALIASING, 512 * ALIASING, **SPHERES).to(dev)
    gprim = gpu_primary_rays(sph_hi, chunk)
    check_sweep("nearest_hit", gprim, sph_pack, 20, "spheres, GPU-mode primary chunk")
    results["any_hit"] = check_any_hit(shadows_of(sph_hi, gprim, sph_pack), sph_pack,
                                       20, "spheres, GPU-mode chunk's shadow rays")

    check_ties(dev)
    check_fetch_edges(dev)
    few = cpu_primary_rays(grid, 4096)
    results["grid_4096"] = {
        "nearest_hit": check_sweep("nearest_hit", few, grid_pack, 10, "grid"),
        "nearest_dist": check_sweep("nearest_dist", few, grid_pack, 10, "grid"),
        "fetch_rows": check_fetch(grid_pack, winners(few, grid_pack), 50),
        "any_hit": check_any_hit(few, grid_pack, 10, "grid primary rays"),
        "nearest_hit_matmul": check_matmul("nearest_hit_matmul", few, grid_pack,
                                           10, "grid"),
        "nearest_dist_matmul": check_matmul("nearest_dist_matmul", few, grid_pack,
                                            10, "grid")}
    check_any_hit(shadows_of(grid, few, grid_pack), grid_pack, 10, "grid shadow rays")
    full = cpu_primary_rays(grid, chunk)
    what = "grid, one full chunk"
    results["grid_chunk"] = {
        name: check_sweep(name, full, grid_pack, 10, what, plain_once=True)
        for name in SWEEPS}
    results["grid_chunk"]["any_hit"] = check_any_hit(full, grid_pack, 10, what,
                                                     plain_once=True)
    for name in MATMULS:
        results["grid_chunk"][name] = check_matmul(name, full, grid_pack, 10, what,
                                                   plain_once=True)
    return results


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
    if float(img.max()) <= 0.0:
        raise AssertionError("image is black")


def counted_frame(renderer, what, need, none=()):
    """One frame with the launch counts set to 0 just before it and read
    just after; fails unless every kernel in `need` was launched and none in
    `none` was. Returns (image, counts)."""
    ck.reset_launch_counts()
    img = renderer.render_device()
    torch.cuda.synchronize()
    counts = dict(ck.LAUNCHES)
    say("render", f"{what}: launches in one frame {counts}")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{what}: the render never launched {name}")
    for name in none:
        if counts[name]:
            raise AssertionError(f"{what}: the render launched {name} "
                                 f"{counts[name]} times, expected none")
    check_image(img, renderer.width, renderer.height)
    return img, counts


def u8(img) -> np.ndarray:
    return torch.trunc(img).to(torch.int32).cpu().numpy()


def require_same_image(a, b, what):
    a, b = u8(a), u8(b)
    n_diff = int((a != b).any(-1).sum())
    if n_diff:
        raise AssertionError(f"{what}: {n_diff} pixels differ (max |d| "
                             f"{int(np.abs(a - b).max())})")
    say("render", f"{what}: uint8-equal")


# backend "torch" at its default `partitioning="octree"` culls (ray, object)
# pairs by a slab test that drops a hit lying exactly on its object's box,
# as the JAX package's does; the kernel backends cull tiles and keep it.
# Such hits lie on a box's edges, lines in the image: a frame may differ
# from the kernel frame on as many pixels as one row and one column hold
def require_nearly_same_image(a, b, what):
    """The two frames differ on at most height + width pixels."""
    a, b = u8(a), u8(b)
    n_diff, most = int((a != b).any(-1).sum()), a.shape[0] + a.shape[1]
    if n_diff > most:
        raise AssertionError(f"{what}: {n_diff} pixels differ, more than the {most} "
                             "that hits on an object's box edges may take")
    say("render", f"{what}: {n_diff} of {a.shape[0] * a.shape[1]} pixels differ "
        f"(hits exactly on an object's box; at most {most} may)")


def report_frames(what, renderer, times, n_primary, smi) -> float:
    """Print a path's frame times; returns their median."""
    ms = float(np.median(times))
    say("render", f"{what} ({renderer.scene.n_triangles} tris): frames "
        f"{[round(t, 3) for t in times]} ms, median {ms:.3f} ms/frame, "
        f"{n_primary / ms * 1e3 / 1e6:.3f} M primary rays/s; {smi}")
    return ms


OWN_KERNELS = ("fetch_rows_kernel", "sweep_list_kernel") + tuple(
    f"sweep_kernel<{kind}>" for kind in ("NEAREST_HIT", "NEAREST_DIST", "ANY_HIT",
                                         "MATMUL_HIT", "MATMUL_DIST"))


def own_kernel(name: str):
    """The port's kernel a profiled device kernel is, or None. A sweep's
    demangled name ends in its kind's number: sweep_kernel<2> or <(int)2>."""
    if "sweep_kernel<" in name:
        digits = [c for c in name.split("sweep_kernel<")[1].split(">")[0] if c.isdigit()]
        return OWN_KERNELS[2 + int(digits[-1])] if digits else None
    return next((t for t in OWN_KERNELS[:2] if t in name), None)


def profile_call(fn, what) -> int:
    """Trace one warm call (a frame, a training step): kernel launches
    (returned), the device's busy share (union of kernel intervals over the
    call's host wall time) and the time in the port's own kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    own = {}
    for k in kernels:
        tag = own_kernel(k.name)
        if tag is not None:
            n, us = own.get(tag, (0, 0.0))
            own[tag] = (n + 1, us + k.time_range.elapsed_us())
    say("profile", f"{what}: profiled call {wall_ms:.1f} ms, {len(kernels)} "
        f"device kernels and copies, device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 10 / wall_ms:.1f}% of it; own kernels "
        + ", ".join(f"{t} {us / 1e3:.2f} ms in {n}" for t, (n, us) in sorted(own.items())))
    return len(kernels)


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of `fn` over n unsynchronised calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def profile_fetch_wrapper(dev):
    """K3's wrapper's host time per call beside the library call's, at 4,096
    and at 65,536 rows of a (96000, 32) table, and where it goes."""
    gen = torch.Generator().manual_seed(3)
    table = ck.check_winner_table(
        torch.rand((96000, ck.TABLE_WIDTH_MAT), generator=gen).to(dev))
    launch = ck._kernels()["fetch_rows"]
    for n in (4096, 65536):
        idx = torch.randint(0, 96000, (n,), generator=gen, dtype=torch.int32).to(dev)
        long_idx, out = idx.long(), torch.empty((n, ck.TABLE_WIDTH_MAT), device=dev)
        args = (table.data_ptr(), 96000, ck.TABLE_WIDTH_MAT, idx.data_ptr(), 1, n,
                out.data_ptr(), ck._stream(dev))
        parts = {"fetch_rows wrapper": lambda: ck.fetch_rows(table, idx),
                 "the same launch through FetchRows.apply":
                     lambda: ck.FetchRows.apply(table, idx),
                 "index_select": lambda: torch.index_select(table, 0, long_idx),
                 "torch.empty of the result": lambda: torch.empty_like(out),
                 "stream handle": lambda: ck._stream(dev),
                 "bare ctypes launch": lambda: launch(*args),
                 "out.add_(1.0)": lambda: out.add_(1.0)}
        us = {k: host_us(fn) for k, fn in parts.items()}
        say("profile", f"host microseconds per call, {n} rows of a (96000, 32) "
            "table: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
        saved = us["the same launch through FetchRows.apply"] - us["fetch_rows wrapper"]
        say("profile", "building no autograd node where the table needs no gradient "
            f"saves {saved:.2f} us a call, {saved * 58 / 1e3:.3f} ms of host time "
            "over the 58 fetches of a sphere frame")


# ---------------------------------------------------------------------------
# Training: K3's gradient, the card against the plain path, the train step
# ---------------------------------------------------------------------------

# gradients are sums of float32 products that the card and the CPU add in
# another order (and the card's scatter-add in another order every run):
# each group is held to rtol 1e-3 and atol 1e-4 of its largest entry
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-4


def check_fetch_gradient(pack, idx, what):
    """`FetchRows` forward and backward on the card against autograd of the
    plain `table[idx]`: rows bit-equal, table gradient within rtol 1e-5 and
    an atol set by the most-fetched slot (rows fetched more than once are
    summed in another order), exactly zero on slots nobody fetched. Times the
    backward alone (`FetchRows.backward`: zero table + `index_add_`)."""
    n, (Tp, C) = idx.shape[0], pack.table.shape
    gen = torch.Generator().manual_seed(13)
    g = torch.randn((n, C), generator=gen).to(idx.device)
    g[::7] = 0.0  # the rows of missed rays arrive masked
    table = ck.check_winner_table(pack.table.detach().clone()).requires_grad_()
    ref_table = pack.table.detach().clone().requires_grad_()
    before = ck.LAUNCHES["fetch_rows"]
    rows = ck.fetch_rows(table, idx)
    if ck.LAUNCHES["fetch_rows"] != before + 1 or rows.grad_fn is None:
        raise AssertionError("fetch_rows on the card: no launch or no grad_fn")
    ref = ck.fetch_rows_plain(ref_table, idx)
    if not torch.equal(rows, ref):
        raise AssertionError(f"fetch gradient ({what}): forward rows differ")
    rows.backward(g)
    ref.backward(g)
    torch.cuda.synchronize()
    scale = float(ref_table.grad.abs().max())
    err = float((table.grad - ref_table.grad).abs().max())
    counts = torch.bincount(idx.long(), minlength=Tp)
    # a slot's gradient is a float32 sum of `count` N(0,1) entries, taken in
    # two orders: they differ by about count x 2^-23; four times that is allowed
    atol = 4.0 * 2.0 ** -23 * float(counts.max())
    if not torch.allclose(table.grad, ref_table.grad, rtol=1e-5, atol=atol):
        raise AssertionError(f"fetch gradient ({what}): max |d| {err:.3e} over "
                             f"atol {atol:.3e} (largest entry {scale:.3e})")
    used = counts > 0
    if bool(table.grad[~used].any()) or not bool((~used).any()):
        raise AssertionError(f"fetch gradient ({what}): unreferenced slots not zero")
    ctx = types.SimpleNamespace(saved_tensors=(idx,), table_shape=(Tp, C))
    long_idx = idx.long()

    def backward():
        return ck.FetchRows.backward(ctx, g)

    def plain_backward():  # what autograd runs for table[idx]
        return torch.zeros((Tp, C), device=g.device).index_put_(
            (long_idx,), g, accumulate=True)

    bms, by = bound(0, n * C * 4 + n * 4 + Tp * C * 4)
    res = dict(ms=cuda_ms(backward, 50), device_ms=device_ms(backward),
               plain_ms=cuda_ms(plain_backward, 5), bound_ms=bms, max_abs_err=err)
    say("train", f"fetch gradient ({what}): {n} rows (stride {idx.stride(0)}, "
        f"{int(used.sum())} distinct, {int(counts.max())} into one slot) of a {(Tp, C)} "
        f"table: forward bit-equal, gradient max |d| {err:.3e} (atol {atol:.3e}, "
        f"largest entry {scale:.3e}), unreferenced slots exactly 0; "
        f"backward (zero table + index_add_) wrapper {res['ms']:.4f} ms, device only "
        f"{res['device_ms']:.4f} ms, index_put_(accumulate) {res['plain_ms']:.4f} ms, "
        f"bound {bms:.5f} ms ({by})")
    return res


def render_gradients(scene, cfg, device):
    """{group: gradient of mean(render_image)} on `device`, as CPU tensors.
    The parameters are leaves on the CPU, as `make_sphere_scene` gives them:
    `render_image` moves the scene, and the gradient comes back through
    that copy."""
    p = {k: v.detach().clone().requires_grad_() for k, v in extract_params(scene).items()}
    render_image(insert_params(scene, p), cfg, device=device).mean().backward()
    return {k: v.grad for k, v in p.items()}


def check_gradient_against_plain(dev):
    """The gradient on the card (kernels) against the same backend on CPU
    tensors (plain versions), 32x32 sphere scene, all 13 groups for backend
    "cuda" and three for "cuda_matmul"; on the card twice. Geometry, normals,
    materials and the camera must get a gradient that is not all zero: a
    fetch without `grad_fn` or a camera basis computed off the graph would
    leave exact zeros there. The plain sweeps on the CPU compute all pairs,
    seconds per bounce: the depth is cut to 3 and 2 bounces (every group's
    gradient is there from the second bounce on)."""
    scene = make_sphere_scene(32, 32, **SPHERES)
    for backend, depth, groups, nonzero in (
            ("cuda", 3, PARAM_KEYS, ("vertices", "normals", "kd", "cam_fov")),
            ("cuda_matmul", 2, ("vertices", "kd", "lights_rgb"),
             ("vertices", "kd", "lights_rgb"))):
        cfg = RenderConfig(quantize="smooth", backend=backend, diff_max_depth=depth)
        ck.reset_launch_counts()
        got = render_gradients(scene, cfg, dev)
        counts = dict(ck.LAUNCHES)
        again = render_gradients(scene, cfg, dev)
        ref = render_gradients(scene, cfg, "cpu")
        worst, rerun = 0.0, 0.0
        for k in groups:
            scale = float(ref[k].abs().max())
            if not bool(torch.isfinite(got[k]).all()):
                raise AssertionError(f"gradient of {k} ({backend}) is not finite")
            if k in nonzero and not bool(got[k].any()):
                raise AssertionError(f"gradient of {k} ({backend}) is all zero on the card")
            if not torch.allclose(got[k], ref[k], rtol=GRAD_RTOL,
                                  atol=GRAD_ATOL_SHARE * scale):
                raise AssertionError(
                    f"gradient of {k} ({backend}): card against plain path max |d| "
                    f"{float((got[k] - ref[k]).abs().max()):.3e} of {scale:.3e}")
            worst = max(worst, float((got[k] - ref[k]).abs().max()) / scale)
            rerun = max(rerun, float((got[k] - again[k]).abs().max()) / scale)
        say("train", f"gradient of mean(render_image), spheres 32x32, depth {depth}, {backend}: "
            f"{len(groups)} groups on the card within rtol {GRAD_RTOL} / atol "
            f"{GRAD_ATOL_SHARE} of the largest entry of the plain path's; largest "
            f"|d| {worst:.3e} of a group's largest entry; {', '.join(nonzero)} not "
            f"all zero; second run on the card differs by at most {rerun:.3e}; "
            f"launches of one forward+backward {counts}")


TRAIN = dict(size=256, ray_chunk=65536, depth=6, steps=20, lr=1e-2)


def perturbed_params(scene, seed=20261016):
    """The scene's parameters with `kd` of the real objects and `lights_rgb`
    moved off their true values."""
    rng = np.random.default_rng(seed)
    params = {k: v.clone() for k, v in extract_params(scene).items()}
    kd = params["kd"].numpy()
    noise = rng.uniform(-0.3, 0.3, kd.shape).astype(np.float32)
    noise[scene.n_objects:] = 0.0
    params["kd"] = torch.from_numpy(np.clip(kd + noise, 0.05, 1.0))
    rgb = params["lights_rgb"].numpy()
    params["lights_rgb"] = torch.from_numpy(np.clip(
        rgb + rng.uniform(-0.2, 0.2, rgb.shape).astype(np.float32), 0.05, 1.5))
    return params


def timed_steps(step_fn, state, scene, coords, target, n):
    """n synchronised steps: (state, losses, ms per step, launches per step,
    peak bytes allocated)."""
    losses, times, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        state, loss = step_fn(state, scene, coords, target)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(dict(ck.LAUNCHES))
        losses.append(float(loss))
    return state, losses, times, counts, torch.cuda.max_memory_allocated()


def check_training(dev, smi, want_profile):
    """The training path at full width; returns the launches of one step
    with `remat=True`."""
    size = TRAIN["size"]
    scene = make_sphere_scene(size, size, **SPHERES)
    scene_d = scene.to(dev)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda",
                       ray_chunk=TRAIN["ray_chunk"], diff_max_depth=TRAIN["depth"],
                       remat=True)
    n_rays = size * size * 4
    coords = camera_ops.cpu_subpixel_coords_traced(
        size, size, torch.arange(n_rays, device=dev))
    with torch.no_grad():
        target = predict_pixels(scene, cfg, TRAIN["depth"], coords, device=dev)
    if tuple(target.shape) != (size * size, 3) or not bool(torch.isfinite(target).all()):
        raise AssertionError("training target has the wrong shape or is not finite")
    start = perturbed_params(scene)
    true_kd = scene.materials.kd[:scene.n_objects]

    def kd_error(state):
        return float((state.params["kd"][:scene.n_objects].detach().cpu()
                      - true_kd).abs().mean())

    def free(*names):
        return lambda p: torch.optim.Adam([p[k] for k in names], lr=TRAIN["lr"])

    init_state, step_fn = make_train_step(cfg, scene, optimizer=free("kd", "lights_rgb"),
                                          device=dev)
    state = init_state(start)
    kd0 = kd_error(state)
    state, losses, times, counts, peak = timed_steps(
        step_fn, state, scene_d, coords, target, TRAIN["steps"])
    kd1 = kd_error(state)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training: a loss is not finite: {losses}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"training: loss {losses[0]:.3e} -> {losses[-1]:.3e}, "
                             "not under half its first value")
    if not kd1 < kd0:
        raise AssertionError(f"training: kd error {kd0:.4f} -> {kd1:.4f} did not fall")
    per_step = counts[-1]
    for name in ("nearest_hit", "nearest_dist", "fetch_rows"):
        if per_step[name] <= 0:
            raise AssertionError(f"training: a step never launched {name}")
    if any(c != per_step for c in counts[1:]):
        say("train", f"launches per step varied: {counts}")
    ms = float(np.median(times[1:]))
    say("train", f"spheres {size}x{size} ({scene.n_triangles} tris, {n_rays} rays in "
        f"{n_rays // TRAIN['ray_chunk']} chunks, depth {TRAIN['depth']}), cuda, "
        f"remat=True, Adam lr {TRAIN['lr']} on kd + lights_rgb: loss "
        f"{losses[0]:.4e} -> {losses[-1]:.4e} in {len(losses)} steps "
        f"(x{losses[-1] / losses[0]:.4f}), kd error {kd0:.4f} -> {kd1:.4f}; steps "
        f"{[round(t, 1) for t in times]} ms, median of the warm ones {ms:.1f} ms/step; "
        f"launches per step {per_step}; peak memory {peak / 2**20:.1f} MiB; {smi}")
    say("train", "losses " + " ".join(f"{x:.4e}" for x in losses))

    # the same steps without checkpointing: what remat saves and costs
    plain_cfg = dataclasses.replace(cfg, remat=False)
    init_plain, step_plain = make_train_step(
        plain_cfg, scene, optimizer=free("kd", "lights_rgb"), device=dev)
    _, losses_p, times_p, counts_p, peak_p = timed_steps(
        step_plain, init_plain(start), scene_d, coords, target, 3)
    times_r, counts_r, peak_r = times[:3], counts[:3], peak
    for name in ("nearest_hit", "nearest_dist"):
        if counts_p[-1][name] != counts_r[-1][name]:
            raise AssertionError(f"remat launched {name} {counts_r[-1][name]} times a "
                                 f"step, {counts_p[-1][name]} without it: a sweep ran "
                                 "again in the backward pass")
    if not np.allclose(losses_p, losses[:3], rtol=1e-3):
        raise AssertionError(f"remat=False losses {losses_p} differ from {losses[:3]}")
    say("train", f"remat=False, 3 steps: {[round(t, 1) for t in times_p]} ms, peak "
        f"{peak_p / 2**20:.1f} MiB, launches per step {counts_p[-1]}; the first 3 "
        f"steps with remat=True: {[round(t, 1) for t in times_r]} ms, peak {peak_r / 2**20:.1f} "
        f"MiB, launches per step {counts_r[-1]}; last-step ratio remat/plain "
        f"{times_r[-1] / times_p[-1]:.3f}, memory {peak_r / peak_p:.3f}")

    # vertices free too
    init_v, step_v = make_train_step(
        cfg, scene, optimizer=free("kd", "lights_rgb", "vertices"), device=dev)
    state_v = init_v(start)
    state_v, loss_v, times_v, _, _ = timed_steps(step_v, state_v, scene_d, coords,
                                                 target, 1)
    moved = float((state_v.params["vertices"].detach().cpu()
                   - scene.geometry.vertices).abs().sum())
    if not np.isfinite(loss_v[0]) or not moved > 0.0:
        raise AssertionError(f"training with free vertices: loss {loss_v[0]}, "
                             f"vertices moved by {moved}")
    say("train", f"one step with the vertices free too: loss {loss_v[0]:.4e}, "
        f"vertices moved by {moved:.3f} in all, {times_v[0]:.1f} ms")

    # save / resume round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = save_train_state(tmp, state)
        restored, resumed = resume_or_init(tmp, init_state(start))
    same = resumed and restored.step == state.step and all(
        torch.equal(restored.params[k], state.params[k]) for k in PARAM_KEYS)
    a, b = state.opt_state.state_dict()["state"], restored.opt_state.state_dict()["state"]
    same = same and all(torch.equal(v, b[i][name]) for i, slot in a.items()
                        for name, v in slot.items())
    if not same or not all(p.is_cuda for p in restored.params.values()):
        raise AssertionError("the train state did not come back bit-equal on the card")
    say("train", f"save / resume_or_init round trip at step {state.step} "
        f"({path.rsplit('/', 1)[-1]}): parameters and Adam moments bit-equal, on the card")

    if want_profile:
        for what, fn, st in (("remat=True", step_fn, init_state(start)),
                             ("remat=False", step_plain, init_plain(start))):
            fn(st, scene_d, coords, target)
            profile_call(lambda: fn(st, scene_d, coords, target),
                         f"training step, spheres {size}x{size}, {what}")
    return per_step


def run_training_phases(dev, smi, want_profile, results):
    """K3's gradient at the two table sizes, the card against the plain
    path, then the training run; returns the launches of one training step."""
    chunk = RenderConfig().ray_chunk
    sph = make_sphere_scene(512, 512, **SPHERES).to(dev)
    sph_pack = scene_pack(sph)
    results["fetch_rows"]["backward"] = check_fetch_gradient(
        sph_pack, winners(cpu_primary_rays(sph, chunk), sph_pack), "spheres")
    grid = make_sphere_grid_scene(512, 512).to(dev)
    grid_pack = scene_pack(grid)
    results["grid_4096"]["fetch_rows"]["backward"] = check_fetch_gradient(
        grid_pack, winners(cpu_primary_rays(grid, 4096), grid_pack), "grid")
    del grid, grid_pack
    check_gradient_against_plain(dev)
    return check_training(dev, smi, want_profile)


def main(argv) -> int:
    want_profile = "--profile" in argv
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
        if "registers" in line or "bytes smem" in line or "Compiling entry" in line:
            say("build", line.strip())

    results = check_kernels(dev)
    if want_profile:
        profile_fetch_wrapper(dev)
    launches = {}
    launches["training"] = run_training_phases(dev, smi, want_profile, results)
    cfg = RenderConfig(backend="cuda")
    spheres512 = make_sphere_scene(512, 512, **SPHERES)
    cpu_rays = 512 * 512 * 4

    # ---- CPU mode, backend "cuda": the sphere scene at 512x512
    renderer = SceneRenderer(spheres512, cfg, dev)
    cuda_img, launches["cpu_mode"] = counted_frame(
        renderer, "CPU mode, spheres 512x512, cuda",
        ("nearest_hit", "nearest_dist", "fetch_rows"))
    _, times = time_frames(renderer, 2)
    report_frames(f"CPU mode, spheres 512x512, cuda (depth {renderer.depth})",
                  renderer, times, cpu_rays, smi)
    traced = {}
    if want_profile:
        traced["cuda"] = profile_call(renderer.render_device,
                                      "CPU mode, spheres 512x512, cuda")

    # the exact reference is brute force; the "torch" backend's default
    # configuration (object-level cull) is held to the same frame up to the
    # hits on an object's box (the ground quad's edge is in view at this size)
    small = make_sphere_scene(128, 128, **SPHERES)
    small_img = SceneRenderer(small, cfg, dev).render_device()
    require_same_image(
        small_img,
        SceneRenderer(small, RenderConfig(backend="torch", partitioning="none"),
                      dev).render_device(),
        "CPU mode, spheres 128x128, cuda against the torch backend, no cull")
    small = make_sphere_scene(64, 64, **SPHERES)
    require_nearly_same_image(
        SceneRenderer(small, cfg, dev).render_device(),
        SceneRenderer(small, RenderConfig(backend="torch"), dev).render_device(),
        "CPU mode, spheres 64x64, cuda against the torch backend, octree cull")

    # ---- the 96k-triangle grid: interval hierarchy, large-table fetch, and
    # the front-to-back sweep (375 triangle tiles > 2 * 8)
    grid512 = make_sphere_grid_scene(512, 512)
    grenderer = SceneRenderer(grid512, cfg, dev)
    grid_img, grid_counts = counted_frame(
        grenderer, "CPU mode, grid 512x512, cuda",
        ("nearest_hit", "nearest_dist", "fetch_rows"))
    _, times = time_frames(grenderer, 2)
    report_frames("CPU mode, grid 512x512, cuda", grenderer, times, cpu_rays, smi)
    f2b = SceneRenderer(grid512, RenderConfig(backend="cuda", f2b_tiles=8), dev)
    f2b_img, launches["front_to_back"] = counted_frame(
        f2b, "CPU mode, grid 512x512, cuda, f2b_tiles=8",
        ("nearest_hit", "nearest_dist", "fetch_rows"))
    if launches["front_to_back"]["nearest_hit"] != 2 * grid_counts["nearest_hit"]:
        raise AssertionError("front-to-back did not double the nearest_hit launches: "
                             f"{launches['front_to_back']} against {grid_counts}")
    if not torch.equal(f2b_img, grid_img):
        raise AssertionError("the front-to-back frame differs from the plain sweep's")
    say("render", "grid 512x512: front-to-back frame equal to the plain sweep's, "
        "nearest_hit launches doubled")
    _, times = time_frames(f2b, 2)
    report_frames("CPU mode, grid 512x512, cuda, f2b_tiles=8", f2b, times, cpu_rays, smi)

    # ---- GPU mode: 512x512 output at aliasing 3, shadows through the
    # any-hit sweep, held against the same frame through the distance sweep
    gpu_rays = 512 * 512 * ALIASING ** 2
    gcfg = RenderConfig(mode="gpu", backend="cuda", aliasing=ALIASING, max_bounce=10)
    any_cfg = RenderConfig(mode="gpu", backend="cuda", aliasing=ALIASING,
                           max_bounce=10, any_hit_min_tris=0)
    any_renderer = SceneRenderer(spheres512, any_cfg, dev)
    any_img, launches["gpu_mode"] = counted_frame(
        any_renderer, f"GPU mode, spheres 512x512 x{ALIASING}, cuda, any-hit",
        ("nearest_hit", "fetch_rows", "any_hit"), none=("nearest_dist",))
    dist_renderer = SceneRenderer(spheres512, gcfg, dev)
    dist_img, _ = counted_frame(
        dist_renderer, f"GPU mode, spheres 512x512 x{ALIASING}, cuda, distance sweep",
        ("nearest_hit", "fetch_rows", "nearest_dist"), none=("any_hit",))
    require_same_image(any_img, dist_img,
                       "GPU mode: any-hit frame against the distance-sweep frame")
    # two versions in one call, in turns
    _, t_any = time_frames(any_renderer, 1)
    _, t_dist = time_frames(dist_renderer, 2)
    _, t_any2 = time_frames(any_renderer, 1)
    report_frames(f"GPU mode, spheres 512x512 x{ALIASING}, cuda, any-hit",
                  any_renderer, t_any + t_any2, gpu_rays, smi)
    report_frames(f"GPU mode, spheres 512x512 x{ALIASING}, cuda, distance sweep",
                  dist_renderer, t_dist, gpu_rays, smi)
    if want_profile:
        traced["GPU mode, any-hit"] = profile_call(
            any_renderer.render_device,
            f"GPU mode, spheres 512x512 x{ALIASING}, any-hit")

    small = make_sphere_scene(64, 64, **SPHERES)
    small_img = SceneRenderer(small, any_cfg, dev).render_device()
    require_same_image(
        small_img,
        SceneRenderer(small, RenderConfig(mode="gpu", backend="torch",
                                          partitioning="none",
                                          aliasing=ALIASING), dev).render_device(),
        f"GPU mode, spheres 64x64 x{ALIASING}, cuda against the torch backend, no cull")
    require_nearly_same_image(
        small_img,
        SceneRenderer(small, RenderConfig(mode="gpu", backend="torch",
                                          aliasing=ALIASING), dev).render_device(),
        f"GPU mode, spheres 64x64 x{ALIASING}, cuda against the torch backend, "
        "octree cull")

    # ---- backend "cuda_matmul": the sphere scene at 512x512 in CPU mode
    mm = SceneRenderer(spheres512, RenderConfig(backend="cuda_matmul"), dev)
    mm_img, launches["matmul"] = counted_frame(
        mm, "CPU mode, spheres 512x512, cuda_matmul",
        ("nearest_hit_matmul", "nearest_dist_matmul", "fetch_rows"),
        none=("nearest_hit", "nearest_dist", "any_hit"))
    d = assert_images_close(u8(mm_img), u8(cuda_img), tol=1,
                            context="cuda_matmul against cuda, spheres 512x512")
    say("render", f"cuda_matmul against cuda, spheres 512x512: {d}")
    # two versions in one call, in turns: cuda_matmul, cuda, cuda_matmul
    _, times = time_frames(mm, 1)
    _, again = time_frames(renderer, 2)
    times += time_frames(mm, 1)[1]
    mm_frame_ms = report_frames("CPU mode, spheres 512x512, cuda_matmul", mm, times,
                                cpu_rays, smi)
    cuda_again_ms = report_frames("CPU mode, spheres 512x512, cuda, again", renderer,
                                  again, cpu_rays, smi)
    say("render", "cuda_matmul frame / cuda frame beside it: "
        f"{mm_frame_ms / cuda_again_ms:.3f}")
    if want_profile:
        traced["cuda_matmul"] = profile_call(mm.render_device,
                                             "CPU mode, spheres 512x512, cuda_matmul")
        say("profile", "device kernels and copies per frame, spheres 512x512: "
            + ", ".join(f"{k} {n}" for k, n in traced.items())
            + f"; cuda_matmul - cuda = {traced['cuda_matmul'] - traced['cuda']}")

    path_of = {"nearest_hit": "cpu_mode", "nearest_dist": "cpu_mode",
               "fetch_rows": "cpu_mode", "any_hit": "gpu_mode",
               "nearest_hit_matmul": "matmul", "nearest_dist_matmul": "matmul"}
    kernels = []
    for name, p in path_of.items():
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "launches": launches[p][name]}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "library_device_ms")
        entry.update({k: results[name][k] for k in keys})
        other = {shape: {k: results[shape][name][k] for k in keys}
                 for shape in ("grid_4096", "grid_chunk") if name in results[shape]}
        if other:
            entry["other_shapes"] = other
        entry["path"] = p
        entry["launches_by_path"] = {q: c[name] for q, c in launches.items()}
        if name == "fetch_rows":
            entry["also_replaces"] = f"{PALLAS}:568"
            entry["backward"] = dict(
                results[name]["backward"], replaces=f"{PALLAS}:582",
                note="index_add_ inside FetchRows.backward; the JAX package's "
                     "adjoint is a plain scatter-add outside any Pallas kernel",
                grid_4096=results["grid_4096"][name]["backward"])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
