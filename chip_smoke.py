#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels from raytracing_gpu_tpu_torch/csrc with nvcc
(one `nvcc -c` per source, side by side, then one link), checks each of the six intersection
kernels, the tile cull (`tile_cull_kernel`, on the benchmark's `spheres`
configuration's nearest-hit chunk and its 5-light shadow batch) and the
hierarchical tile cull (`tile_cull_levels_kernel`, on the benchmark's
`sphereflake` configuration's nearest-hit chunk and its 3-light shadow batch,
and on a chunk of the grid) against its
plain PyTorch version on the card at the shapes the renders give it, and
the frame graph's three condition kernels
(`csrc/frame_loop.cu`: `loop_reset`, `bounce_condition`, `chunk_advance`)
against their twins (`[loop]`: standalone frame graphs driven by seeded
tables of alive flags against the interpreter over the same tensors, the
sync counter against an `.item()`, and the cost of one WHILE iteration of
each loop from loops of 1,001 against 1), and drives every
ported path through `SceneRenderer`. On the card `SceneRenderer` captures
its frame's pieces once and assembles them into one CUDA graph whose chunk
and bounce loops run on the device (`utils/frame_graph.py`); each of the
five render cells below (spheres CPU mode, grid, grid with `f2b_tiles=8`,
GPU mode with any-hit, `cuda_matmul`) holds its graph frame against the
eager frame of the same config (`unroll="static"`, which stays eager): one
graph launch and no host sync per frame (both counted), bit-equal images,
equal launches per kernel and bounce steps per chunk, the condition
kernels launched once per chunk and per step (as they counted themselves
on the card), two launches bit-equal, both timed in turns, the
frame graph alone on the device, the capture's cost and each piece's node
types, and a block the allocator cached before the capture still reserved
after it:

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
  autograd of the plain `table[idx]`, and K1, K2, K3 and its gradient on a
  chunk of rays that are all parked (what a captured step's dead bounce
  steps run); the gradient of `mean(render_image)` on
  the card against the same backend on CPU tensors (the kernels' plain
  versions) for all 13 parameter groups at 16x16 and 2 bounces, twice on the
  card (through `render_image`'s plan: the first call captures, the second
  replays); `ops.camera.tanf` on the card bit-equal to the host's libm `tanf`;
  capturable Adam in a captured step against optax's update arithmetic and
  a captured `loss_blur` step against the eager one (32x32); 20
  Adam steps on the sphere scene at 256x256 (262,144 rays in 4 chunks, depth
  6, `remat=True`; K1, K2, K3 and K3's gradient) recovering perturbed `kd`
  and `lights_rgb` from a target rendered at the true parameters, through
  the captured step (`utils/step_graph.py`: the first step eager, then one
  CUDA graph replayed per step), its first 3 steps in turns with the eager
  step (`plan=False`): step-1 loss bit-equal, losses, parameters and Adam
  moments after 3 steps within rtol 1e-3 / atol 1e-4 of a group's largest
  entry, K1 launched once per chunk and bounce step (the eager loop stops a
  chunk early); 3 captured steps with `remat=False`, 2 with the vertices
  and the field of view free too, and a save / resume round trip of the
  train state (at 32x32 a restored state's next step captures again);
- `render_image` through its plan (`[image]`, `utils/image_graph.py`): the
  256x256 sphere scene with all 13 groups requiring grad, mean(image)
  backward, three captured calls (the first the capture, then replays of a
  forward and a backward graph) in turns with three eager calls
  (`plan=False`), new parameters each turn: images bit-equal, gradients
  within rtol 1e-3 / atol 1e-4 of a group's largest entry, two graph
  replays and no host sync (counted) per replayed call, K1 and K2 once per
  chunk and bounce step and K3 twice; two views of that scene (the camera
  moved and turned) through the one plan, `(a.mean() + b.mean()).backward()`
  in turns with the eager twin: a second slot captured, images bit-equal,
  gradients within the tolerance, four graph replays and no host sync per
  replayed call; the two backward passes in reverse order; a 3-step loop
  that captures nothing new; on the 16x16 plan of the gradient check
  `MAX_SLOTS + 1` outstanding images, the last rendered eagerly and
  counted; GPU mode at 64x64 x2 captured against eager; and without
  grad the 512x512 CPU-mode frame (match: the frame program after its
  inputs graph) bit-equal to `SceneRenderer`'s with equal steps per chunk,
  timed beside it in turns, and with the camera and vertices moved equal to
  a fresh `SceneRenderer` of the moved scene;
- the file entry (`[entry]`): the CPU-mode sphere scene written as `.svati`
  text, parsed by the native parser (built with native="force") and by the
  Python parser, both equal to the scene leaf for leaf; `render(path,
  out.ppm)` byte-equal to `ppm_bytes` of SceneRenderer's frame, launching
  what that frame and its capture's warm-up launched; the native PPM and PNG writers byte-identical to
  the Python writers; the command line in-process with `--unroll static
  --profile DIR --time`, whose trace must hold the port's kernels; and
  `utils.inspect` with `--octree --memory`. Parse, set-up, call and writer
  times are printed;
- sharding (`parallel/`): world size 1 through `render_scene_sharded` and
  `make_sharded_renderer` on the CPU-mode sphere frame at 512x512, bit-equal
  to `SceneRenderer`'s frame and timed beside it in turns (the sharded
  plumbing's own cost on one card: row-major rays, a pack per call); one
  step of the 256x256 training cell through a (1,1) mesh against the
  one-device step; and two gloo ranks started by this script
  (`--shard-rank`), sharing the one card, rendering the 128x128 frame over
  meshes (2,1) and (1,2), each uint8-equal to the single-process frame. NCCL
  refuses two ranks on one device, so nothing across cards is shown, and
  nothing of the two ranks is timed.

Before each of these paths the launch counts are set to 0 and read just
after its frame; a graph frame counts each replay's launches. Any failure raises and the script exits non-zero; it also
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
`plain_ms` of a sweep is its plain version's one reference run, timed by
CUDA events. The timing helpers are `utils.profiling`'s.
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
`--profile` also traces one warm (graph) frame of each path and one
captured and one eager training step with
torch.profiler and prints kernel launches (the three paths' side by side at
the end) and the device's busy share, and K3's wrapper's host time by its parts at 4,096 and
65,536 rows. A trace must name the port's kernels as often as the launch
counters counted them in the traced call; kernels in a frame graph's WHILE
bodies it names wrongly in some cells (PERF.md section 7), and there the
disagreement is printed instead. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()  # before the imports: their time is reported

import contextlib
import dataclasses
import datetime
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

from raytracing_gpu_tpu_torch import (
    RenderConfig,
    SceneRenderer,
    parse_scene,
    parse_scene_text,
    render,
    render_image,
)
from raytracing_gpu_tpu_torch.__main__ import main as cli_main
from raytracing_gpu_tpu_torch.csrc import build
from raytracing_gpu_tpu_torch.models.procedural import (
    make_sphere_grid_scene,
    make_sphere_scene,
)
from raytracing_gpu_tpu_torch.native import build as native_build
from raytracing_gpu_tpu_torch.native import svati as native_lib
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.intersect import collide
from raytracing_gpu_tpu_torch.ops.shading import PARKED, shadow_rays
from raytracing_gpu_tpu_torch.parallel import (
    extract_params,
    insert_params,
    make_mesh,
    make_sharded_renderer,
    make_train_step,
    multihost,
    predict_pixels,
    render_scene_sharded,
)
from raytracing_gpu_tpu_torch.parallel.checkpoint import (
    resume_or_init,
    save_train_state,
)
from raytracing_gpu_tpu_torch.parallel.render import frame_inputs, split_scene
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS
from raytracing_gpu_tpu_torch.render import _pick_block, _swiz_ray_ids, frame_depth
from raytracing_gpu_tpu_torch.utils import capture, frame_graph, image_graph, profiling
from raytracing_gpu_tpu_torch.utils.compare import assert_images_close
from raytracing_gpu_tpu_torch.utils.image import ppm_bytes, write_png, write_ppm
from raytracing_gpu_tpu_torch.utils.inspect import main as inspect_main
from raytracing_gpu_tpu_torch.utils.profiling import cuda_ms, device_ms, timed_once

SOURCE = "raytracing_gpu_tpu_torch/csrc/intersect.cu"
PALLAS = "raytracing_gpu_tpu/ops/pallas_intersect.py"
REPLACES = {"nearest_hit": f"{PALLAS}:230", "nearest_dist": f"{PALLAS}:316",
            "fetch_rows": f"{PALLAS}:523", "any_hit": f"{PALLAS}:407",
            "nearest_hit_matmul": f"{PALLAS}:794",
            "nearest_dist_matmul": f"{PALLAS}:844",
            "tile_cull": f"none: {PALLAS}:1038 tile_cull_mask_packed is jnp",
            "tile_cull_levels":
                f"none: {PALLAS}:1197 tile_cull_mask_hierarchical is jnp"}
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


def scanned_share(args, units, kernel=None):
    """(text, share): the (warp, 64-triangle unit) scans of a sweep's
    arguments whose warp some ray enters the unit's box, out of those its
    kept pair tiles offer (`sweep_units_plain`); held equal to the kernel's
    own two counts where it counts (K1, K2)."""
    offered, scanned = (int(x) for x in ck.sweep_units_plain(args[0], args[1],
                                                             args[5], units))
    if kernel is not None:
        work = ck._launch_sweep(kernel, *args, units)[1]
        got = work[2:ck._SWEEP_HEAD].view(torch.int64).tolist()
        if got != [offered, scanned]:
            raise AssertionError(f"{kernel}: counted {got} (warp, unit) scans offered "
                                 f"and made, the plain count {[offered, scanned]}")
    share = scanned / max(offered, 1)
    return f"scans {scanned} of {offered} (warp, unit) pairs ({100 * share:.1f}%)", share


def require_sweep_equal(name, got, ref, what):
    """Bit-equal distances, and equal slots for K1."""
    if name == "nearest_hit":
        n_idx = int((got[1] != ref[1]).sum())
        if n_idx:
            raise AssertionError(f"{name} ({what}): {n_idx} winner slots differ")
        got, ref = got[0], ref[0]
    require_bit_equal(f"{name} ({what})", got, ref)
    return got, ref


def check_sweep(name, rays, pack, iters, what):
    """K1 or K2 against its plain version on one packed ray batch:
    bit-equal distances (and equal slots for K1), and the kernel against
    itself on a second run. The plain version is timed by its one reference
    run (all pairs: a full chunk against the grid takes seconds)."""
    args = sweep_args(rays, pack)
    units = pack.unit_aabb
    kern, plain = SWEEPS[name]
    ref, plain_ms = timed_once(lambda: plain(*args))
    got, again = kern(*args, units), kern(*args, units)
    torch.cuda.synchronize()
    require_sweep_equal(name, again, got, what + ", second run against first")
    got, ref = require_sweep_equal(name, got, ref, what)
    mask = args[5]
    Rp, Tp, kept = args[0].shape[1], pack.v0.shape[0], int(mask.sum())
    scans, share = scanned_share(args, units, name)
    # the pairs of the (warp, unit) scans made: kept pair tiles x share
    bms, by = bound(kept * share * PAIRS_PER_TILE * OPS_PER_PAIR,
                    sweep_bytes(Rp, Tp, 8 if name == "nearest_hit" else 4))
    res = dict(max_abs_err=max_err(got, ref),
               ms=cuda_ms(lambda: kern(*args, units), iters),
               device_ms=device_ms(lambda: kern(*args, units)),
               plain_ms=plain_ms, scanned_share=share,
               bound_ms=bms, bound_by=by, library_ms=None, library_device_ms=None)
    say("kernels", f"{name} ({what}): {Rp} rays x {Tp} triangles, {kept}/"
        f"{mask.numel()} pair tiles kept, {int(torch.isfinite(ref).sum())} hits, "
        f"{scans}: bit-equal, and to its own second run; wrapper {res['ms']:.4f} ms, "
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


def check_any_hit(rays, pack, iters, what):
    """K4 against its plain version and against `nearest_dist < inf`, and
    against itself on a second run: equal exactly. Some ray tile must hold
    occluded and unoccluded live rays together (the flag flip and the live
    count are per ray, within a tile). Also times K2 on the same inputs
    (`k2_ms`, `k2_device_ms`)."""
    op, dp, R = ck.pack_rays(*rays)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, EPS["mt_eps"],
            EPS["self_hit_eps"])
    units = pack.unit_aabb
    got, walked = ck.any_hit_walked(*args, units)
    again = ck.any_hit(*args, units)
    ref, plain_ms = timed_once(lambda: ck.any_hit_plain(*args))
    via_dist = torch.isfinite(ck.nearest_dist(*args, units)) & ck.live_rays(op)
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
    scans, share = scanned_share(args, units)
    # the walked units' pairs, of which the warps scan about `share`
    bms, by = bound(n_walked * share * PAIRS_PER_UNIT * OPS_PER_PAIR,
                    sweep_bytes(Rp, Tp, 1))
    res = dict(max_abs_err=0.0, ms=cuda_ms(lambda: ck.any_hit(*args, units), iters),
               device_ms=device_ms(lambda: ck.any_hit(*args, units)),
               plain_ms=plain_ms, scanned_share=share,
               bound_ms=bms, bound_by=by, library_ms=None, library_device_ms=None,
               k2_ms=cuda_ms(lambda: ck.nearest_dist(*args, units), iters),
               k2_device_ms=device_ms(lambda: ck.nearest_dist(*args, units)))
    say("kernels", f"any_hit ({what}): {Rp} rays ({int(live.sum())} live) x {Tp} "
        f"triangles, walked {n_walked} of {kept} kept units ({scans} by the "
        f"boxes, before the early exit), {n_occ} occluded "
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
    units = pack.unit_aabb
    got, walked = ck.any_hit_walked(*args, units)
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
        f"{cuda_ms(lambda: ck.any_hit(*args, units), 10):.4f} ms, nearest_dist "
        f"{cuda_ms(lambda: ck.nearest_dist(*args, units), 10):.4f} ms")


MATMULS = {"nearest_hit_matmul": (ck.nearest_hit_matmul, ck.nearest_hit_matmul_plain),
           "nearest_dist_matmul": (ck.nearest_dist_matmul, ck.nearest_dist_matmul_plain)}


def check_matmul(name, rays, pack, iters, what):
    """K5 or K6 against its plain version on one recentred ray batch:
    bit-equal distances and slots, also on a second run; K5's winners
    against K1's. The plain version is timed by its one reference run."""
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
        d1, i1 = ck.nearest_hit(op, dp, pack.v0, pack.e1, pack.e2, m1, **EPS,
                                unit_aabb=pack.unit_aabb)
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
               plain_ms=plain_ms,
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
    return ck.nearest_hit(op, dp, pack.v0, pack.e1, pack.e2, mask, **EPS,
                          unit_aabb=pack.unit_aabb)[1][:R]


def shadows_of(scene, rays, pack):
    """The shadow rays the shading pass sends for a batch of primary rays."""
    hit = collide(*rays, scene.geometry, backend="cuda", pack=pack)
    so, sd, _ = shadow_rays(scene.lights, hit)
    return so, sd


# FP32 operations per (ray, box) pair of the slab test: per axis two
# subtractions, two multiplies and four min / max
OPS_PER_RAY_BOX = 24
BENCH_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                             "configs")


def bench_scene(dev, name):
    """A benchmark configuration at 512x512, through the `.svati` text its
    cells parse: `spheres` (4,812 triangles, 19 tiles, 5 shadow lights) or
    `sphereflake` (550,828 triangles, 2,152 tiles, 3 shadow lights)."""
    from portbench import scenes as bench_scenes

    with open(os.path.join(BENCH_CONFIGS, f"{name}.json")) as f:
        config = json.load(f)
    text = bench_scenes.svati_text(bench_scenes.build(config, 512, 512, seed=0))
    return parse_scene_text(text).to(dev)


def check_cull(rays, pack, iters, what):
    """The tile cull against its plain twin on one packed ray batch: equal
    masks, and to its own second run. Bound: each ray read once (24 bytes),
    the mask written once, the boxes read once, against 24 operations per
    (ray, box) pair; the plain twin is timed warm, as the frames run it."""
    op, dp, _ = ck.pack_rays(*rays)
    args = (op, dp, pack.tile_aabb, pack.tile_nonempty)
    ref = ck.tile_cull_mask_packed_plain(*args)
    plain_ms = cuda_ms(lambda: ck.tile_cull_mask_packed_plain(*args), iters)
    got, again = ck.tile_cull_mask_packed(*args), ck.tile_cull_mask_packed(*args)
    torch.cuda.synchronize()
    for other, label in ((ref, "its plain twin"), (again, "its own second run")):
        n = int((got != other).sum())
        if n or got.dtype != torch.int32:
            raise AssertionError(f"tile_cull ({what}): {n} mask entries differ "
                                 f"from {label}")
    Rp, (nB, nR) = op.shape[1], got.shape
    kept = int(got.sum())
    if not 0 < kept < got.numel():
        raise AssertionError(f"tile_cull ({what}): {kept} of {got.numel()} pairs "
                             "kept; the check is vacuous")
    bms, by = bound(Rp * nB * OPS_PER_RAY_BOX, Rp * 24 + nB * nR * 4 + nB * 25)
    res = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: ck.tile_cull_mask_packed(*args), iters),
               device_ms=device_ms(lambda: ck.tile_cull_mask_packed(*args)),
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               library_device_ms=None)
    say("kernels", f"tile_cull ({what}): {Rp} rays x {nB} boxes, {kept}/"
        f"{got.numel()} pair tiles kept: equal to the plain twin (max_abs_err 0), "
        f"and to its own second run; wrapper {res['ms']:.4f} ms, device only "
        f"{res['device_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
        f"({by})")
    return res


def walk_tests(op, dp, levels) -> int:
    """The (ray, box) slab tests of a per-ray walk down the levels: every
    top box, then the 8 children of each box the ray entered."""
    n0, tests = levels[0][0].shape[0], 0
    nT = levels[-1][0].shape[0]
    rb = max(ck.TILE_R, ((1 << 24) // nT) // ck.TILE_R * ck.TILE_R)
    for r0 in range(0, op.shape[1], rb):
        o, d = op[:, r0:r0 + rb], dp[:, r0:r0 + rb]
        tests += n0 * o.shape[1]
        hit = None
        for boxes, nonempty in levels[:-1]:
            h = ck._slab_hits_packed(o, d, boxes) & nonempty[:, None]
            if hit is not None:
                h &= hit.repeat_interleave(8, 0)[:boxes.shape[0]]
            tests += 8 * int(h.sum())
            hit = h
    return tests


def check_cull_levels(rays, pack, iters, what):
    """The hierarchical tile cull against its plain twin on one packed ray
    batch, down the union-box levels of the pack's leaf tiles: equal masks,
    equal to its own second run and to the flat cull of the leaves. Bound:
    each ray read once (24 bytes), the mask written once, the boxes read
    once, against 24 operations per (ray, box) pair that a per-ray walk
    tests (`walk_tests`); the flat cull over every leaf and the build of the
    levels are timed beside it."""
    op, dp, _ = ck.pack_rays(*rays)
    leaves = (pack.tile_aabb, pack.tile_nonempty)
    levels = ck.build_tile_levels(*leaves) + [leaves]
    ref, plain_ms = timed_once(lambda: ck.tile_cull_mask_levels_plain(op, dp, levels))
    got = ck.tile_cull_mask_levels(op, dp, levels)
    again = ck.tile_cull_mask_levels(op, dp, levels)
    flat = ck.tile_cull_mask_packed(op, dp, *leaves)
    torch.cuda.synchronize()
    for other, label in ((ref, "its plain twin"), (again, "its own second run"),
                         (flat, "the flat cull of the leaves")):
        n = int((got != other).sum())
        if n or got.dtype != torch.int32:
            raise AssertionError(f"tile_cull_levels ({what}): {n} mask entries "
                                 f"differ from {label}")
    Rp, (nT, nR) = op.shape[1], got.shape
    kept = int(got.sum())
    if not 0 < kept < got.numel():
        raise AssertionError(f"tile_cull_levels ({what}): {kept} of {got.numel()} "
                             "pairs kept; the check is vacuous")
    tests = walk_tests(op, dp, levels)
    n_boxes = sum(b.shape[0] for b, _ in levels)
    bms, by = bound(tests * OPS_PER_RAY_BOX, Rp * 24 + nT * nR * 4 + n_boxes * 25)
    res = dict(max_abs_err=0.0,
               ms=cuda_ms(lambda: ck.tile_cull_mask_levels(op, dp, levels), iters),
               device_ms=device_ms(lambda: ck.tile_cull_mask_levels(op, dp, levels)),
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
               library_device_ms=None, tests=tests,
               flat_device_ms=device_ms(lambda: ck.tile_cull_mask_packed(op, dp, *leaves)),
               build_device_ms=device_ms(lambda: ck.build_tile_levels(*leaves)))
    say("kernels", f"tile_cull_levels ({what}): {Rp} rays, levels of "
        f"{[b.shape[0] for b, _ in levels]} boxes, {tests} (ray, box) tests, {kept}/"
        f"{got.numel()} pair tiles kept: equal to the plain twin (max_abs_err 0), "
        f"to its own second run and to the flat cull; wrapper {res['ms']:.4f} ms, "
        f"device only {res['device_ms']:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.5f} ms ({by}); the flat cull of the leaves {res['flat_device_ms']:.4f} "
        f"ms, the levels' build {res['build_device_ms']:.4f} ms")
    return res


def check_kernels(dev):
    """All six kernels and the tile cull against their plain versions on the
    card, at the shapes the renders give them. Returns {kernel: result dict} at the shapes
    of the path that claims the kernel: K1-K3 and K5/K6 on one 65,536-ray
    chunk of the sphere scene's CPU-mode primary rays and its 131,072 shadow
    rays, K4 on the shadow rays of one GPU-mode chunk. Every kernel is also
    held on 4,096 rays of the 96k-triangle grid (octree levels, 12 MB
    table) and every sweep on one full chunk of it (`grid_4096` and
    `grid_chunk` in the result), K1 on exact ties and K3 on its edge cases.
    The hierarchical cull is held on the benchmark's `sphereflake` chunk and
    its shadow batch, and on the grid's chunk."""
    chunk = RenderConfig().ray_chunk
    sph = make_sphere_scene(512, 512, **SPHERES).to(dev)
    sph_pack = scene_pack(sph)
    grid = make_sphere_grid_scene(512, 512).to(dev)
    grid_pack = scene_pack(grid)
    say("kernels", f"sphere scene {sph.n_triangles} triangles; grid "
        f"{grid.n_triangles} triangles ({grid_pack.table.numel() * 4 / 2**20:.1f} MB table)")
    results = {}
    bench = bench_scene(dev, "spheres")
    bench_pack = scene_pack(bench)
    bprim = cpu_primary_rays(bench, chunk)
    results["tile_cull"] = check_cull(shadows_of(bench, bprim, bench_pack),
                                      bench_pack, 50, "benchmark spheres, its "
                                      "5-light shadow batch")
    results["tile_cull"]["nearest_chunk"] = check_cull(
        bprim, bench_pack, 50, "benchmark spheres, CPU-mode primary chunk")
    flake = bench_scene(dev, "sphereflake")
    flake_pack = scene_pack(flake)
    fprim = cpu_primary_rays(flake, chunk)
    results["tile_cull_levels"] = check_cull_levels(
        fprim, flake_pack, 50, "benchmark sphereflake, CPU-mode primary chunk")
    results["tile_cull_levels"]["shadow_batch"] = check_cull_levels(
        shadows_of(flake, fprim, flake_pack), flake_pack, 50,
        "benchmark sphereflake, its 3-light shadow batch")
    del flake, flake_pack, fprim
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
    results["tile_cull_levels"]["grid_chunk"] = check_cull_levels(full, grid_pack, 50, what)
    results["grid_chunk"] = {
        name: check_sweep(name, full, grid_pack, 10, what) for name in SWEEPS}
    results["grid_chunk"]["any_hit"] = check_any_hit(full, grid_pack, 10, what)
    for name in MATMULS:
        results["grid_chunk"][name] = check_matmul(name, full, grid_pack, 10, what)
    return results


def wall_ms(fn):
    """(result, host milliseconds of one call, synchronised with the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def time_frames(renderer, n: int):
    """(the last frame, host milliseconds of each of n frames)."""
    runs = [wall_ms(renderer.render_device) for _ in range(n)]
    return runs[-1][0], [ms for _, ms in runs]


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


@contextlib.contextmanager
def eager_steps():
    """Yields a list that gets, per chunk an eager frame traces, the bounce
    steps it took (`render._bounce_step` calls between `render._trace`
    calls)."""
    R = sys.modules["raytracing_gpu_tpu_torch.render"]
    step, trace = R._bounce_step, R._trace
    calls = []

    def counting_step(*args, **kwargs):
        calls[-1] += 1
        return step(*args, **kwargs)

    def counting_trace(*args, **kwargs):
        calls.append(0)
        return trace(*args, **kwargs)

    R._bounce_step, R._trace = counting_step, counting_trace
    try:
        yield calls
    finally:
        R._bounce_step, R._trace = step, trace


def check_graph_cell(what, scene, cfg, dev, smi, need, none=(), n_primary=0,
                     want_profile=False):
    """One render cell through `SceneRenderer`'s frame graph (the captured
    pieces assembled into one CUDA graph with its loops on the device,
    `renderer.plan`) against the eager frame of the same config rendered
    with `unroll="static"`, which stays eager: one graph launch and no host
    sync per frame, bit-equal images, the same launches per kernel and the
    same bounce steps per chunk, two launches bit-equal, the condition
    kernels launched once per chunk (`loop_reset`, `chunk_advance`) and once
    per bounce step (`bounce_condition`). Both are timed in turns (graph,
    eager, eager, graph; host clock around synchronised frames); the
    capture's cost (ms, assembly ms, memory the card reserved) and each
    piece's node types are printed. A block the allocator cached before the
    capture must still be reserved after it. With `want_profile` one more
    graph frame is traced (`profile_call`). Returns (graph renderer, its
    frame, its launches per kernel, its condition kernels' launches, the
    traced frame's device kernels or None)."""
    addr = cached_block(dev)
    graph = SceneRenderer(scene, cfg, dev)
    require_still_reserved(addr, what)
    plan = graph.plan
    eager = SceneRenderer(scene, dataclasses.replace(cfg, unroll="static"), dev)
    if plan is None or plan.graphs != 1 or eager.plan is not None:
        raise AssertionError(f"{what}: expected one frame graph beside an eager frame")
    runs = []
    for i, r in enumerate((graph, eager, eager, graph)):
        ck.reset_launch_counts()
        frame_graph.reset_launch_counts()
        with eager_steps() if i == 1 else contextlib.nullcontext() as counted:
            img, ms = wall_ms(r.render_device)
        runs.append((img, ms, dict(ck.LAUNCHES), dict(frame_graph.LAUNCHES)))
        if i == 1:
            steps_eager = tuple(counted)
    ((img, tg1, counts, loops), (eimg, te1, ecounts, _), (_, te2, _, _),
     (img2, tg2, counts2, loops2)) = runs
    with profiling.recording():  # a frame's host syncs are counted while recording
        graph.render_device()
    torch.cuda.synchronize()
    f = plan.last_frame
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{what}: the graph frame never launched {name}")
    for name in none:
        if counts[name]:
            raise AssertionError(f"{what}: the graph frame launched {name} "
                                 f"{counts[name]} times, expected none")
    if counts != ecounts or counts2 != counts:
        raise AssertionError(f"{what}: launches of the graph frame {counts} (again "
                             f"{counts2}), of the eager frame {ecounts}")
    if (f.launches, f.syncs) != (1, 0):
        raise AssertionError(f"{what}: a frame made {f.launches} graph launches and "
                             f"{f.syncs} host syncs (as counted), expected 1 and 0")
    if f.steps != steps_eager:
        raise AssertionError(f"{what}: steps per chunk {f.steps}, the eager loop's "
                             f"{steps_eager}")
    want_loops = {"loop_reset": plan.n_chunks, "bounce_condition": sum(f.steps),
                  "chunk_advance": plan.n_chunks}
    if loops != want_loops or loops2 != want_loops:
        raise AssertionError(f"{what}: condition kernels launched {loops} (again "
                             f"{loops2}), expected {want_loops}")
    if not torch.equal(img, eimg):
        raise AssertionError(f"{what}: the graph frame is not bit-equal to the eager "
                             f"frame ({int((img != eimg).any(-1).sum())} pixels differ)")
    if not torch.equal(img2, img):
        raise AssertionError(f"{what}: two launches of the frame differ")
    check_image(img, graph.width, graph.height)
    warm = {k: n for k, n in plan.warmup_launches.items() if n}
    ms_g, ms_e = (tg1 + tg2) / 2, (te1 + te2) / 2
    # the device's own time for the frame program: two launches back to back
    # between two events (node gaps inside the graph included)
    stream = torch.cuda.current_stream()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(2):
        plan.graph.launch(stream)
    stop.record()
    torch.cuda.synchronize()
    ms_dev = start.elapsed_time(stop) / 2
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rate = f", {n_primary / ms_g * 1e3 / 1e6:.3f} M primary rays/s" if n_primary else ""
    say("render", f"{what} ({scene.n_triangles} tris): graph frame bit-equal to the "
        f"eager frame (unroll=static) and to its own second launch; launches per frame "
        f"{counts} in both, condition kernels {loops}; ms/frame in turns graph "
        f"{tg1:.3f}, eager {te1:.3f}, {te2:.3f}, graph {tg2:.3f}: graph {ms_g:.3f}, "
        f"eager {ms_e:.3f}, eager/graph {ms_e / ms_g:.2f}x{rate}; the frame graph "
        f"alone on the device {ms_dev:.3f} ms = {100 * ms_dev / ms_g:.1f}% of the "
        f"graph frame (SM clock, its maximum, power draw just after: {clocks}); "
        f"captured and "
        f"assembled in {plan.capture_ms:.1f} ms (assembly {plan.assembly_ms:.1f} ms; "
        f"launches of the warm-up {warm}), the card reserving "
        f"{plan.held_bytes / 2**20:.1f} MiB for the pieces and their buffers, a block "
        f"cached before still reserved; per frame {f.launches} graph launch and "
        f"{f.syncs} host syncs, {plan.n_chunks} chunks of {plan.frame.chunk} rays "
        f"taking {min(f.steps)}-{max(f.steps)} steps ({sum(f.steps)} in all), equal to "
        f"the eager loop's per chunk; {smi}")
    say("render", f"{what}: node types per piece " + "; ".join(
        f"{name} {nodes}" for name, nodes in plan.piece_nodes.items()))
    traced = (profile_call(graph.render_device, f"{what}, graph frame", ms_g,
                           conditional=True)
              if want_profile else None)
    return graph, img, counts, loops, traced


# the frame graph's condition kernels (csrc/frame_loop.cu): no TPU kernel;
# what each stands for in the JAX package's frame program
LOOP_SOURCE = "raytracing_gpu_tpu_torch/csrc/frame_loop.cu"
LOOP_REPLACES = {
    "loop_reset": "raytracing_gpu_tpu/render.py:136",        # while_loop entry
    "bounce_condition": "raytracing_gpu_tpu/render.py:136",  # its cond (:198 GPU)
    "chunk_advance": "raytracing_gpu_tpu/render.py:320"}     # lax.map's counter
# bytes each kernel must move: the state it reads and writes (its launch
# counter among it) and the 4-byte condition it sets
LOOP_BYTES = {"loop_reset": 4 + 4 + 4, "bounce_condition": 8 + 4 + 4 + 4 + 4 + 1 + 4,
              "chunk_advance": 8 + 8 + 4 + 4 + 4}
# (chunks, depth cap, first step, share of steps whose flag says "alive")
LOOP_CASES = ((1, 1, True, 1.0), (3, 0, True, 1.0), (5, 6, False, 0.9),
              (36, 11, True, 0.8), (20, 29, True, 0.95), (4, 7, True, 1.0))
LOOP_ITERS = 1000
# what one iteration timed for each kernel's `ms` holds (each piece one
# captured one-element fill)
LOOP_BODY = {"bounce_condition": "the bounce loop's: the step piece and the kernel",
             "loop_reset": "the chunk loop's: rays, loop_reset, a bounce loop kept "
                           "shut, fold and chunk_advance (shared with chunk_advance)",
             "chunk_advance": "the chunk loop's: rays, loop_reset, a bounce loop kept "
                              "shut, fold and chunk_advance (shared with loop_reset)"}


def expected_steps(alive, first_step: bool, n_bounces: int) -> list:
    """The eager loop's steps per chunk when step k of chunk c leaves a ray
    alive exactly where alive[c, k]."""
    if not (first_step and n_bounces > 0):
        return [0] * alive.shape[0]
    out = []
    for row in alive:
        dead = np.flatnonzero(~row[:n_bounces - 1])
        out.append(int(dead[0]) + 1 if dead.size else n_bounces)
    return out


def capture_pieces(fns: dict, dev) -> dict:
    """Each of `fns` warmed up, then captured into a CUDA graph whose
    `cudaGraph_t` is kept (as a `FramePlan` captures its pieces)."""
    passes = [(f"{name!r} piece", fn) for name, fn in fns.items()]
    side, _, _ = capture.warm_up(dev, passes, "loop probe")
    graphs, _ = capture.capture(side, passes, "loop probe", keep_graph=True)
    return dict(zip(fns, graphs))


def assemble(state, graphs, n_chunks, n_bounces, first_step):
    return frame_graph.FrameGraph(state, {n: g.raw_cuda_graph() for n, g in graphs.items()},
                                  n_chunks, n_bounces, first_step)


class LoopProbe:
    """The frame's PROGRAM over pieces that drive the loops from a seeded
    table: "rays" and "fold" count their runs per chunk, "step" writes
    alive[chunk, step] into the flag. Captured like a `FramePlan`'s pieces
    and assembled by `frame_graph.FrameGraph`, or run by the interpreter
    over the same tensors with the kernels' twins."""

    def __init__(self, dev, alive, n_bounces, first_step):
        self.n_chunks, self.width = alive.shape
        self.n_bounces, self.first_step = n_bounces, first_step
        self.state = frame_graph.LoopState.zeros(self.n_chunks, dev)
        self.alive = torch.from_numpy(alive.reshape(-1).copy()).to(dev)
        self.rays = torch.zeros((self.n_chunks,), dtype=torch.int32, device=dev)
        self.folds = torch.zeros_like(self.rays)
        self.one = torch.ones((1,), dtype=torch.int32, device=dev)
        self.fns = {"rays": lambda: self.rays.index_add_(0, self.ci(), self.one),
                    "step": self.step,
                    "fold": lambda: self.folds.index_add_(0, self.ci(), self.one)}
        self.graphs = capture_pieces(self.fns, dev)
        self.frame = assemble(self.state, self.graphs, self.n_chunks, n_bounces, first_step)

    def ci(self):
        return self.state.chunk_index.reshape(1)

    def step(self):
        k = self.state.steps.index_select(0, self.ci()).long()
        self.state.flag.copy_(self.alive.index_select(0, self.ci() * self.width + k))

    def clear(self):
        for t in (self.rays, self.folds, self.state.counts, self.state.chunk_index,
                  self.state.flag):
            t.zero_()

    def results(self) -> dict:
        torch.cuda.synchronize()
        steps, loops = self.state.read()
        return {"steps": list(steps), "loops": loops, "rays": self.rays.tolist(),
                "folds": self.folds.tolist(), "chunk_index": int(self.state.chunk_index)}

    def launch(self) -> dict:
        self.clear()
        self.frame.launch(torch.cuda.current_stream())
        return self.results()

    def interpret(self) -> dict:
        self.clear()
        frame_graph.interpret(frame_graph.PROGRAM, self.state, self.fns, self.n_chunks,
                              self.n_bounces, self.first_step)
        return self.results()


def loop_iteration_ms(dev, n_chunks, n_bounces, reps: int = 20) -> float:
    """CUDA-event milliseconds of one launch of the frame's PROGRAM whose
    pieces are each one captured one-element fill (the step's keeps the
    flag "alive"): mean of `reps` launches."""
    state = frame_graph.LoopState.zeros(n_chunks, dev)
    spare = torch.zeros((1,), dtype=torch.bool, device=dev)
    graphs = capture_pieces({"rays": lambda: spare.fill_(True),
                             "step": lambda: state.flag.fill_(True),
                             "fold": lambda: spare.fill_(True)}, dev)
    frame = assemble(state, graphs, n_chunks, n_bounces, True)
    stream = torch.cuda.current_stream()
    frame.launch(stream)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        frame.launch(stream)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_frame_loop(dev) -> dict:
    """The three condition kernels of the frame graph against their plain
    twins: for each of LOOP_CASES a seeded table of alive flags drives one
    standalone frame graph (the frame's PROGRAM, launched twice) and the
    interpreter over the same tensors; steps per chunk, the condition
    kernels' launches as they counted them, runs of "rays" and "fold" per
    chunk and the final chunk index must be equal, and equal to what the
    eager loop would do. The sync counter a frame is held to must count an
    `.item()` and nothing in an add. Then the cost of one WHILE iteration,
    from the frame program with one-kernel pieces: LOOP_ITERS + 1 iterations
    against 1, of the bounce loop and of the chunk loop. Returns {kernel:
    result dict}."""
    system, runtime = frame_graph.cuda_versions()
    nvcc = next(line for line in subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True,
        text=True).stdout.splitlines() if "release" in line)
    say("loop", f"CUDA {system} on the system, the kernels' runtime {runtime}, {nvcc} "
        "(WHILE conditional nodes need 12030)")
    rng = np.random.default_rng(20261017)
    worst, trips = 0, 0
    for n_chunks, n_bounces, first_step, p in LOOP_CASES:
        alive = rng.random((n_chunks, max(n_bounces, 1))) < p
        probe = LoopProbe(dev, alive, n_bounces, first_step)
        got, again, twin = probe.launch(), probe.launch(), probe.interpret()
        want = expected_steps(alive, first_step, n_bounces)
        ran = [1] * n_chunks
        loops = {"loop_reset": n_chunks, "bounce_condition": sum(want),
                 "chunk_advance": n_chunks}
        if not (got == again == twin and got["steps"] == want and got["loops"] == loops
                and got["rays"] == ran and got["folds"] == ran
                and got["chunk_index"] == n_chunks):
            raise AssertionError(f"frame loop, {n_chunks} chunks, cap {n_bounces}, "
                                 f"first step {first_step}: graph {got}, again {again}, "
                                 f"twins {twin}, eager loop's steps {want}")
        worst = max(worst, max(abs(a - b) for a, b in zip(got["steps"], twin["steps"])))
        trips += sum(want)
    say("loop", f"{len(LOOP_CASES)} seeded frame programs (1-36 chunks, caps 0-29, "
        f"{trips} bounce steps): the frame graph's steps per chunk, condition kernel "
        "launches (counted on the device), runs of rays and fold and final chunk "
        "index equal to the twins' and to the eager loop's, twice")
    x = torch.ones((1,), device=dev)
    with capture.counted_syncs() as in_add:
        x.add_(1.0)
    with capture.counted_syncs() as in_item:
        x.sum().item()
    if in_add.n != 0 or in_item.n < 1:
        raise AssertionError(f"the sync counter counted {in_add.n} syncs in an add and "
                             f"{in_item.n} in an .item()")
    say("loop", f"the sync counter: {in_add.n} syncs in an add, {in_item.n} in an .item()")

    n = LOOP_ITERS
    bounce_ms = (loop_iteration_ms(dev, 1, n + 1) - loop_iteration_ms(dev, 1, 1)) / n
    chunk_ms = (loop_iteration_ms(dev, n + 1, 0) - loop_iteration_ms(dev, 1, 0)) / n
    ms = {"bounce_condition": bounce_ms, "loop_reset": chunk_ms, "chunk_advance": chunk_ms}
    # the twins, timed on the card over the same kind of state
    state = frame_graph.LoopState.zeros(4, dev)
    cond = torch.zeros((1,), dtype=torch.bool, device=dev)
    plain = {"loop_reset": cuda_ms(lambda: frame_graph.loop_reset(cond, state, True, 6),
                                   200),
             "bounce_condition": cuda_ms(
                 lambda: frame_graph.bounce_condition(cond, state, 1 << 30), 200),
             "chunk_advance": cuda_ms(
                 lambda: frame_graph.chunk_advance(cond, state, 1 << 30), 200)}
    results = {}
    for name in frame_graph.KERNELS:
        b, by = bound(0, LOOP_BYTES[name])
        results[name] = {"max_abs_err": float(worst), "ms": ms[name], "plain_ms": plain[name],
                         "bound_ms": b, "bound_by": by, "library_ms": None}
    say("loop", f"one WHILE iteration ({n + 1} iterations against 1, each piece one "
        f"captured one-element fill): of the bounce loop (the step, bounce_condition) "
        f"{bounce_ms * 1e3:.3f} us; of the chunk loop (rays, loop_reset, a bounce loop "
        f"kept shut, fold, chunk_advance) {chunk_ms * 1e3:.3f} us; twins "
        + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in plain.items()))
    return results


OWN_KERNELS = ("fetch_rows_kernel", "sweep_list_kernel") + tuple(
    f"sweep_kernel<{kind}>" for kind in ("NEAREST_HIT", "NEAREST_DIST", "ANY_HIT",
                                         "MATMUL_HIT", "MATMUL_DIST")) + (
    "tile_cull_kernel", "tile_cull_levels_kernel")


def own_kernel(name: str):
    """The port's kernel a profiled device kernel is, or None. A sweep's
    demangled name ends in its kind's number: sweep_kernel<2> or <(int)2>."""
    if "sweep_kernel<" in name:
        digits = [c for c in name.split("sweep_kernel<")[1].split(">")[0] if c.isdigit()]
        return OWN_KERNELS[2 + int(digits[-1])] if digits else None
    names = OWN_KERNELS[:2] + OWN_KERNELS[7:] + tuple(
        f"{k}_kernel" for k in frame_graph.KERNELS)
    return next((t for t in names if t in name), None)


SWEEP_KIND = {"nearest_hit": "NEAREST_HIT", "nearest_dist": "NEAREST_DIST",
              "any_hit": "ANY_HIT", "nearest_hit_matmul": "MATMUL_HIT",
              "nearest_dist_matmul": "MATMUL_DIST"}


def expected_kernels(counted) -> dict:
    """{the port's device kernel: launches} that launch counts (the
    wrappers' and the condition kernels', by name) say ran."""
    want = {f"{k}_kernel": counted[k] for k in frame_graph.KERNELS}
    want["fetch_rows_kernel"] = counted["fetch_rows"]
    want["tile_cull_kernel"] = counted["tile_cull"]
    want["tile_cull_levels_kernel"] = counted["tile_cull_levels"]
    for name, kind in SWEEP_KIND.items():
        want[f"sweep_kernel<{kind}>"] = counted[name]
    return {k: n for k, n in want.items() if n}


def profile_call(fn, what, unprofiled_ms=None, conditional=False) -> int:
    """Trace one warm call (a frame, a training step): kernel launches
    (returned), the device's busy share (`utils.profiling.profile_call`;
    with `unprofiled_ms`, also the busy time over that unprofiled call's
    time) and the time in the port's own kernels. The port's kernels the
    trace names must be those the launch counters counted in the traced
    call, as often; in a frame graph (`conditional`: kernels in WHILE
    bodies) the trace names them wrongly in some cells (PERF.md section 7),
    so there a disagreement is printed and their times are left out."""
    before = {**ck.LAUNCHES, **frame_graph.LAUNCHES}
    prof = profiling.profile_call(fn)
    expect = expected_kernels({k: n - before[k] for k, n in
                               {**ck.LAUNCHES, **frame_graph.LAUNCHES}.items()})
    own = {}
    for k in prof.kernels:
        tag = own_kernel(k.name)
        if tag is not None:
            n, us = own.get(tag, (0, 0.0))
            own[tag] = (n + 1, us + k.time_range.elapsed_us())
    seen = {t: n for t, (n, _) in own.items() if t != "sweep_list_kernel"}
    if seen != expect:
        if not conditional:
            raise AssertionError(f"{what}: the trace names the port's kernels {seen} "
                                 f"times, the launch counters say {expect}")
        say("profile", f"{what}: the trace names the port's kernels {seen} times, the "
            f"launch counters say {expect}: names in WHILE bodies are wrong here, so "
            "no per-kernel times")
        own = {}
    unprofiled = ("" if unprofiled_ms is None else f", {100 * prof.busy_ms / unprofiled_ms:.1f}% "
                  f"of the unprofiled {unprofiled_ms:.3f} ms")
    say("profile", f"{what}: profiled call {prof.wall_ms:.1f} ms, {len(prof.kernels)} "
        f"device kernels and copies, device busy {prof.busy_ms:.1f} ms = "
        f"{100 * prof.busy_share:.1f}% of it{unprofiled}; own kernels "
        + (", ".join(f"{t} {us / 1e3:.2f} ms in {n}" for t, (n, us) in sorted(own.items()))
           or "not timed"))
    return len(prof.kernels)


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
    tensors (plain versions), 16x16 sphere scene, all 13 groups for backend
    "cuda" and three for "cuda_matmul"; on the card twice. Geometry, normals,
    materials and the camera must get a gradient that is not all zero: a
    fetch without `grad_fn` or a camera basis computed off the graph would
    leave exact zeros there. The plain sweeps on the CPU compute all pairs,
    seconds per bounce: the depth is cut to 2 bounces (every group's
    gradient is there from the second bounce on) and to 1 for the three
    groups of "cuda_matmul". The image is cut to 16x16 for the same reason:
    1,024 rays still reach every group."""
    scene = make_sphere_scene(16, 16, **SPHERES)
    for backend, depth, groups, nonzero in (
            ("cuda", 2, PARAM_KEYS, ("vertices", "normals", "kd", "cam_fov")),
            ("cuda_matmul", 1, ("vertices", "kd", "lights_rgb"),
             ("vertices", "kd", "lights_rgb"))):
        cfg = RenderConfig(quantize="smooth", backend=backend, diff_max_depth=depth)
        got, card_ms = wall_ms(lambda: render_gradients(scene, cfg, dev))
        ck.reset_launch_counts()
        again, again_ms = wall_ms(lambda: render_gradients(scene, cfg, dev))
        counts = dict(ck.LAUNCHES)
        plan = image_graph.image_plans()[-1]
        if (plan.captures, plan.replays, plan.backward_replays, plan.last_call) != (
                1, 1, 2, "replay"):
            raise AssertionError(f"gradient ({backend}): the plan captured "
                                 f"{plan.captures} times, replayed its forward graph "
                                 f"{plan.replays} and its backward graph "
                                 f"{plan.backward_replays} times, last call "
                                 f"{plan.last_call!r}")
        t0 = time.perf_counter()
        ref = render_gradients(scene, cfg, "cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
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
        say("train", f"gradient of mean(render_image), spheres 16x16, depth {depth}, {backend}: "
            f"{len(groups)} groups on the card within rtol {GRAD_RTOL} / atol "
            f"{GRAD_ATOL_SHARE} of the largest entry of the plain path's; largest "
            f"|d| {worst:.3e} of a group's largest entry; {', '.join(nonzero)} not "
            f"all zero; second run on the card differs by at most {rerun:.3e}; "
            f"through render_image's plan: the first call captured it (warm-up and "
            f"capture {plan.capture_ms:.1f} ms, {plan.held_bytes / 2**20:.1f} MiB), "
            f"the second replayed its forward and backward graphs ({plan.captures} "
            f"capture, {plan.replays} forward and {plan.backward_replays} backward "
            f"replays, the first backward replay the capturing call's); launches of "
            f"the replayed forward+backward {counts}; host ms: capturing call "
            f"{card_ms:.0f}, replayed call {again_ms:.0f}, the plain path {cpu_ms:.0f}")


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


def timed_step(step_fn, state, scene, coords, target):
    """One synchronised step: (loss, host ms, launches, peak bytes
    allocated during it)."""
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, loss = step_fn(state, scene, coords, target)
    torch.cuda.synchronize()
    return (float(loss), (time.perf_counter() - t0) * 1e3, dict(ck.LAUNCHES),
            torch.cuda.max_memory_allocated())


def timed_steps(step_fn, state, scene, coords, target, n):
    """n synchronised steps: (state, losses, ms per step, launches per step,
    peak bytes allocated)."""
    runs = [timed_step(step_fn, state, scene, coords, target) for _ in range(n)]
    return (state, [r[0] for r in runs], [r[1] for r in runs], [r[2] for r in runs],
            max(r[3] for r in runs))


def cached_block(dev, nbytes=64 << 20):
    """The address of a block the allocator caches (allocated and freed)."""
    block = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    addr = block.data_ptr()
    del block
    return addr


def require_still_reserved(addr, what):
    """A capture must not release the allocator's cached blocks."""
    if not any(seg["address"] <= addr < seg["address"] + seg["total_size"]
               for seg in torch.cuda.memory_snapshot()):
        raise AssertionError(f"{what}: a block cached before the capture was released")


def require_close_states(a, b, what):
    """Parameters and optimizer moments of two states within rtol 1e-3 and
    atol 1e-4 of each group's largest entry (`index_add_` sums in another
    order on every run); returns the largest |d| over that entry."""
    worst = 0.0
    for k in PARAM_KEYS:
        x, y = a.params[k].detach(), b.params[k].detach()
        scale = max(float(y.abs().max()), 1e-30)
        if not torch.allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale):
            raise AssertionError(f"{what}: {k} off by {float((x - y).abs().max()):.3e} "
                                 f"of {scale:.3e}")
        worst = max(worst, float((x - y).abs().max()) / scale)
    sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
    for i, slot in sa.items():
        for name, x in slot.items():
            y = sb[i][name]
            scale = max(float(y.abs().max()), 1e-30)
            if not torch.allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale):
                raise AssertionError(f"{what}: Adam's {name} of group {i} off by "
                                     f"{float((x - y).abs().max()):.3e} of {scale:.3e}")
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def adam(*names):
    """Adam at the cell's rate over the named groups, capturable (a
    captured step needs it)."""
    return lambda p: torch.optim.Adam([p[k] for k in names], lr=TRAIN["lr"],
                                      capturable=True)


def check_training(dev, smi, want_profile):
    """The training path at full width through the captured step (CUDA
    graph replays, `utils.step_graph.StepPlan`), held against the eager step
    for its first 3 steps; returns the launches of one step with
    `remat=True`."""
    size, depth = TRAIN["size"], TRAIN["depth"]
    scene = make_sphere_scene(size, size, **SPHERES)
    scene_d = scene.to(dev)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda",
                       ray_chunk=TRAIN["ray_chunk"], diff_max_depth=depth,
                       remat=True)
    n_rays = size * size * 4
    n_chunks = n_rays // TRAIN["ray_chunk"]
    coords = camera_ops.cpu_subpixel_coords_traced(
        size, size, torch.arange(n_rays, device=dev))
    with torch.no_grad():
        target = predict_pixels(scene, cfg, depth, coords, device=dev)
    if tuple(target.shape) != (size * size, 3) or not bool(torch.isfinite(target).all()):
        raise AssertionError("training target has the wrong shape or is not finite")
    start = perturbed_params(scene)
    true_kd = scene.materials.kd[:scene.n_objects]

    def kd_error(state):
        return float((state.params["kd"][:scene.n_objects].detach().cpu()
                      - true_kd).abs().mean())

    init_state, step_fn = make_train_step(None, cfg, scene, optimizer=adam("kd", "lights_rgb"),
                                          device=dev)
    init_eager, step_eager = make_train_step(None, cfg, scene,
                                             optimizer=adam("kd", "lights_rgb"),
                                             device=dev, plan=False)
    plan = step_fn.plan
    if plan is None or step_eager.plan is not None:
        raise AssertionError("training: expected a captured step beside an eager one")
    state, twin = init_state(start), init_eager(start)
    kd0 = kd_error(state)
    addr = cached_block(dev)
    # the first 3 steps in turns with the eager twin: graph, eager, eager,
    # graph, graph, eager (the graph's first step is its capture)
    runs = {"graph": [], "eager": []}
    for order in (("graph", "eager"), ("eager", "graph"), ("graph", "eager")):
        for which in order:
            fn, st = (step_fn, state) if which == "graph" else (step_eager, twin)
            runs[which].append(timed_step(fn, st, scene_d, coords, target))
            if which == "graph" and len(runs["graph"]) == 1:
                require_still_reserved(addr, "training step capture")
    losses = [r[0] for r in runs["graph"]]
    eager_losses = [r[0] for r in runs["eager"]]
    if losses[0] != eager_losses[0]:
        raise AssertionError(f"training: step-1 loss {losses[0]!r} of the captured step, "
                             f"{eager_losses[0]!r} of the eager one")
    if not np.allclose(losses, eager_losses, rtol=GRAD_RTOL):
        raise AssertionError(f"training: losses {losses} against eager {eager_losses}")
    worst = require_close_states(state, twin, "captured against eager after 3 steps")
    runs["graph"] += [timed_step(step_fn, state, scene_d, coords, target)
                      for _ in range(TRAIN["steps"] - 3)]
    losses = [r[0] for r in runs["graph"]]
    kd1 = kd_error(state)
    if plan.captures != 1 or plan.replays != TRAIN["steps"] - 1 or state.step != TRAIN["steps"]:
        raise AssertionError(f"training: {plan.captures} captures and {plan.replays} "
                             f"replays for {state.step} steps")
    peak_capture, peak = runs["graph"][0][3], max(r[3] for r in runs["graph"][1:])
    peak_e = max(r[3] for r in runs["eager"])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training: a loss is not finite: {losses}")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"training: loss {losses[0]:.3e} -> {losses[-1]:.3e}, "
                             "not under half its first value")
    if not kd1 < kd0:
        raise AssertionError(f"training: kd error {kd0:.4f} -> {kd1:.4f} did not fall")
    counts = [r[2] for r in runs["graph"]]
    per_step, eager_step = counts[-1], runs["eager"][-1][2]
    sweeps = n_chunks * depth
    want = {"nearest_hit": sweeps, "nearest_dist": sweeps, "fetch_rows": 2 * sweeps}
    if any(c != per_step for c in counts[1:]) or any(
            per_step[k] != n for k, n in want.items()):
        raise AssertionError(f"training: launches per replayed step {counts}, expected "
                             f"{want} ({n_chunks} chunks x {depth} bounce steps; the "
                             "fetch again in remat's recomputation)")
    if eager_step["nearest_hit"] >= per_step["nearest_hit"]:
        raise AssertionError(f"training: the eager step launched {eager_step}, the "
                             f"captured one {per_step}: no early exit to cut")
    tg = [r[1] for r in runs["graph"]]
    te = [r[1] for r in runs["eager"]]
    ms, ms_e = float(np.median(tg[1:])), float(np.median(te[1:]))
    warm = {k: n for k, n in plan.warmup_launches.items() if n}
    say("train", f"spheres {size}x{size} ({scene.n_triangles} tris, {n_rays} rays in "
        f"{n_chunks} chunks, depth {depth}), cuda, remat=True, capturable Adam lr "
        f"{TRAIN['lr']} on kd + lights_rgb, captured step (CUDA graph): loss "
        f"{losses[0]:.4e} -> {losses[-1]:.4e} in {len(losses)} steps "
        f"(x{losses[-1] / losses[0]:.4f}), kd error {kd0:.4f} -> {kd1:.4f}; "
        f"{plan.captures} capture ({plan.capture_ms:.1f} ms, of which the warm-up step "
        f"{plan.warmup_ms:.1f} ms; the "
        f"card reserving {plan.held_bytes / 2**20:.1f} MiB for the graph and buffers; "
        f"a block cached before it still reserved), {plan.replays} replays, 1 replay "
        f"per step; steps {[round(t, 1) for t in tg]} ms; launches per step "
        f"{per_step} (warm-up step {warm}); peak memory allocated: warm-up step and "
        f"capture {peak_capture / 2**20:.1f} MiB, a replayed step {peak / 2**20:.1f} MiB, "
        f"an eager step {peak_e / 2**20:.1f} MiB; {smi}")
    say("train", f"captured against eager, first 3 steps in turns: graph "
        f"{[round(t, 1) for t in tg[:3]]} ms, eager {[round(t, 1) for t in te]} ms; "
        f"ms/step (steps 2-3, replays of step 2-20) graph {ms:.1f}, eager {ms_e:.1f}, "
        f"eager/graph {ms_e / ms:.2f}x; step-1 loss bit-equal "
        f"({losses[0]!r}), losses 2-3 {losses[1:3]} against {eager_losses[1:]}; "
        f"parameters and Adam moments after 3 steps within {worst:.3e} of a group's "
        f"largest entry; eager launches per step {eager_step} (its loop stops a chunk "
        f"once its rays are dead; the captured step runs every bounce step); {smi}")
    say("train", "losses " + " ".join(f"{x:.4e}" for x in losses))

    # the same steps without checkpointing, captured too: what remat saves and
    # costs
    plain_cfg = dataclasses.replace(cfg, remat=False)
    init_plain, step_plain = make_train_step(
        None, plain_cfg, scene, optimizer=adam("kd", "lights_rgb"), device=dev)
    _, losses_p, times_p, counts_p, peak_p = timed_steps(
        step_plain, init_plain(start), scene_d, coords, target, 3)
    if step_plain.plan is None or step_plain.plan.replays != 2:
        raise AssertionError("training, remat=False: the step was not captured")
    for name in ("nearest_hit", "nearest_dist"):
        if counts_p[-1][name] != per_step[name]:
            raise AssertionError(f"remat launched {name} {per_step[name]} times a "
                                 f"step, {counts_p[-1][name]} without it: a sweep ran "
                                 "again in the backward pass")
    if not np.allclose(losses_p, losses[:3], rtol=GRAD_RTOL):
        raise AssertionError(f"remat=False losses {losses_p} differ from {losses[:3]}")
    say("train", f"remat=False, captured, 3 steps: {[round(t, 1) for t in times_p]} ms "
        f"(capture {step_plain.plan.capture_ms:.1f} ms, "
        f"{step_plain.plan.held_bytes / 2**20:.1f} MiB), peak {peak_p / 2**20:.1f} MiB, "
        f"launches per step {counts_p[-1]}; remat=True: {[round(t, 1) for t in tg[:3]]} ms, "
        f"peak {peak_capture / 2**20:.1f} MiB; replayed-step ratio remat/plain "
        f"{tg[2] / times_p[2]:.3f}, peak memory {peak_capture / peak_p:.3f}")

    # the vertices and the field of view free too (the pack rebuilt from
    # moving vertices, the camera's tangent on the device): two steps, the
    # second a replay
    free_too = ("vertices", "cam_fov")
    init_v, step_v = make_train_step(
        None, cfg, scene, optimizer=adam("kd", "lights_rgb", *free_too), device=dev)
    state_v = init_v(start)
    _, loss_v, times_v, _, _ = timed_steps(step_v, state_v, scene_d, coords, target, 2)
    moved = {k: float((state_v.params[k].detach().cpu() - start[k]).abs().sum())
             for k in free_too}
    if (not all(np.isfinite(loss_v)) or not all(m > 0.0 for m in moved.values())
            or step_v.plan.last_call != "replay"):
        raise AssertionError(f"training with {free_too} free: losses {loss_v}, moved "
                             f"by {moved}, last call {step_v.plan.last_call}")
    say("train", f"vertices and cam_fov free too, captured: losses {loss_v[0]:.4e}, "
        f"{loss_v[1]:.4e}; moved in all by {moved}; steps "
        f"{[round(t, 1) for t in times_v]} ms (the first with its capture)")

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
        f"({path.rsplit('/', 1)[-1]}): parameters and Adam moments bit-equal, on the "
        "card")

    if want_profile:
        profile_call(lambda: step_fn(state, scene_d, coords, target),
                     f"training step, spheres {size}x{size}, remat=True, captured "
                     "(one replay)")
        eager_state = init_eager(start)
        step_eager(eager_state, scene_d, coords, target)
        profile_call(lambda: step_eager(eager_state, scene_d, coords, target),
                     f"training step, spheres {size}x{size}, remat=True, eager")
    return per_step


def check_capturable_adam(dev):
    """Capturable Adam in a captured step (every group free, 32x32) moves
    each group as optax's adam would on the same gradients, step by step:
    the first step eager, the next two replays of the graph."""
    f = np.float32
    scene = make_sphere_scene(32, 32, **SPHERES)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda", ray_chunk=1024,
                       diff_max_depth=2)
    init_state, step_fn = make_train_step(None, cfg, scene, learning_rate=1e-2, device=dev)
    state = init_state(extract_params(scene))
    if not all(p.requires_grad for p in state.params.values()):
        raise AssertionError("the default optimizer does not hold every group")
    coords = camera_ops.cpu_subpixel_coords_traced(32, 32, torch.arange(32 * 32 * 4,
                                                                         device=dev))
    target = torch.zeros((32 * 32, 3), device=dev)
    m = {k: np.zeros(tuple(p.shape), f) for k, p in state.params.items()}
    v = {k: np.zeros(tuple(p.shape), f) for k, p in state.params.items()}
    worst = 0.0
    for t in range(1, 4):
        before = {k: p.detach().cpu().numpy().copy() for k, p in state.params.items()}
        step_fn(state, scene, coords, target)
        for k in PARAM_KEYS:
            g = state.params[k].grad.cpu().numpy()
            m[k] = f(0.9) * m[k] + f(1 - 0.9) * g
            v[k] = f(0.999) * v[k] + f(1 - 0.999) * g * g
            upd = f(-1e-2) * (m[k] / f(1 - 0.9 ** t)) / (
                np.sqrt(v[k] / f(1 - 0.999 ** t)) + f(1e-8))
            got = state.params[k].detach().cpu().numpy()
            if not np.allclose(got, before[k] + upd, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"capturable Adam: {k} at step {t} off by "
                                     f"{np.abs(got - before[k] - upd).max():.3e}")
            worst = max(worst, float(np.abs(got - before[k] - upd).max()))
    plan = step_fn.plan
    if plan.last_call != "replay" or plan.captures != 1:
        raise AssertionError("capturable Adam: the steps were not replayed")
    # a state restored from a checkpoint holds other optimizer tensors: the
    # step captures again, and goes on as the saved state does
    with tempfile.TemporaryDirectory() as tmp:
        save_train_state(tmp, state)
        restored, _ = resume_or_init(tmp, init_state(extract_params(scene)))
    again = [float(step_fn(st, scene, coords, target)[1]) for st in (restored, state)]
    if plan.captures != 3 or again[0] != again[1]:
        raise AssertionError(f"capturable Adam: {plan.captures} captures, the restored "
                             f"state's next loss {again[0]!r}, the saved state's {again[1]!r}")
    say("train", f"capturable Adam (the default optimizer on the card) in a captured "
        f"step, all 13 groups free, spheres 32x32: 3 steps equal to optax's adam update "
        f"of the same gradients within rtol 1e-5 / atol 1e-7 (largest |d| {worst:.3e}); "
        "steps 2-3 replays; a state restored from its checkpoint captures again and "
        "its next loss equals the saved state's")

    # the blurred loss (the whole image's residual, one backward pass)
    # captured too: against the eager step
    blur = []
    for plan_arg in (None, False):
        init_b, step_b = make_train_step(None, cfg, scene, optimizer=adam("kd"),
                                         loss_blur=1.0, device=dev, plan=plan_arg)
        st = init_b(extract_params(scene))
        blur.append([float(step_b(st, scene, coords, target)[1]) for _ in range(2)])
        if plan_arg is None and step_b.plan.last_call != "replay":
            raise AssertionError("loss_blur: the step was not replayed")
    if blur[0][0] != blur[1][0] or not np.allclose(blur[0], blur[1], rtol=GRAD_RTOL):
        raise AssertionError(f"loss_blur: captured losses {blur[0]}, eager {blur[1]}")
    say("train", f"loss_blur=1.0, spheres 32x32, captured: losses {blur[0]} against "
        f"eager {blur[1]} (step 1 bit-equal, step 2 a replay)")


def check_device_tanf(dev):
    """`ops.camera.tanf` on the card bit-equal to the host's libm `tanf`
    over 20,001 fields of view from 1 to 179 degrees and every float32
    within 20,000 ulps of the kernel's and the reduction's thresholds."""
    fov = np.linspace(1.0, 179.0, 20001).astype(np.float32)
    edges = [np.float32(x).view(np.int32) for x in (np.pi / 4, 0.6744, np.pi / 2)]
    x = np.concatenate([fov * np.float32(np.pi / 360.0)] + [
        np.arange(e - 20000, e + 20000, dtype=np.int32).view(np.float32) for e in edges])
    libm = camera_ops._libm_tanf()
    want = np.array([libm(float(a)) for a in x], np.float32)
    got = camera_ops.tanf(torch.from_numpy(x).to(dev)).cpu().numpy()
    n_diff = int((got.view(np.int32) != want.view(np.int32)).sum())
    if n_diff:
        raise AssertionError(f"tanf on the card: {n_diff} of {x.size} values differ "
                             "from libm's")
    say("train", f"tanf on the card bit-equal to the host libm's tanf on {x.size} "
        "values (20,001 fields of view, 1-179 degrees; 120,000 floats around pi/4, "
        "0.6744 and pi/2)")


def check_parked_chunk(pack):
    """K1, K2, K3 and K3's backward on one chunk of rays that are all
    parked (origin PARKED, direction 0), as every bounce step after the
    last live one is in a captured training step: culling keeps no pair
    tile, both sweeps miss on every ray, bit-equal to their plain versions,
    and the fetch and its gradient match the plain ones."""
    n = RenderConfig().ray_chunk
    dev = pack.v0.device
    rays = (torch.full((n, 3), PARKED, device=dev), torch.zeros((n, 3), device=dev))
    args = sweep_args(rays, pack)
    if int(args[5].sum()):
        raise AssertionError(f"parked rays: culling kept {int(args[5].sum())} pair tiles")
    for name, (kern, plain) in SWEEPS.items():
        got = require_sweep_equal(name, kern(*args, pack.unit_aabb), plain(*args),
                                  "all parked")[0]
        if bool(torch.isfinite(got).any()):
            raise AssertionError(f"{name}: a parked ray hit something")
    idx = ck.nearest_hit(*args, pack.unit_aabb)[1]
    check_fetch_gradient(pack, idx, "all parked, every row into slot 0")
    say("kernels", f"all-parked chunk ({n} rays): no pair tile kept; nearest_hit and "
        "nearest_dist miss on every ray, bit-equal to their plain versions; the fetch "
        "and its gradient as the plain ones")


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
    check_parked_chunk(sph_pack)
    check_gradient_against_plain(dev)
    check_device_tanf(dev)
    check_capturable_adam(dev)
    return check_training(dev, smi, want_profile)


# ---------------------------------------------------------------------------
# render_image through its plan: forward and backward as captured CUDA
# graphs, the no-grad while-loop frame through the frame program
# ---------------------------------------------------------------------------

IMAGE = dict(size=256, depth=6, gpu_size=64, gpu_aliasing=2, gpu_max_bounce=2)


def image_params(scene, seed, dev):
    """All 13 groups on the card, requiring grad: the scene's own (seed 0),
    or with `kd` and `lights_rgb` moved (`perturbed_params`) and the
    vertices by up to 1e-3, from the seed."""
    params = extract_params(scene)
    if seed:
        params = perturbed_params(scene, seed)
        v = params["vertices"]
        noise = np.random.default_rng(seed).uniform(-1e-3, 1e-3, tuple(v.shape))
        params["vertices"] = v + torch.from_numpy(noise.astype(np.float32))
    return {k: v.detach().to(dev).requires_grad_() for k, v in params.items()}


def image_call(scene_d, params, cfg, plan, views=(None,)):
    """One synchronised `render_image` call per view of `params` (leaves on
    the card; a view maps them to its own, None keeps them) and one
    backward pass of the sum of the images' means: (the images stacked,
    {group: gradient}, host ms, kernel launches, host syncs counted in the
    call)."""
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with capture.counted_syncs() as synced:
        imgs = [render_image(insert_params(scene_d, view(params) if view else params),
                             cfg, device=scene_d.device, plan=plan) for view in views]
        sum(img.mean() for img in imgs).backward()
    torch.cuda.synchronize()
    return (torch.stack([img.detach() for img in imgs]),
            {k: v.grad for k, v in params.items()},
            (time.perf_counter() - t0) * 1e3, dict(ck.LAUNCHES), synced.n)


def require_close_grads(got, want, what):
    """Every group within rtol 1e-3 / atol 1e-4 of its largest entry;
    returns the largest |d| over that entry."""
    worst = 0.0
    for k in PARAM_KEYS:
        g, w = got[k], want[k]
        scale = float(w.abs().max())
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: the gradient of {k} is not finite")
        if not torch.allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale):
            raise AssertionError(f"{what}: the gradient of {k} off by "
                                 f"{float((g - w).abs().max()):.3e} of {scale:.3e}")
        worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
    return worst


def image_cell(dev):
    """The 256x256 cell: (scene, the scene on the card, config)."""
    size = IMAGE["size"]
    scene = make_sphere_scene(size, size, **SPHERES)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda",
                       ray_chunk=TRAIN["ray_chunk"], diff_max_depth=IMAGE["depth"],
                       remat=True)
    return scene, scene.to(dev), cfg


def check_image_grad(dev, smi, want_profile, cell):
    """The 256x256 cell with all 13 groups requiring grad: the captured call
    (first a capture, then replays) and the eager one (`plan=False`) in
    turns, each turn with new parameter values: images bit-equal, gradients
    within the tolerance, two graph replays and no host sync per replayed
    call. With `want_profile` one captured and one eager call are traced.
    Returns the launches of one replayed call and the eager calls."""
    size, depth = IMAGE["size"], IMAGE["depth"]
    scene, scene_d, cfg = cell
    n_chunks = size * size * 4 // TRAIN["ray_chunk"]
    addr = cached_block(dev)
    runs = {"graph": [], "eager": []}
    # graph, eager, eager, graph, graph, eager: the graph's first call captures
    for turn, order in enumerate((("graph", "eager"), ("eager", "graph"),
                                  ("graph", "eager"))):
        params = image_params(scene, turn, dev)
        for which in order:
            p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
            runs[which].append(image_call(scene_d, p, cfg,
                                          None if which == "graph" else False))
            if which == "graph" and len(runs["graph"]) == 1:
                require_still_reserved(addr, "render_image capture")
    plans = image_graph.image_plans()
    plan = plans[-1]
    if (plan.captures, plan.replays, plan.backward_replays, plan.last_call) != (
            1, 2, 3, "replay") or plan.frame_program or not plan.grad:
        raise AssertionError(f"render_image 256x256: {plan.captures} captures, "
                             f"{plan.replays} forward and {plan.backward_replays} "
                             f"backward replays, last call {plan.last_call!r}")
    worst = 0.0
    for turn, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        if not torch.equal(g[0], e[0]):
            raise AssertionError(f"render_image 256x256, turn {turn}: the captured "
                                 f"image is not bit-equal to the eager one "
                                 f"({int((g[0] != e[0]).any(-1).sum())} pixels differ)")
        worst = max(worst, require_close_grads(g[1], e[1], f"render_image 256x256, "
                                               f"turn {turn}"))
    check_image(runs["graph"][0][0][0], size, size)
    for k in ("vertices", "normals", "kd", "lights_rgb", "cam_fov"):
        if not bool(runs["graph"][-1][1][k].any()):
            raise AssertionError(f"render_image 256x256: the gradient of {k} is all zero")
    per_call = runs["graph"][-1][3]
    sweeps = n_chunks * depth
    want = {"nearest_hit": sweeps, "nearest_dist": sweeps, "fetch_rows": 2 * sweeps}
    if any(r[3] != per_call for r in runs["graph"][1:]) or any(
            per_call[k] != n for k, n in want.items()):
        raise AssertionError(f"render_image 256x256: launches per replayed call "
                             f"{[r[3] for r in runs['graph']]}, expected {want}")
    syncs = [r[4] for r in runs["graph"][1:]]
    if any(syncs):
        raise AssertionError(f"render_image 256x256: host syncs {syncs} counted in the "
                             "replayed calls")
    eager_counts = runs["eager"][-1][3]
    tg = [r[2] for r in runs["graph"]]
    te = [r[2] for r in runs["eager"]]
    ms, ms_e = float(np.median(tg[1:])), float(np.median(te))
    warm = {k: n for k, n in plan.slots[0].warmup_launches.items() if n}
    say("image", f"render_image, spheres {size}x{size} ({scene.n_triangles} tris, "
        f"{n_chunks} chunks, depth {depth}), cuda, remat=True, all 13 groups "
        f"requiring grad, mean(image).backward(): 3 captured calls (the first the "
        f"capture) in turns with 3 eager calls (plan=False), new parameters each turn: "
        f"images bit-equal, gradients within {worst:.3e} of a group's largest entry; "
        f"ms per forward+backward graph {[round(t, 1) for t in tg]}, eager "
        f"{[round(t, 1) for t in te]}: graph {ms:.1f} (replays), eager {ms_e:.1f}, "
        f"eager/graph {ms_e / ms:.2f}x; capture {plan.capture_ms:.1f} ms (of which the "
        f"warm-up forward and backward {plan.warmup_ms:.1f} ms), the card reserving "
        f"{plan.held_bytes / 2**20:.1f} MiB for the buffers and the graphs' pool (the "
        f"image's whole autograd graph), a block cached before still reserved; "
        f"{plan.captures} capture, {plan.replays} forward and {plan.backward_replays} "
        f"backward replays: 2 graph launches per replayed call; host syncs counted in "
        f"the replayed calls {syncs}, in the capturing call {runs['graph'][0][4]}, in "
        f"the eager calls {[r[4] for r in runs['eager']]}; kernel launches per replayed "
        f"call {per_call} (forward graph {plan.slots[0].forward_launches}, backward graph "
        f"{plan.slots[0].backward_launches}, warm-up {warm}), eager {eager_counts}; {smi}")
    if want_profile:
        params = image_params(scene, 4, dev)
        for plan_arg, what, unprofiled in ((None, "captured (a forward and a backward "
                                            "replay)", ms), (False, "eager", ms_e)):
            profile_call(lambda: render_image(insert_params(scene_d, params), cfg,
                                              device=dev, plan=plan_arg).mean().backward(),
                         f"render_image {size}x{size}, remat=True, all 13 groups, "
                         f"forward + backward, {what}", unprofiled)

    return per_call, runs["eager"]


# the second view of the 256x256 cell: the camera moved and turned, as in
# `moved_scene`
VIEW_B = {"cam_position": 0.05, "cam_u": 0.01}


def view_b(params):
    """The second view's parameters, computed from the first's."""
    return {**params, **{k: params[k] + d for k, d in VIEW_B.items()}}


def busy_slots(plan) -> list:
    return [slot.busy for slot in plan.slots]


def check_image_slots(dev, smi, cell, per_call, eager_runs):
    """Two views of the 256x256 cell through its plan, `(a.mean() +
    b.mean()).backward()`: the captured call (slot 0 replayed, slot 1
    captured, then both replayed) and its eager twin (`plan=False`) in two
    turns: images bit-equal, gradients within the tolerance, four graph
    replays, twice one view's launches and no host sync per replayed call.
    Then the two views' backward passes in reverse order, equal to the
    turn's eager twin, and a 3-step loop (`loss.backward()` per step) that
    captures nothing new, equal to `check_image_grad`'s eager calls."""
    scene, scene_d, cfg = cell
    plan = image_graph.image_plans()[-1]
    before = (plan.captures, plan.replays, plan.backward_replays)
    runs = {"graph": [], "eager": []}
    turns = []
    for turn, order in enumerate((("graph", "eager"), ("eager", "graph"))):
        turns.append(image_params(scene, 10 + turn, dev))
        for which in order:
            p = {k: v.detach().clone().requires_grad_() for k, v in turns[-1].items()}
            runs[which].append(image_call(scene_d, p, cfg,
                                          None if which == "graph" else False,
                                          views=(None, view_b)))
    if image_graph.image_plans()[-1] is not plan or len(plan.slots) != 2:
        raise AssertionError(f"render_image, two views: {len(plan.slots)} slots, not 2")
    counters = (plan.captures - before[0], plan.replays - before[1],
                plan.backward_replays - before[2])
    if counters != (1, 3, 4) or busy_slots(plan) != [False, False]:
        raise AssertionError(f"render_image, two views: captures, forward and backward "
                             f"replays {counters} (expected (1, 3, 4)), slots busy "
                             f"{busy_slots(plan)}")
    worst = 0.0
    for turn, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        if not torch.equal(g[0], e[0]) or torch.equal(g[0][0], g[0][1]):
            raise AssertionError(f"render_image, two views, turn {turn}: the captured "
                                 "images are not bit-equal to the eager ones, or the "
                                 "views are equal")
        worst = max(worst, require_close_grads(g[1], e[1], f"render_image, two views, "
                                               f"turn {turn}"))
    replayed = runs["graph"][1]
    if replayed[3] != {k: 2 * n for k, n in per_call.items()} or replayed[4]:
        raise AssertionError(f"render_image, two views: launches {replayed[3]} (one view "
                             f"{per_call}), {replayed[4]} host syncs in the replayed call")
    second = plan.slots[1]

    # the reverse order: forward a, forward b, backward b, backward a
    p = {k: v.detach().clone().requires_grad_() for k, v in turns[1].items()}
    images = [render_image(insert_params(scene_d, q), cfg, device=dev)
              for q in (p, view_b(p))]
    order = [busy_slots(plan)]
    for img in reversed(images):
        img.mean().backward()
        order.append(busy_slots(plan))
    if order != [[True, True], [True, False], [False, False]]:
        raise AssertionError(f"render_image, reverse order: slots busy {order}")
    if not torch.equal(torch.stack([i.detach() for i in images]), runs["eager"][1][0]):
        raise AssertionError("render_image, reverse order: images not bit-equal")
    reverse = require_close_grads({k: v.grad for k, v in p.items()}, runs["eager"][1][1],
                                  "render_image, two views, backward in reverse order")

    # a training loop: one slot, nothing captured
    loop_ms, loop_worst = [], 0.0
    for step, (_, want, *_) in enumerate(eager_runs):
        p = image_params(scene, step, dev)
        _, ms = wall_ms(lambda: render_image(insert_params(scene_d, p), cfg,
                                             device=dev).mean().backward())
        loop_ms.append(ms)
        loop_worst = max(loop_worst, require_close_grads(
            {k: v.grad for k, v in p.items()}, want, f"render_image loop, step {step}"))
        if busy_slots(plan) != [False, False]:
            raise AssertionError(f"render_image loop, step {step}: slots busy "
                                 f"{busy_slots(plan)}")
    if plan.captures != before[0] + 1 or len(plan.slots) != 2:
        raise AssertionError(f"render_image loop: {plan.captures} captures, "
                             f"{len(plan.slots)} slots")
    tg = [r[2] for r in runs["graph"]]
    te = [r[2] for r in runs["eager"]]
    say("image", f"render_image, two views of the 256x256 cell (the camera moved "
        f"{VIEW_B['cam_position']} and turned), one plan, (a.mean() + "
        f"b.mean()).backward(): captured calls in turns with their eager twins "
        f"(plan=False), new parameters each turn: images bit-equal, gradients within "
        f"{worst:.3e} of a group's largest entry; {len(plan.slots)} slots; the second "
        f"slot's capture {second.capture_ms:.1f} ms (warm-up {second.warmup_ms:.1f} ms), "
        f"{second.held_bytes / 2**20:.1f} MiB (slot 0 "
        f"{plan.slots[0].held_bytes / 2**20:.1f} MiB, the plan "
        f"{plan.held_bytes / 2**20:.1f} MiB); ms per two-view call graph "
        f"{[round(t, 1) for t in tg]} (the first captures slot 1), eager "
        f"{[round(t, 1) for t in te]}: replayed {tg[1]:.1f} against eager "
        f"{float(np.mean(te)):.1f}; 4 graph replays and {replayed[4]} host syncs "
        f"counted in the replayed call (capturing call {runs['graph'][0][4]}, eager "
        f"{[r[4] for r in runs['eager']]}); kernel launches per replayed call "
        f"{replayed[3]}, eager {runs['eager'][-1][3]}; {smi}")
    say("image", f"the two views' backward passes in reverse order: slots busy "
        f"{order}, images bit-equal and gradients within {reverse:.3e} of the eager "
        f"twin's; a {len(loop_ms)}-step loop (render_image(...).mean().backward()): "
        f"nothing captured (the plan's captures stay {plan.captures}, its slots "
        f"{len(plan.slots)}), "
        f"gradients within {loop_worst:.3e} of the eager calls', ms per step "
        f"{[round(t, 1) for t in loop_ms]}")


def check_slots_beyond_max(dev, smi):
    """On the 16x16 plan of `check_gradient_against_plain` (backend "cuda",
    depth 2, leaves on the CPU), `MAX_SLOTS + 1` outstanding images, each
    with the camera moved further: `MAX_SLOTS` slots, the last call eager
    (`eager_calls` 1), the loss (the sum of their means) bit-equal to the
    eager twin's and its gradients within the tolerance."""
    scene = make_sphere_scene(16, 16, **SPHERES)
    cfg = RenderConfig(quantize="smooth", backend="cuda", diff_max_depth=2)
    plan = next((q for q in image_graph.image_plans() if q.cfg == cfg and q.grad), None)
    if plan is None or len(plan.slots) != 1:
        raise AssertionError("render_image: the 16x16 plan of the gradient check is "
                             "not cached with one slot")
    n = image_graph.MAX_SLOTS + 1
    runs = {}
    for which in (None, False):
        p = {k: v.detach().clone().requires_grad_()
             for k, v in extract_params(scene).items()}
        views = [{**p, "cam_position": p["cam_position"] + 0.01 * i} for i in range(n)]

        def call():
            loss = sum(render_image(insert_params(scene, q), cfg, device=dev,
                                    plan=which).mean() for q in views)
            busy = busy_slots(plan)
            loss.backward()
            return loss.detach(), busy

        (loss, busy), ms = wall_ms(call)
        runs[which] = (loss, {k: v.grad.to(dev) for k, v in p.items()}, ms, busy)
    if not torch.equal(runs[None][0], runs[False][0]):
        raise AssertionError("render_image beyond MAX_SLOTS: the loss is not bit-equal "
                             "to the eager twin's")
    worst = require_close_grads(runs[None][1], runs[False][1],
                                "render_image beyond MAX_SLOTS")
    if (len(plan.slots), plan.eager_calls, plan.captures) != (n - 1, 1, n - 1) or (
            runs[None][3] != [True] * (n - 1) or any(busy_slots(plan))):
        raise AssertionError(f"render_image beyond MAX_SLOTS: {len(plan.slots)} slots, "
                             f"{plan.eager_calls} eager calls, {plan.captures} captures, "
                             f"busy {runs[None][3]} then {busy_slots(plan)}")
    new = plan.slots[1:]
    say("image", f"render_image, spheres 16x16, depth 2, {n} outstanding images of one "
        f"plan (MAX_SLOTS {image_graph.MAX_SLOTS}): {len(plan.slots)} slots, "
        f"{plan.eager_calls} call rendered eagerly, the loss bit-equal to the eager "
        f"twin's, gradients within {worst:.3e}; ms {runs[None][2]:.1f} (capturing "
        f"{len(new)} slots: {float(np.mean([s.capture_ms for s in new])):.1f} ms and "
        f"{float(np.mean([s.held_bytes for s in new])) / 2**20:.1f} MiB each), eager "
        f"twin {runs[False][2]:.1f}; {smi}")


def check_image_gpu_mode(dev, smi):
    """GPU mode, 64x64 at aliasing 2 and max_bounce 2, all groups requiring
    grad: a capturing call, an eager one and a replay, images bit-equal and
    gradients within the tolerance (the downscale's uint8 truncation has a
    zero derivative: every group's gradient is exactly zero, as in the
    reference)."""
    n = IMAGE["gpu_size"]
    scene = make_sphere_scene(n, n, **SPHERES)
    scene_d = scene.to(dev)
    cfg = RenderConfig(mode="gpu", quantize="smooth", backend="cuda",
                       aliasing=IMAGE["gpu_aliasing"], max_bounce=IMAGE["gpu_max_bounce"])
    params = image_params(scene, 3, dev)
    runs = [image_call(scene_d, {k: v.detach().clone().requires_grad_()
                                 for k, v in params.items()}, cfg, plan)
            for plan in (None, False, None)]
    plan = image_graph.image_plans()[-1]
    for g in (runs[0], runs[2]):
        if not torch.equal(g[0], runs[1][0]):
            raise AssertionError("render_image, GPU mode: the captured image is not "
                                 "bit-equal to the eager one")
        require_close_grads(g[1], runs[1][1], "render_image, GPU mode")
    zero = all(not bool(runs[2][1][k].any()) for k in PARAM_KEYS)
    if (plan.captures, plan.replays, plan.last_call, runs[2][4]) != (1, 1, "replay", 0):
        raise AssertionError(f"render_image, GPU mode: {plan.captures} captures, "
                             f"{plan.replays} replays, {runs[2][4]} host syncs")
    check_image(runs[2][0][0], n, n)
    say("image", f"render_image, GPU mode, spheres {n}x{n} x{cfg.aliasing}, "
        f"max_bounce {cfg.max_bounce}, all groups requiring grad: captured and "
        f"replayed calls bit-equal to the eager call, gradients within the tolerance "
        f"(all exactly zero: {zero}); ms capture+call {runs[0][2]:.1f}, eager "
        f"{runs[1][2]:.1f}, replay {runs[2][2]:.1f}; launches per replayed call "
        f"{runs[2][3]}, eager {runs[1][3]}; {smi}")


def moved_scene(scene):
    """The camera moved and turned and the vertices shifted by up to 1e-3:
    another kernel pack and another camera basis."""
    cam = dataclasses.replace(scene.camera, position=scene.camera.position + 0.05,
                              u=scene.camera.u + 0.01)
    v = scene.geometry.vertices
    noise = np.random.default_rng(9).uniform(-1e-3, 1e-3, tuple(v.shape))
    geo = dataclasses.replace(scene.geometry, vertices=v + torch.from_numpy(
        noise.astype(np.float32)).to(v.device))
    return dataclasses.replace(scene, camera=cam, geometry=geo)


def check_image_frame_program(renderer, ref_img, smi):
    """The no-grad while-loop strategy: `render_image` of the 512x512 sphere
    scene (CPU mode, match) runs the frame program after its inputs graph,
    bit-equal to `SceneRenderer`'s frame with equal steps per chunk, timed
    beside it in turns; with the camera and the vertices moved before the
    next call, equal to a fresh `SceneRenderer` of the moved scene. Returns
    the launches of one replayed call."""
    cfg, dev = renderer.cfg, renderer.scene.device
    scene_d = renderer.scene

    def call(scene):
        ck.reset_launch_counts()
        frame_graph.reset_launch_counts()
        return wall_ms(lambda: render_image(scene, cfg, device=dev))

    first, first_ms = call(scene_d)
    plan = image_graph.image_plans()[-1]
    if not plan.frame_program or plan.grad or plan._frame.graph is None:
        raise AssertionError("render_image, 512x512 match: not the frame program")
    times, again = {"renderer": [], "image": []}, None
    for which in ("renderer", "image", "image", "renderer"):
        if which == "renderer":
            times[which].append(wall_ms(renderer.render_device)[1])
        else:
            # the frame counts its host syncs while the recorder is on
            with profiling.recording(), capture.counted_syncs() as synced:
                again, ms = call(scene_d)
            times[which].append(ms)
            counts = dict(ck.LAUNCHES)
    f, ref = plan._frame.last_frame, renderer.plan.last_frame
    for img in (first, again):
        if not torch.equal(img, ref_img):
            raise AssertionError("render_image, 512x512 match: not bit-equal to "
                                 "SceneRenderer's frame")
    # the call's one sync is the frame's read of its steps per chunk after
    # its last chunk, as in SceneRenderer.render; none inside the frame
    if f.steps != ref.steps or (f.launches, f.syncs) != (1, 0) or synced.n != 1:
        raise AssertionError(f"render_image, 512x512 match: steps per chunk {f.steps} "
                             f"(SceneRenderer's {ref.steps}), {f.launches} frame graph "
                             f"launches and {f.syncs} syncs, {synced.n} in the call")
    moved = moved_scene(scene_d)
    got, moved_ms = call(moved)
    want = SceneRenderer(moved, cfg, dev).render_device()
    if not torch.equal(got, want) or torch.equal(got, ref_img):
        raise AssertionError("render_image, 512x512 match, camera and vertices moved: "
                             "not bit-equal to a fresh SceneRenderer of the moved scene")
    if plan.replays != 3 or plan.captures != 1:
        raise AssertionError(f"render_image, 512x512 match: {plan.captures} captures, "
                             f"{plan.replays} replays")
    ms_r, ms_i = float(np.mean(times["renderer"])), float(np.mean(times["image"]))
    say("image", f"render_image without grad, spheres 512x512, CPU mode, match (the "
        f"while-loop strategy): the inputs graph (pack and camera basis) and the frame "
        f"graph, bit-equal to SceneRenderer's frame, steps per chunk equal "
        f"({sum(f.steps)} in {len(f.steps)} chunks), 1 frame graph launch and 0 syncs "
        f"in the frame, {synced.n} host sync counted in the call (the read of the "
        f"steps per chunk after the frame); with the camera and "
        f"the vertices moved, bit-equal to a fresh SceneRenderer's frame; ms per call "
        f"in turns renderer {times['renderer'][0]:.1f}, image "
        f"{times['image'][0]:.1f}, {times['image'][1]:.1f}, renderer "
        f"{times['renderer'][1]:.1f}: render_image {ms_i:.1f}, SceneRenderer "
        f"{ms_r:.1f}, difference {ms_i - ms_r:+.2f} ms; the capturing call "
        f"{first_ms:.1f} ms (capture {plan.capture_ms:.1f} ms, "
        f"{plan.held_bytes / 2**20:.1f} MiB), the moved call {moved_ms:.1f} ms; "
        f"launches per call {counts}; {smi}")
    return counts


def run_image_phase(dev, smi, renderer, ref_img, want_profile):
    """The `[image]` phase: returns the kernel launches of one replayed
    forward+backward call at 256x256."""
    t0 = time.perf_counter()
    check_slots_beyond_max(dev, smi)
    image_graph.clear_image_plans()
    cell = image_cell(dev)
    launches, eager_runs = check_image_grad(dev, smi, want_profile, cell)
    check_image_slots(dev, smi, cell, launches, eager_runs)
    check_image_gpu_mode(dev, smi)
    check_image_frame_program(renderer, ref_img, smi)
    image_graph.clear_image_plans()
    say("image", f"phase took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The file entry: .svati through the native parser, render(), the writers,
# the CLI with --profile, inspect
# ---------------------------------------------------------------------------

LIGHT_KEYWORDS = ("a_light", "d_light", "p_light")  # AMBIENT, DIRECTIONAL, POINT


def svati_text(scene) -> str:
    """A scene of CPU tensors as `.svati` text that parses back to it leaf
    for leaf: every float as %.9g (exact for float32), each object's
    materials before its vertices, and its valid triangles written in
    reverse order with their vertices (and normals) as c, b, a, which undoes
    the parser's LIFO rebuild. Objects must own a triangle."""
    def nums(values) -> str:
        return " ".join("%.9g" % x for x in values)

    cam, lights, geo, mat = scene.camera, scene.lights, scene.geometry, scene.materials
    lines = [f"camera {cam.width} {cam.height} " + nums(
        [*cam.position.tolist(), *cam.u.tolist(), *cam.v.tolist(), float(cam.fov)])]
    for kind, rgb, v in zip(lights.kind, lights.rgb.tolist(), lights.v.tolist()):
        lines.append(f"{LIGHT_KEYWORDS[kind]} " + nums(rgb if kind == 0 else rgb + v))
    owner = torch.where(geo.valid, geo.tri_obj, -1)
    for i in range(scene.n_objects):
        tris = torch.nonzero(owner == i).flatten().flip(0)
        if not len(tris):
            raise ValueError(f"object {i} owns no triangle")
        lines.append(f"object {3 * len(tris)}")
        lines += [f"{key} {nums(getattr(mat, key.lower())[i].reshape(-1).tolist())}"
                  for key in ("Ka", "Kd", "Ks", "Ns", "Ni", "Nr", "d")]
        for key, table in (("v", geo.vertices), ("vn", geo.normals)):
            lines += [f"{key} {nums(p)}" for p in table[tris].flip(1).reshape(-1, 3).tolist()]
    return "\n".join(lines) + "\n"


def require_same_scene(got, want, what):
    """Every leaf of two scenes equal (tensors bit for bit)."""
    def leaves(scene):
        for part in ("camera", "lights", "geometry", "materials"):
            obj = getattr(scene, part)
            for f in dataclasses.fields(obj):
                yield f"{part}.{f.name}", getattr(obj, f.name)
        yield "n_triangles", scene.n_triangles
        yield "n_objects", scene.n_objects

    for (name, a), (_, b) in zip(leaves(got), leaves(want), strict=True):
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                and isinstance(b, torch.Tensor) else a == b)
        if not same:
            raise AssertionError(f"{what}: {name} differs")


def trace_kernels(trace_dir) -> dict:
    """{kernel name: device events} of the one torch.profiler Chrome trace in
    `trace_dir` (`trace.*.json`; the program recorder's is `program.*.json`)."""
    files = [f for f in os.listdir(trace_dir)
             if f.startswith("trace.") and f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"expected one torch.profiler trace in {trace_dir}, "
                             f"found {os.listdir(trace_dir)}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def check_entry(scene, cfg, renderer, ref_img, dev, kind, smi):
    """The sphere frame through the file entry points, from a `.svati` file
    written from `scene`: the native parser (built with native="force")
    against the Python parser and the scene itself, leaf for leaf;
    `render(path, out.ppm)` byte-equal to `ppm_bytes` of `ref_img`
    (SceneRenderer's frame of the same scene and config) with its launches
    counted (one frame and the capture's warm-up); the native PNG writer against the Python writer; the CLI
    in-process with --unroll static --profile DIR --time; inspect --octree
    --memory. Returns the launches of the render() call."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spheres.svati")
        with open(path, "w") as f:
            f.write(svati_text(scene))
        t0 = time.perf_counter()
        native_lib.library("force")
        say("entry", f"native library {native_build.library_path()} ready in "
            f"{time.perf_counter() - t0:.2f} s (g++ -O2, -lz; native=\"force\")")
        t0 = time.perf_counter()
        nat = parse_scene(path, native="force")
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = parse_scene(path, native="never")
        t_py = time.perf_counter() - t0
        require_same_scene(nat, py, "native parse against the Python parse")
        require_same_scene(nat, scene, "native parse against make_sphere_scene")
        say("entry", f"{os.path.getsize(path)} bytes of .svati, {nat.n_objects} objects, "
            f"{nat.n_triangles} triangles: native parse {t_nat * 1e3:.1f} ms, Python "
            f"parse {t_py * 1e3:.1f} ms, equal leaf for leaf to each other and to "
            "make_sphere_scene's tensors")

        # set-up: the scene to the card, the kernel pack and the frame's capture
        setup, setup_ms = wall_ms(lambda: SceneRenderer(nat, cfg, dev))
        ppm = os.path.join(tmp, "out.ppm")
        ck.reset_launch_counts()
        frame_graph.reset_launch_counts()
        _, entry_ms = wall_ms(lambda: render(path, ppm, cfg, device=dev))
        counts, loops = dict(ck.LAUNCHES), dict(frame_graph.LAUNCHES)
        f = renderer.plan.last_frame
        want_loops = {"loop_reset": renderer.plan.n_chunks, "bounce_condition": sum(f.steps),
                      "chunk_advance": renderer.plan.n_chunks}
        if loops != want_loops:
            raise AssertionError(f"render(): condition kernels launched {loops}, one "
                                 f"frame graph launches {want_loops}")
        frame = ref_img.cpu().numpy()
        if open(ppm, "rb").read() != ppm_bytes(frame):
            raise AssertionError("render(): the PPM differs from ppm_bytes of "
                                 "SceneRenderer's frame")
        for name in ("nearest_hit", "nearest_dist", "fetch_rows"):
            if counts[name] <= 0:
                raise AssertionError(f"render() never launched {name}")
        u8_frame = np.trunc(frame).astype(np.uint8)
        times = {}
        for fmt, write, img in (("ppm", write_ppm, frame), ("png", write_png, u8_frame)):
            for native in ("force", "never"):
                out = os.path.join(tmp, f"{native}.{fmt}")
                t0 = time.perf_counter()
                write(out, img, native=native)
                times[fmt, native] = (time.perf_counter() - t0) * 1e3
        for fmt in ("ppm", "png"):
            a, b = (open(os.path.join(tmp, f"{n}.{fmt}"), "rb").read()
                    for n in ("force", "never"))
            if a != b:
                raise AssertionError(f"the native {fmt} writer's bytes differ from "
                                     "the Python writer's")
        png = open(os.path.join(tmp, "never.png"), "rb").read()
        frame_ms = float(np.median(time_frames(renderer, 1)[1]))
        say("entry", f"render(.svati -> .ppm), spheres 512x512, cuda: byte-equal to "
            f"ppm_bytes of SceneRenderer's frame; launches {counts}, condition kernels "
            f"{loops} (one frame graph launch); {entry_ms:.1f} ms "
            f"for the call (SceneRenderer set-up alone {setup_ms:.1f} ms, of which the "
            f"frame's warm-up, capture and assembly {setup.plan.capture_ms:.1f} ms; one graph "
            f"frame beside it {frame_ms:.1f} ms); writers native / Python: PPM "
            f"{times['ppm', 'force']:.1f} / {times['ppm', 'never']:.1f} ms, PNG "
            f"{times['png', 'force']:.1f} / {times['png', 'never']:.1f} ms "
            f"({len(png)} bytes), byte-identical; {smi}")

        # the command line in-process, traced
        cli_png, trace_dir = os.path.join(tmp, "cli.png"), os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        rc = cli_main([path, cli_png, "--unroll", "static", "--profile", trace_dir,
                       "--time"])
        cli_s = time.perf_counter() - t0
        if rc != 0 or open(cli_png, "rb").read() != png:
            raise AssertionError(f"CLI --profile: exit {rc}, or its PNG differs")
        kernels = trace_kernels(trace_dir)
        ours = {t: sum(n for k, n in kernels.items() if own_kernel(k) == t)
                for t in ("sweep_kernel<NEAREST_HIT>", "sweep_kernel<NEAREST_DIST>",
                          "fetch_rows_kernel", "tile_cull_kernel")}
        if not all(ours.values()):
            raise AssertionError(f"the CLI's trace lacks the port's kernels: {ours}")
        program = [f for f in os.listdir(trace_dir) if f.startswith("program.")]
        with open(os.path.join(trace_dir, program[0])) as f:
            recorded = json.load(f)
        spans = {}
        for e in recorded["traceEvents"]:
            if e.get("cat") == "device":
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        if not spans.get("sweep") or recorded["otherData"]["dropped"]:
            raise AssertionError(f"the CLI's program trace: device spans {spans}, "
                                 f"{recorded['otherData']['dropped']} stamps dropped")
        say("entry", f"CLI --unroll static --profile --time: exit 0, PNG equal, "
            f"{cli_s:.2f} s; its trace holds {sum(kernels.values())} device kernels, "
            f"the port's {ours}; the program's trace device spans {spans}, "
            f"counters {recorded['otherData']['counters']}")

        # inspect
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = inspect_main([path, "--octree", "--memory"])
        lines = buf.getvalue().splitlines()
        memory = [ln for ln in lines if ln.startswith("cuda:")]
        if rc != 0 or not memory or kind not in memory[0] or not any(
                ln.startswith("octree: ") for ln in lines):
            raise AssertionError("inspect: " + "\n".join(lines[:8]))
        say("entry", f"inspect --octree --memory: exit 0, {len(lines)} lines; "
            + " | ".join(lines[:1] + memory + [ln for ln in lines if ln.startswith("octree")]))
    return counts


# ---------------------------------------------------------------------------
# Sharding: world size 1 through the sharded entry points, and two gloo
# ranks sharing the card
# ---------------------------------------------------------------------------

SHARD_SIZE = 128  # the frame the two gloo ranks render
SHARD_MESHES = ((2, 1), (1, 2))
# gradients on the card are sums of atomics (`index_add_`): two runs of the
# same step differ by a few 1e-6 of a group's largest entry
SHARD_GRAD_ATOL_SHARE = 1e-5


def check_shard_frame(scene, cfg, renderer, ref_img, smi, want_profile):
    """World size 1 through `make_sharded_renderer` (the code under
    `render_scene_sharded`) on the sphere frame: bit-equal to
    `SceneRenderer`'s frame, launches counted, both timed in turns (and
    traced under --profile). Returns the launches of one sharded frame."""
    mesh = make_mesh(1, 1)
    frame_scene, depth, coords = frame_inputs(scene.to(ref_img.device), cfg)
    geo, rest = split_scene(frame_scene)
    render = make_sharded_renderer(mesh, cfg, depth, renderer.width, renderer.height,
                                   device=ref_img.device)

    def frame():
        with torch.no_grad():
            return render(geo, rest, coords)

    ck.reset_launch_counts()
    img = frame()
    torch.cuda.synchronize()
    counts = dict(ck.LAUNCHES)
    for name in ("nearest_hit", "nearest_dist", "fetch_rows"):
        if counts[name] <= 0:
            raise AssertionError(f"the sharded frame never launched {name}")
    if not torch.equal(img, ref_img):
        raise AssertionError("world size 1: the sharded frame is not bit-equal to "
                             "SceneRenderer's")
    check_image(img, renderer.width, renderer.height)
    if not torch.equal(render_scene_sharded(scene, cfg, mesh, to_host=False,
                                            device=ref_img.device), ref_img):
        raise AssertionError("world size 1: render_scene_sharded is not bit-equal to "
                             "SceneRenderer's frame")
    plain, sharded = [], []
    for fn, times in ((renderer.render_device, plain), (frame, sharded),
                      (frame, sharded), (renderer.render_device, plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    say("shard", f"world size 1, spheres {renderer.width}x{renderer.height}, cuda: "
        "render_scene_sharded and make_sharded_renderer bit-equal to SceneRenderer's "
        f"frame; launches in one sharded frame {counts}; ms/frame in turns: sharded "
        f"(eager) {[round(t, 3) for t in sharded]}, SceneRenderer (graph frame) "
        f"{[round(t, 3) for t in plain]}, "
        f"median ratio {np.median(sharded) / np.median(plain):.3f}; {smi}")
    if want_profile:
        profile_call(frame, f"world size 1, sharded frame, spheres {renderer.width}x"
                     f"{renderer.height}")
    return counts


def check_shard_train_step(dev, smi):
    """One step of the 256x256 training cell through a (1, 1) mesh and the
    five-argument step_fn, against the one-device step from the same start:
    the same loss, and the gradients of all 13 groups within
    SHARD_GRAD_ATOL_SHARE of each group's largest entry."""
    size = TRAIN["size"]
    scene = make_sphere_scene(size, size, **SPHERES)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda",
                       ray_chunk=TRAIN["ray_chunk"], diff_max_depth=TRAIN["depth"],
                       remat=True)
    coords = camera_ops.cpu_subpixel_coords_traced(
        size, size, torch.arange(size * size * 4, device=dev))
    with torch.no_grad():
        target = predict_pixels(scene, cfg, TRAIN["depth"], coords, device=dev)
    start = perturbed_params(scene)

    def every_group(p):  # rate 0: the step leaves the gradients and moves nothing
        return torch.optim.SGD(list(p.values()), lr=0.0)

    init1, step1 = make_train_step(None, cfg, scene, optimizer=every_group, device=dev)
    one, loss1 = step1(init1(start), scene.to(dev), coords, target)
    init_s, step_s = make_train_step(make_mesh(1, 1), cfg, scene, optimizer=every_group,
                                     device=dev)
    geo, rest = split_scene(scene)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sharded, loss_s = step_s(init_s(start), geo, rest, coords, target)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(ck.LAUNCHES)
    if float(loss_s) != float(loss1):
        raise AssertionError(f"sharded step loss {float(loss_s)!r} != one-device "
                             f"{float(loss1)!r}")
    worst = 0.0
    for k in PARAM_KEYS:
        a, b = sharded.params[k].grad, one.params[k].grad
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max()) / scale
        if not torch.allclose(a, b, rtol=1e-5, atol=SHARD_GRAD_ATOL_SHARE * scale):
            raise AssertionError(f"sharded step: gradient of {k} off by {err:.3e} of "
                                 "its largest entry")
        worst = max(worst, err)
    say("shard", f"world size 1, training step spheres {size}x{size} through a (1,1) "
        f"mesh: loss {float(loss_s):.6e} equal to the one-device step's; 13 groups' "
        f"gradients within {worst:.3e} of a group's largest entry; {ms:.1f} ms; "
        f"launches {counts}; {smi}")


def shard_rank_main(argv) -> int:
    """One of two gloo ranks sharing the card (`--shard-rank RANK PORT OUT
    DEVICE GO`): waits until the file GO exists (the ranks are started early
    so that their imports overlap the other phases; they touch the card only
    after it), then renders the SHARD_SIZE sphere frame sharded over each of
    SHARD_MESHES on DEVICE and writes it to OUT.<mesh>.<rank>.npy."""
    rank, port, out, device, go = int(argv[1]), argv[2], argv[3], argv[4], argv[5]
    deadline = time.monotonic() + RANK_WAIT_S
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            print(f"rank {rank}: no go after {RANK_WAIT_S} s", flush=True)
            return 1
        time.sleep(0.05)
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=300))
    scene = make_sphere_scene(SHARD_SIZE, SHARD_SIZE, **SPHERES)
    for t, s in SHARD_MESHES:
        ck.reset_launch_counts()
        img = render_scene_sharded(scene, RenderConfig(backend="cuda"), make_mesh(t, s),
                                   device=device)
        np.save(f"{out}.{t}x{s}.{rank}.npy", img)
        print(f"rank {rank} mesh ({t},{s}): launches {dict(ck.LAUNCHES)}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


RANK_WAIT_S = 900  # a rank whose go never comes gives up


class GlooRanks:
    """The two processes of `check_two_gloo_ranks`, started at once: each
    imports torch and the port (seconds) while this process checks the
    card, and waits for `go()` before it touches the card. `stop()` ends
    any that still run."""

    def __init__(self, dev):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.tmp = tempfile.TemporaryDirectory()
        self.out, self._go = f"{self.tmp.name}/frame", f"{self.tmp.name}/go"
        self.procs = [subprocess.Popen([sys.executable, __file__, "--shard-rank", str(r),
                                        str(port), self.out, str(dev), self._go],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(2)]

    def go(self) -> list:
        """Let the ranks run; returns their output once both have ended."""
        open(self._go, "w").close()
        return [p.communicate(timeout=400)[0] for p in self.procs]

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.tmp.cleanup()


def check_two_gloo_ranks(dev, ranks: GlooRanks):
    """Two processes on the one card in a gloo group render the
    SHARD_SIZE frame over (2,1) and (1,2): each rank's image uint8-equal to
    the single-process frame. Nothing is timed: two ranks on one card
    measure contention."""
    ref = u8(SceneRenderer(make_sphere_scene(SHARD_SIZE, SHARD_SIZE, **SPHERES),
                           RenderConfig(backend="cuda"), dev).render_device())
    logs = ranks.go()
    if any(p.returncode != 0 for p in ranks.procs):
        raise AssertionError("a gloo rank failed:\n" + "\n---\n".join(
            log[-4000:] for log in logs))
    for line in "".join(logs).splitlines():
        if line.startswith("rank "):
            say("shard", line)
    for t, s in SHARD_MESHES:
        for r in range(2):
            img = np.load(f"{ranks.out}.{t}x{s}.{r}.npy")
            got = np.trunc(img).astype(np.int32)
            n_diff = int((got != ref).any(-1).sum())
            if got.shape != ref.shape or n_diff:
                raise AssertionError(f"gloo rank {r}, mesh ({t},{s}): {n_diff} pixels "
                                     "differ from the single-process frame")
    say("shard", f"two gloo ranks sharing the card, meshes {SHARD_MESHES}: every rank's "
        f"{SHARD_SIZE}x{SHARD_SIZE} frame uint8-equal to the single-process frame")


def main(argv) -> int:
    if argv[:1] == ["--shard-rank"]:
        return shard_rank_main(argv)
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
        f"CUDA {torch.version.cuda}; imports took {T_START - T_IMPORT:.1f} s")
    ranks = GlooRanks(dev)
    try:
        return check_all(dev, smi, kind, count, want_profile, ranks)
    finally:
        ranks.stop()


def check_all(dev, smi, kind, count, want_profile, ranks) -> int:
    """Every phase, in order; raises on the first failure."""
    t0 = time.perf_counter()
    path = build.library_path()
    ck.build_kernels()
    say("build", f"{path} in {time.perf_counter() - t0:.1f} s")
    for line in (path.parent / "build.log").read_text().splitlines():
        if ("registers" in line or "bytes smem" in line or "Compiling entry" in line
                or "side by side" in line):
            say("build", line.strip())

    results = check_kernels(dev)
    loop_results = check_frame_loop(dev)
    if want_profile:
        profile_fetch_wrapper(dev)
    launches = {}
    launches["training"] = run_training_phases(dev, smi, want_profile, results)
    cfg = RenderConfig(backend="cuda")
    spheres512 = make_sphere_scene(512, 512, **SPHERES)
    cpu_rays = 512 * 512 * 4
    k123 = ("nearest_hit", "nearest_dist", "fetch_rows", "tile_cull")
    # beyond 64 triangle tiles the cull walks the octree levels
    k123_levels = ("nearest_hit", "nearest_dist", "fetch_rows", "tile_cull_levels")

    # ---- CPU mode, backend "cuda": the sphere scene at 512x512, its frame
    # captured and replayed, held against the eager frame
    traced = {}
    renderer, cuda_img, launches["cpu_mode"], loop_launches, traced["cuda"] = check_graph_cell(
        f"CPU mode, spheres 512x512, cuda (depth {frame_depth(spheres512, cfg)})",
        spheres512, cfg, dev, smi, k123, n_primary=cpu_rays, want_profile=want_profile)

    # ---- render_image through its plan: captured forward and backward at
    # 256x256, GPU mode, and the no-grad frame program on the same frame
    launches["image"] = run_image_phase(dev, smi, renderer, cuda_img, want_profile)

    # ---- the file entry on the same scene and config: .svati, the native
    # parser and writers, render(), the CLI with --profile, inspect
    launches["entry"] = check_entry(spheres512, cfg, renderer, cuda_img, dev, kind, smi)
    warm = renderer.plan.warmup_launches
    if launches["entry"] != {k: n + warm[k] for k, n in launches["cpu_mode"].items()}:
        raise AssertionError(f"render() launched {launches['entry']}, SceneRenderer's "
                             f"frame {launches['cpu_mode']} and its capture's warm-up "
                             f"{warm}")

    # ---- sharding: world size 1 through the sharded entry points on the
    # same frame, the sharded train step, two gloo ranks sharing the card
    launches["shard"] = check_shard_frame(spheres512, cfg, renderer, cuda_img, smi,
                                          want_profile)
    check_shard_train_step(dev, smi)
    check_two_gloo_ranks(dev, ranks)

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
    _, grid_img, launches["grid"], _, _ = check_graph_cell(
        "CPU mode, grid 512x512, cuda", grid512, cfg, dev, smi, k123_levels,
        none=("tile_cull",), n_primary=cpu_rays, want_profile=want_profile)
    grid_counts = launches["grid"]
    _, f2b_img, launches["front_to_back"], _, _ = check_graph_cell(
        "CPU mode, grid 512x512, cuda, f2b_tiles=8", grid512,
        RenderConfig(backend="cuda", f2b_tiles=8), dev, smi, k123_levels,
        none=("tile_cull",), n_primary=cpu_rays, want_profile=want_profile)
    if launches["front_to_back"]["nearest_hit"] != 2 * grid_counts["nearest_hit"]:
        raise AssertionError("front-to-back did not double the nearest_hit launches: "
                             f"{launches['front_to_back']} against {grid_counts}")
    if not torch.equal(f2b_img, grid_img):
        raise AssertionError("the front-to-back frame differs from the plain sweep's")
    say("render", "grid 512x512: front-to-back frame equal to the plain sweep's, "
        "nearest_hit launches doubled")

    # ---- GPU mode: 512x512 output at aliasing 3, shadows through the
    # any-hit sweep, held against the same frame through the distance sweep
    gpu_rays = 512 * 512 * ALIASING ** 2
    gcfg = RenderConfig(mode="gpu", backend="cuda", aliasing=ALIASING, max_bounce=10)
    any_cfg = dataclasses.replace(gcfg, any_hit_min_tris=0)
    _, any_img, launches["gpu_mode"], _, traced["GPU mode, any-hit"] = check_graph_cell(
        f"GPU mode, spheres 512x512 x{ALIASING}, cuda, any-hit", spheres512, any_cfg,
        dev, smi, ("nearest_hit", "fetch_rows", "any_hit"), none=("nearest_dist",),
        n_primary=gpu_rays, want_profile=want_profile)
    dist_img, _ = counted_frame(
        SceneRenderer(spheres512, gcfg, dev),
        f"GPU mode, spheres 512x512 x{ALIASING}, cuda, distance sweep, graph frame",
        ("nearest_hit", "fetch_rows", "nearest_dist"), none=("any_hit",))
    require_same_image(any_img, dist_img,
                       "GPU mode: any-hit frame against the distance-sweep frame")

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
    mm_cfg = RenderConfig(backend="cuda_matmul")
    mm, mm_img, launches["matmul"], _, traced["cuda_matmul"] = check_graph_cell(
        "CPU mode, spheres 512x512, cuda_matmul", spheres512, mm_cfg, dev, smi,
        ("nearest_hit_matmul", "nearest_dist_matmul", "fetch_rows"),
        none=("nearest_hit", "nearest_dist", "any_hit"), n_primary=cpu_rays,
        want_profile=want_profile)
    d = assert_images_close(u8(mm_img), u8(cuda_img), tol=1,
                            context="cuda_matmul against cuda, spheres 512x512")
    say("render", f"cuda_matmul against cuda, spheres 512x512: {d}")
    # two versions in one call, in turns: cuda_matmul, cuda, cuda, cuda_matmul
    _, times = time_frames(mm, 1)
    _, again = time_frames(renderer, 2)
    times += time_frames(mm, 1)[1]
    mm_frame_ms = report_frames("CPU mode, spheres 512x512, cuda_matmul, graph", mm,
                                times, cpu_rays, smi)
    cuda_again_ms = report_frames("CPU mode, spheres 512x512, cuda, graph, again",
                                  renderer, again, cpu_rays, smi)
    say("render", "cuda_matmul frame / cuda frame beside it (graph frames): "
        f"{mm_frame_ms / cuda_again_ms:.3f}")
    if want_profile:
        say("profile", "device kernels and copies per graph frame, spheres 512x512: "
            + ", ".join(f"{k} {n}" for k, n in traced.items())
            + f"; cuda_matmul - cuda = {traced['cuda_matmul'] - traced['cuda']}")

    path_of = {"nearest_hit": "cpu_mode", "nearest_dist": "cpu_mode",
               "fetch_rows": "cpu_mode", "any_hit": "gpu_mode",
               "nearest_hit_matmul": "matmul", "nearest_dist_matmul": "matmul",
               "tile_cull": "cpu_mode", "tile_cull_levels": "grid"}
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
        if name == "tile_cull":
            entry["note"] = ("no TPU kernel: the JAX package culls in jnp; ms is the "
                             "benchmark spheres' 5-light shadow batch")
            entry["nearest_chunk"] = {k: results[name]["nearest_chunk"][k] for k in keys}
        if name == "tile_cull_levels":
            entry["note"] = ("no TPU kernel: the JAX package culls in jnp; ms is the "
                             "benchmark sphereflake's CPU-mode primary chunk")
            extra = keys + ("tests", "flat_device_ms", "build_device_ms")
            entry.update({k: results[name][k] for k in extra[len(keys):]})
            for shape in ("shadow_batch", "grid_chunk"):
                entry[shape] = {k: results[name][shape][k] for k in extra}
        if name == "fetch_rows":
            entry["also_replaces"] = f"{PALLAS}:568"
            entry["backward"] = dict(
                results[name]["backward"], replaces=f"{PALLAS}:582",
                note="index_add_ inside FetchRows.backward; the JAX package's "
                     "adjoint is a plain scatter-add outside any Pallas kernel",
                grid_4096=results["grid_4096"][name]["backward"])
        kernels.append(entry)
    for name in frame_graph.KERNELS:  # the port's own: no TPU kernel
        kernels.append({"name": name, "route": "cuda", "source": LOOP_SOURCE,
                        "replaces": LOOP_REPLACES[name],
                        "launches": loop_launches[name], **loop_results[name],
                        "path": "cpu_mode",
                        "note": "no TPU kernel: the frame graph's loop condition "
                                "(lax.while_loop / lax.map on the TPU); ms is one "
                                "iteration of the WHILE loop that holds the kernel, "
                                + LOOP_BODY[name]})
    print(json.dumps({"kernels": kernels}))
    say("done", f"total {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
