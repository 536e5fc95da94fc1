"""The program's recorder of spans and counters (`utils/profiling.py`:
`annotate`, `count`, `recording`, `Recorder.export`, `chrome_trace`) and the
benchmark's readers of what it records (`portbench/spans.py`).

On the CPU:
- with the recorder off, `annotate` is one shared null context and `count`
  does nothing; the image is bit-equal with the recorder off and on, in CPU
  and GPU mode;
- an interpreted `FramePlan` of a small scene: one `bounce` span per bounce
  step (`sum(last_frame.steps)`), one `rays` and one `fold` per chunk, each
  `bounce` holding `collide` (over `cull`, `sweep`), `shade` (over
  `shadow`) and `update`, in that order; `live_rays` and `ray_slots` equal a
  recount of the eager loop on the host;
- nesting rebuilt from a flat, interleaved tag list; the device clock put on
  the host clock from two calibrations, with their drift; idle gaps named by
  the innermost host span at their midpoint;
- the hierarchical tile cull's `levels` spans, inside `cull` and only on
  more than 64 triangle tiles; the counters `tile_pairs_kept` and
  `tile_pairs` equal to the cull's mask, in a sweep and over a frame;
- a captured step's span tree (the `StepPlan` on the CPU): `forward`,
  `backward` and `optimizer` under `step`; the fixed-depth loop's counters
  against a recount;
- the Chrome trace of an export; the readers of `portbench/spans.py` on a
  recorded stretch of a tiny frames cell and training cell, and None where
  there is nothing sound to read.

On the card (`cuda` marker): the frame graph's nodes with the recorder off
and on (on a scene of more than 64 triangle tiles too), the device stamps of
a graph frame against the interpreted frame's, and the image byte-equal with
the recorder on and off.
"""

import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect
from raytracing_gpu_tpu_torch.parallel import extract_params, make_train_step
from raytracing_gpu_tpu_torch.utils import profiling
from raytracing_gpu_tpu_torch.utils.profiling import Calibration, Span

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

R = importlib.import_module("raytracing_gpu_tpu_torch.render")

# 12x12: 576 CPU-mode rays; 8x8 at aliasing 3: 576 GPU-mode rays; chunks of
# 160 make four, the last clamped
SIZES = {"cpu": dict(width=12, height=12, n_lat=8, n_lon=12),
         "gpu": dict(width=8, height=8, n_lat=8, n_lon=12)}
# two spheres of 8,820 triangles: 69 triangle tiles, so the cull's octree
# levels run
LEVELS = dict(width=12, height=12, n_lat=64, n_lon=70)
CHUNK = 160
BOUNCE_CHILDREN = ["collide", "shade", "update"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode, **kw):
    return RenderConfig(mode=mode, backend="cuda", ray_chunk=CHUNK, **kw)


def _plan(mode, device="cpu", sizes=None):
    """A renderer of the mode's small scene (or of `sizes`) and its frame
    plan (on the CPU the plan is interpreted; `SceneRenderer` itself renders
    eagerly)."""
    r = SceneRenderer(make_sphere_scene(**(sizes or SIZES[mode])), _cfg(mode),
                      device=device)
    return r, r.plan or R.frame_plan(r.scene, r.cfg, r.depth, r.pack)


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _merged(names):
    """Names with runs of one name merged (a frame's bounce holds two
    `update` spans: `_bounce_step`'s and the state copies of `_step`)."""
    return [n for k, n in enumerate(names) if k == 0 or names[k - 1] != n]


# ---- the recorder off -------------------------------------------------------

def test_recorder_off_is_one_shared_null_context_and_counts_nothing():
    assert profiling.active() is None
    a, b = profiling.annotate("bounce"), profiling.annotate("rays", device=False)
    assert a is b is profiling._NULL
    with a, b:
        profiling.count("live_rays", torch.ones(5, dtype=torch.bool))
    assert profiling.active() is None
    with profiling.recording("cpu") as rec:
        assert profiling.active() is rec
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.recording("cpu"):
                pass
    assert profiling.active() is None
    # nothing the recorder was handed outside its block reached it
    assert rec.export()["counters"] == dict.fromkeys(profiling.COUNTERS, 0)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_image_is_bit_equal_with_the_recorder_off_and_on(mode):
    r, off_plan = _plan(mode)
    off, eager_off = off_plan.render(), r.render_device()
    with profiling.recording("cpu") as rec:
        _, on_plan = _plan(mode)
        on, eager_on = on_plan.render(), r.render_device()
    assert torch.equal(off, on) and torch.equal(eager_off, eager_on)
    assert torch.equal(off, eager_off)
    assert rec.export()["stamps"] > 0


# ---- an interpreted frame ----------------------------------------------------

@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_interpreted_frame_span_tree(mode):
    with profiling.recording("cpu") as rec:
        _, plan = _plan(mode)
        plan.render()
    ex = rec.export()
    dev, steps = ex["device"], plan.last_frame.steps
    top = [s.name for s in dev if s.depth == 0]
    assert top.count("bounce") == sum(steps) and sum(steps) > plan.n_chunks
    assert top.count("rays") == top.count("fold") == plan.n_chunks == len(steps)
    # the program's order: rays, the chunk's bounce steps, fold, per chunk
    want = []
    for n in steps:
        want += ["rays"] + ["bounce"] * n + ["fold"]
    assert top == want
    for i, s in enumerate(dev):
        kids = _children(dev, i)
        if s.name == "bounce":
            assert _merged(kids) == BOUNCE_CHILDREN
        elif s.name == "collide":
            assert kids == ["cull", "sweep", "sweep"]  # the sweep, then K3's fetch
        elif s.name == "shade":
            assert kids == ["shadow"]
        elif s.name == "shadow":
            assert kids == ["cull", "sweep"]
        elif s.name in ("rays", "fold", "cull", "sweep", "update"):
            assert kids == []
        assert s.start <= s.end
        if s.parent >= 0:
            p = dev[s.parent]
            assert p.start <= s.start <= s.end <= p.end and s.depth == p.depth + 1
    host = {s.name for s in ex["host"] if s.name.startswith("frame.")}
    assert host == {"frame.launch", "frame.finish", "frame.read"}
    assert ex["dropped"] == 0 and ex["stamps"] == 2 * len(dev)
    # on the CPU every idle gap between top-level spans falls in the launch
    assert {n for n, _, _ in ex["gaps"]} <= {"frame.launch"}


def _eager_recount(mode, monkeypatch):
    """(live rays, ray slots) of the eager loop over the mode's scene, summed
    on the host at every bounce step."""
    seen = []
    step = R._bounce_step

    def counting(*args):
        alive = args[10]
        seen.append((int(alive.sum()), alive.numel()))
        return step(*args)

    monkeypatch.setattr(R, "_bounce_step", counting)
    r, _ = _plan(mode)
    r.render_device()
    monkeypatch.setattr(R, "_bounce_step", step)
    return sum(a for a, _ in seen), sum(n for _, n in seen), len(seen)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_live_rays_equal_the_eager_loops_recount(mode, monkeypatch):
    live, slots, n_steps = _eager_recount(mode, monkeypatch)
    with profiling.recording("cpu") as rec:
        r, plan = _plan(mode)
        plan.render()
        graph_counts = rec.export()["counters"]
        rec.clear()
        r.render_device()  # the eager loop counts in `render._trace`
        eager_counts = rec.export()["counters"]
    assert graph_counts == eager_counts
    assert (graph_counts["live_rays"], graph_counts["ray_slots"]) == (live, slots)
    assert sum(plan.last_frame.steps) == n_steps and slots == n_steps * CHUNK
    assert 0 < live <= slots
    assert 0 < graph_counts["tile_pairs_kept"] <= graph_counts["tile_pairs"]


# ---- the export from stamps: nesting, clocks, gaps ---------------------------

def test_nesting_is_rebuilt_from_a_flat_interleaved_tag_list():
    names = ["step", "forward", "collide", "backward", "optimizer"]

    def b(n):
        return 2 * names.index(n)

    stamps = [(b("step"), 0), (b("forward"), 1), (b("collide"), 2), (-1, 3),
              (b("collide") + 1, 4), (b("forward") + 1, 5), (b("backward"), 6),
              # the recompute of a checkpointed step, stamped from another
              # host thread, nests under backward by its device order
              (b("collide"), 7), (b("collide") + 1, 8), (b("backward") + 1, 9),
              (b("optimizer"), 10), (b("forward"), 11),  # left open
              (b("optimizer") + 1, 12), (b("step") + 1, 13), (b("collide"), 14)]
    spans = profiling.nest(stamps, names)
    got = [(s.name, s.start, s.end, s.depth, s.parent) for s in spans]
    assert got == [("step", 0, 13, 0, -1), ("forward", 1, 5, 1, 0),
                   ("collide", 2, 4, 2, 1), ("backward", 6, 9, 1, 0),
                   ("collide", 7, 8, 2, 3), ("optimizer", 10, 12, 1, 0),
                   ("forward", 11, 12, 2, 5), ("collide", 14, 14, 0, -1)]


def test_device_clock_onto_the_host_clock_with_drift():
    # device ns run 1 ppm slow against the host's, offset 5,000,000 ns
    a = Calibration(1_000_000_000 + 5_000_000 - 400, 1_000_000_000, 1_000_000_000 + 5_000_000 + 400)
    b = Calibration(3_000_000_000 + 5_002_000 - 200, 3_000_000_000, 3_000_000_000 + 5_002_000 + 200)
    assert a.offset == 5_000_000 and b.offset == 5_002_000
    clock = profiling.to_host([a, b])
    assert clock(1_000_000_000) == 1_005_000_000
    assert clock(2_000_000_000) == 2_005_001_000
    assert clock(3_000_000_000) == 3_005_002_000
    assert profiling.to_host([a])(2_000_000_000) == 2_005_000_000
    assert profiling.resolution_ns([96, 32, 0, 64, 64, 160]) == {"gcd": 32, "min": 32}
    assert profiling.resolution_ns([7]) == {"gcd": None, "min": None}


def test_idle_gaps_are_named_by_the_innermost_host_span():
    dev = [Span("rays", 100, 200, 0, -1), Span("collide", 120, 180, 1, 0),
           Span("bounce", 260, 300, 0, -1), Span("fold", 300, 320, 0, -1),
           Span("bounce", 500, 600, 0, -1)]
    host = [Span("frame.launch", 50, 250, 0, -1, 7), Span("frame.finish", 240, 250, 1, 0, 7),
            Span("frame.read", 330, 340, 0, -1, 7)]
    # gaps 200-260 (midpoint 230: frame.launch), 320-500 (410: none)
    assert profiling.idle_gaps(dev, host) == [("frame.launch", 200, 60),
                                              (profiling.OUTSIDE, 320, 180)]
    host.append(Span("frame.launch", 400, 450, 0, -1, 7))
    assert profiling.idle_gaps(dev, host)[1][0] == "frame.launch"
    assert profiling.host_span_at(host, [245, 335, 10]) == ["frame.finish", "frame.read",
                                                          profiling.OUTSIDE]


def test_a_recording_on_the_cpu_calibrates_and_exports_a_chrome_trace(tmp_path):
    with profiling.recording("cpu") as rec:
        with profiling.annotate("frame.launch", device=False):
            with profiling.annotate("bounce"):
                profiling.count("live_rays", torch.tensor([True, False, True]))
                profiling.count("ray_slots", 3)
        with profiling.annotate("bounce"):
            pass
    ex = rec.export()
    assert len(rec.calibrations) == 2 and ex["calibration"]["drift_ns"] == 0
    assert [s.name for s in ex["device"]] == ["bounce", "bounce"]
    assert [s.name for s in ex["host"]] == ["frame.launch", "bounce", "bounce"]
    assert ex["counters"] == {"live_rays": 2, "ray_slots": 3, "tile_pairs_kept": 0,
                              "tile_pairs": 0, "sweep_units": 0,
                              "sweep_units_scanned": 0}
    assert ex["gaps"] and ex["gaps"][0][0] == profiling.OUTSIDE
    path = profiling.write_chrome_trace(ex, str(tmp_path / "p"))
    assert Path(path).name.startswith("program.")
    trace = profiling.chrome_trace(ex)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["cat"]) for e in spans] == [
        ("frame.launch", "host"), ("bounce", "host"), ("bounce", "host"),
        ("bounce", "device"), ("bounce", "device"), (profiling.OUTSIDE, "idle")]
    assert min(e["ts"] for e in spans) == 0
    assert trace["otherData"]["counters"] == ex["counters"]


def test_under_torch_profiler_a_span_is_a_host_range_of_its_trace(tmp_path):
    """Recorder off or on, a span is a named host range in torch.profiler's
    trace, and no user annotation (which would add a device row)."""
    import json

    with profiling.trace(str(tmp_path / "t")) as path:
        with profiling.annotate("rgt_unrecorded_span"):
            torch.ones(8).sum()
        with profiling.recording("cpu") as rec:
            with profiling.annotate("rgt_recorded_span"):
                torch.ones(8).sum()
    with open(path) as f:
        cats = {e.get("name"): e.get("cat") for e in json.load(f)["traceEvents"]}
    assert cats["rgt_unrecorded_span"] == cats["rgt_recorded_span"] == "cpu_op"
    assert [s.name for s in rec.export()["device"]] == ["rgt_recorded_span"]


# ---- the tile cull's levels and pair counters ---------------------------------

def _cull_batch(n_tris):
    """A pack of `n_tris` small random triangles in the unit cube, and two
    ray tiles from a corner: a narrow bundle along the diagonal, and rays
    pointing away."""
    g = torch.Generator().manual_seed(n_tris)
    v = torch.rand((n_tris, 3, 3), generator=g)
    v = v[:, :1] + 0.05 * (v - v[:, :1])
    pack = ck.pack_geometry(v, torch.ones(n_tris, dtype=torch.bool))
    origins = torch.full((512, 3), -1.0)
    dirs = 1.0 + 0.01 * torch.rand((512, 3), generator=g)
    dirs[256:] *= -1.0
    return pack, origins, dirs


@pytest.mark.parametrize("tiles", [4, 66])
def test_levels_span_only_above_64_tiles_and_the_tile_pairs_counted(tiles):
    pack, origins, dirs = _cull_batch(tiles * ck.TILE_T)
    assert pack.tile_aabb.shape[0] == tiles
    with profiling.recording("cpu") as rec:
        for want_idx in (True, False):
            intersect._kernel_sweep(origins, dirs, pack, 1e-7, 0.01, "cuda", "octree",
                                    want_idx)
        intersect._any_hit_sweep(origins, dirs, pack, 1e-7, 0.01, "octree")
    ex = rec.export()
    dev = ex["device"]
    levels = [s for s in dev if s.name == "levels"]
    # one a cull: the union boxes' build and the per-ray cull down them
    assert len(levels) == (3 if tiles > 64 else 0)
    assert all(dev[s.parent].name == "cull" for s in levels)
    op, dp, _ = ck.pack_rays(origins, dirs)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    assert mask.shape == (tiles, op.shape[1] // ck.TILE_R)
    kept = int(mask.sum())
    assert ex["counters"]["tile_pairs_kept"] == 3 * kept
    assert ex["counters"]["tile_pairs"] == 3 * mask.numel()
    assert 0 < kept < mask.numel()


# ---- a captured step on the CPU ----------------------------------------------

TRAIN_W = TRAIN_H = 8


def _train(remat, n_steps, recorder=None):
    """n_steps of the sphere scene's `StepPlan` (uncaptured on the CPU);
    the recorder is cleared after the first."""
    scene = make_sphere_scene(TRAIN_W, TRAIN_H, n_lat=8, n_lon=12)
    cfg = RenderConfig(mode="cpu", quantize="smooth", backend="cuda", ray_chunk=128,
                       diff_max_depth=3, remat=remat)
    init_state, step_fn = make_train_step(
        None, cfg, scene, optimizer=lambda p: torch.optim.Adam([p["kd"]], lr=1e-2),
        device="cpu", plan=True)
    state = init_state(extract_params(scene))
    coords = camera_ops.cpu_subpixel_coords_traced(TRAIN_W, TRAIN_H,
                                                   torch.arange(TRAIN_W * TRAIN_H * 4))
    target = torch.full((TRAIN_W * TRAIN_H, 3), 0.3)
    for i in range(n_steps):
        state, _ = step_fn(state, scene, coords, target)
        if i == 0 and recorder is not None:
            recorder.clear()
    return step_fn


@pytest.mark.parametrize("remat", [True, False])
def test_captured_step_span_tree_on_the_cpu(remat):
    with profiling.recording("cpu") as rec:
        step_fn = _train(remat, 2, rec)
    assert step_fn.plan.last_call == "eager"
    dev = rec.export()["device"]
    steps = [i for i, s in enumerate(dev) if s.name == "step"]
    assert len(steps) == 1 and dev[steps[0]].depth == 0
    kids = _children(dev, steps[0])
    n_chunks = TRAIN_W * TRAIN_H * 4 // 128
    assert kids == ["forward"] + ["forward", "backward"] * n_chunks + ["optimizer"]
    # every fixed-depth bounce step's collide in the forward passes and, with
    # remat, once more where the backward pass recomputes the step
    parents = [dev[s.parent].name for s in dev if s.name == "collide"]
    assert parents.count("forward") == n_chunks * 3
    assert parents.count("backward") == (n_chunks * 3 if remat else 0)
    assert len(parents) == n_chunks * 3 * (2 if remat else 1)


def test_fixed_depth_counters_equal_a_recount(monkeypatch):
    seen = []
    step = R._bounce_step

    def counting(*args):
        seen.append((int(args[10].sum()), args[10].numel()))
        return step(*args)

    with profiling.recording("cpu") as rec:
        monkeypatch.setattr(R, "_bounce_step", counting)
        _train(False, 2, rec)
        seen = seen[len(seen) // 2:]  # the recorded second step's
    counters = rec.export()["counters"]
    assert (counters["live_rays"], counters["ray_slots"]) == (
        sum(a for a, _ in seen), sum(n for _, n in seen))
    # dead fixed-depth steps are counted: every step of every chunk
    assert counters["ray_slots"] == 3 * TRAIN_W * TRAIN_H * 4
    assert 0 < counters["live_rays"] < counters["ray_slots"]


# ---- the benchmark's readers --------------------------------------------------

READERS = ("span_cull_ms.frame", "span_shade_ms.frame", "span_sweep_ms.frame",
           "live_ray_pct.frame", "live_ray_pct.train", "step_idle_pct.train",
           "span_cull_levels_ms.frame", "tile_keep_pct.frame", "sweep_scan_pct.frame")


def _tiny(name):
    """The cell with 36-triangle spheres and a 4x4 image."""
    path = ROOT / "portbench" / "tests" / "conftest.py"
    spec = importlib.util.spec_from_file_location("portbench_tests_conftest", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.small(name, 4)


def _read(ctx):
    from portbench import harness

    return {m: harness.reader(m)(ctx) for m in READERS}


def test_frame_readers_on_a_recorded_stretch():
    from portbench import spans

    stretch = spans.record_frames(_tiny("spheres-cpu512-frames"), 2**31 + 3, "cpu", 0.0)
    ctx = {"window": {"unit": "frame"}, "spans": stretch}
    got = _read(ctx)
    assert got["live_ray_pct.train"] is None and got["step_idle_pct.train"] is None
    c = stretch["counters"]
    assert got["live_ray_pct.frame"] == pytest.approx(100 * c["live_rays"] / c["ray_slots"])
    assert 0 < got["live_ray_pct.frame"] <= 100
    assert got["tile_keep_pct.frame"] == pytest.approx(
        100 * c["tile_pairs_kept"] / c["tile_pairs"])
    assert 0 < got["tile_keep_pct.frame"] <= 100
    assert got["sweep_scan_pct.frame"] == pytest.approx(
        100 * c["sweep_units_scanned"] / c["sweep_units"])
    assert 0 < got["sweep_scan_pct.frame"] <= 100
    assert got["span_cull_levels_ms.frame"] is None  # 36-triangle spheres: the flat cull
    per = spans.frames(stretch)
    assert len(per) == spans.RECORDED_FRAMES
    dev = stretch["device"]
    # every frame holds the same spans, one bounce per step
    assert all(sum(dev[i].name == "bounce" for i in f) == stretch["steps"] for f in per)
    first = per[0]
    cull = sum(dev[i].ns for i in first if dev[i].name == "cull") * 1e-6
    assert spans.per_frame_ms(stretch, "cull")[0] == pytest.approx(cull)
    shadow = sum(dev[i].ns for i in first if dev[i].name == "shadow") * 1e-6
    shade = sum(dev[i].ns for i in first if dev[i].name == "shade") * 1e-6
    assert spans.per_frame_ms(stretch, "shade", True)[0] == pytest.approx(shade - shadow)
    for m in ("span_cull_ms.frame", "span_shade_ms.frame", "span_sweep_ms.frame"):
        assert got[m] is not None and got[m] > 0
    # dropped stamps, another kind of run, or no stretch: nothing to read
    assert set(_read({"window": {"unit": "frame"}, "spans": dict(stretch, dropped=1)})
               .values()) == {None}
    assert set(_read({"window": {"unit": "step"}, "spans": stretch}).values()) == {None}
    assert set(_read({"window": {"unit": "frame"}, "spans": None}).values()) == {None}


def test_step_readers_on_a_recorded_stretch():
    from portbench import spans

    stretch = spans.record_steps(_tiny("spheres-train256-steps"), 2**31 + 4, "cpu", 0.0)
    assert stretch["last_call"] == "eager"
    got = _read({"window": {"unit": "step"}, "spans": stretch})
    c = stretch["counters"]
    assert got["live_ray_pct.train"] == pytest.approx(100 * c["live_rays"] / c["ray_slots"])
    assert 0 < got["live_ray_pct.train"] < 100
    assert 0 <= got["step_idle_pct.train"] < 100
    assert got["span_cull_ms.frame"] is None
    assert sum(s.name == "step" for s in stretch["device"]) == spans.RECORDED_STEPS
    t0, t1 = stretch["window_ns"]
    stretch = dict(stretch, device=[Span("step", t0, t1, 0, -1)])
    assert spans.step_idle_pct(stretch) == 0.0


def test_readers_find_no_stretch_outside_a_run():
    from portbench import spans

    ctx = {"window": {"unit": "frame"}, "t_start": 0.0}
    assert spans.export(ctx) is None and ctx["spans"] is None
    assert set(_read(ctx).values()) == {None}


# ---- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stamp kernel and CUDA graphs have no "
                    "CPU mode)")


@pytest.mark.cuda
def test_recorder_off_leaves_the_frame_graph_as_it_was():
    """Off, a frame graph holds no node of the recorder: on, its pieces
    hold two stamp kernels a span and the counters' kernels more, and no
    other node."""
    _card()
    for mode, sizes in (("cpu", None), ("gpu", None), ("cpu", LEVELS)):
        _, off = _plan(mode, "cuda", sizes)
        with profiling.recording() as rec:
            _, on = _plan(mode, "cuda", sizes)
        _, off_again = _plan(mode, "cuda", sizes)
        assert off.piece_nodes == off_again.piece_nodes
        with profiling.recording("cpu") as cpu_rec:
            _, cpu_plan = _plan(mode, sizes=sizes)
            cpu_plan.render()
        dev = cpu_rec.export()["device"]
        steps = sum(cpu_plan.last_frame.steps)
        in_bounces = [s for s in dev if s.name == "bounce" or _under(dev, s, "bounce")]
        per_step = 2 * len(in_bounces) // steps
        culls = sum(s.name == "cull" for s in dev) // steps
        assert any(s.name == "levels" for s in dev) == (sizes is LEVELS)
        extra = {p: {t: d for t in set(on.piece_nodes[p]) | set(off.piece_nodes[p])
                     if (d := on.piece_nodes[p].get(t, 0) - off.piece_nodes[p].get(t, 0))}
                 for p in on.piece_nodes}
        # the counters' kernels: the live rays' sum, and the adds into two
        # slots (4 kernel nodes in all, as torch 2.11 captures them); and
        # alike a cull's kept pair tiles summed and added, and its pairs
        # added (4 more a cull), and the (warp, unit) scans its sweep was
        # offered and made, each summed and added (4 more a cull: one K1
        # or K2 sweep each)
        assert extra == {"rays": {"kernel": 2}, "fold": {"kernel": 2},
                         "step": {"kernel": per_step + 4 + 8 * culls}}, (extra, off.piece_nodes)
        del rec


def _under(spans, s, name):
    while s.parent >= 0:
        s = spans[s.parent]
        if s.name == name:
            return True
    return False


@pytest.mark.cuda
def test_graph_frame_stamps_equal_the_interpreted_frames():
    """Every device stamp of a graph frame is there, none dropped, and its
    span tree is the interpreted frame's name for name; the counters agree,
    and with the eager frame's on the card (the sweeps' (warp, unit) scans
    among them); the image is byte-equal with the recorder on and off."""
    _card()
    for mode in ("cpu", "gpu"):
        with profiling.recording("cpu") as cpu_rec:
            _, cpu_plan = _plan(mode)
            cpu_plan.render()
        want = cpu_rec.export()
        _, off = _plan(mode, "cuda")
        off_img = off.render()
        with profiling.recording() as rec:
            _, on = _plan(mode, "cuda")
            on.render()
            torch.cuda.synchronize()
            rec.clear()
            on_img = on.render()
            torch.cuda.synchronize()
        got = rec.export()
        assert torch.equal(off_img, on_img)
        assert (got["dropped"], got["stamps"]) == (0, want["stamps"]), mode
        tree = [(s.name, s.depth) for s in got["device"]]
        want_tree = [(s.name, s.depth) for s in want["device"]]
        assert tree == want_tree, (mode, len(tree), len(want_tree))
        assert got["counters"] == want["counters"], mode
        assert 0 < got["counters"]["sweep_units_scanned"] < got["counters"]["sweep_units"]
        with profiling.recording() as eager_rec:
            SceneRenderer(make_sphere_scene(**SIZES[mode]),
                          _cfg(mode, unroll="static"), device="cuda").render_device()
            torch.cuda.synchronize()
        assert eager_rec.export()["counters"] == got["counters"], mode
        # syncs are counted while recording only
        assert on.last_frame.syncs == 0 and off.last_frame.syncs is None
        dev = got["device"]
        assert all(s.start <= s.end for s in dev)
        assert all(dev[s.parent].start <= s.start and s.end <= dev[s.parent].end
                   for s in dev if s.parent >= 0)
        assert got["calibration"]["window_ns"] > 0
        top = np.array([(s.start, s.end) for s in dev if s.depth == 0])
        assert (top[1:, 0] >= top[:-1, 1]).all()  # one stream: in order, no overlap
