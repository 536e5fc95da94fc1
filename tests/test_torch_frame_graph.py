"""The captured frame (`utils/frame_graph.FramePlan`) on the CPU, where its
three pieces are called as they stand over the same buffers, in the order
of the frame program the card assembles them into (one CUDA graph with its
loops on the device; `tests/test_torch_frame_loop.py` holds the program).

- the plan's frame is bit-equal (`torch.equal`) to the eager frame
  (`render._render_frame`) in both modes, on both kernel
  backends, with a tail chunk, on a mirror scene whose chunks stop before
  their depth cap and on caps that cut them short; and equal to the JAX
  package's op-by-op render (tolerance 0: bit-equal floats, hence uint8-equal);
- each chunk takes the eager loop's number of bounce steps;
- no piece reads a value back to the host, nor makes a tensor from Python
  data (on the card an H2D copy from pageable memory): what would break a
  capture on the card;
- which frames take the plan, and the launch bookkeeping of captured pieces.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.render import render_scene as jrender

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
from raytracing_gpu_tpu_torch.models.procedural import (
    make_sphere_grid_scene,
    make_sphere_scene,
)
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import frame_graph

# the package's `render` function shadows the module
R = importlib.import_module("raytracing_gpu_tpu_torch.render")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# 12x12: 576 CPU-mode rays, 1,296 GPU-mode rays at aliasing 3; chunks of 256
# leave a tail chunk in both
SPHERES = dict(width=12, height=12, n_lat=8, n_lon=12)
CHUNK = 256


@pytest.fixture(scope="module")
def spheres():
    return make_sphere_scene(**SPHERES)


@pytest.fixture(scope="module")
def grid():
    # 19,200 triangles in 75 tiles: the tile hierarchy pads its top level
    # (75 % 8 != 0), and f2b_tiles=8 takes the two-round sweep; 128 rays
    return make_sphere_grid_scene(8, 4, nx=4, ny=4, nz=2, n_lat=16, n_lon=20)


def _eager(scene, cfg):
    """The eager frame and its renderer (scene on the CPU, pack built)."""
    r = SceneRenderer(scene, cfg, device="cpu")
    assert r.plan is None
    return r.render_device(), r


def _plan(r):
    return R.frame_plan(r.scene, r.cfg, r.depth, r.pack)


CASES = {
    "cpu-cuda": dict(backend="cuda"),
    "cpu-cuda_matmul": dict(backend="cuda_matmul"),
    "gpu-cuda": dict(mode="gpu", backend="cuda"),
    "gpu-cuda_matmul": dict(mode="gpu", backend="cuda_matmul"),
    "gpu-cuda-any_hit": dict(mode="gpu", backend="cuda", any_hit_min_tris=0),
    "cpu-cuda-capped": dict(backend="cuda", cpu_max_depth=2),
    "gpu-cuda-capped": dict(mode="gpu", backend="cuda", max_bounce=1),
    "cpu-cuda-unfolded": dict(backend="cuda", ray_chunk=90),
    "cpu-torch": dict(backend="torch"),
    "cpu-cuda-smooth-while": dict(backend="cuda", quantize="smooth", unroll="while"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_frame_equals_eager_frame(spheres, case):
    kw = dict(CASES[case])
    cfg = RenderConfig(ray_chunk=kw.pop("ray_chunk", CHUNK), **kw)
    want, r = _eager(spheres, cfg)
    plan = _plan(r)
    got = plan.render()
    assert got.shape == (12, 12, 3) and got.max() > 0.0
    assert torch.equal(got, want)
    assert torch.equal(plan.render(), want)  # the buffers are reset per chunk
    assert plan.frame.n_rays % plan.frame.chunk  # a tail chunk
    steps = plan.last_frame.steps
    assert len(steps) == plan.n_chunks and plan.graphs == 0
    if case.endswith("capped"):
        assert max(steps) == plan.n_bounces
    else:  # mirrors, but every chunk's rays die before the cap
        assert max(steps) > 1 and max(steps) < plan.n_bounces
    f = plan.last_frame  # interpreted: no graph launch, no device to sync with
    assert (f.launches, f.syncs) == (0, None)
    assert f.loops == {"loop_reset": plan.n_chunks, "bounce_condition": sum(steps),
                       "chunk_advance": plan.n_chunks}


def test_plan_frame_on_the_grid_with_front_to_back(grid):
    """The padded tile hierarchy, the two-round sweep and a chunk padded to
    the ray tile: equal to the eager frame, and no piece reads back."""
    cfg = RenderConfig(backend="cuda", f2b_tiles=8, ray_chunk=128)
    want, r = _eager(grid, cfg)
    assert r.pack.tile_aabb.shape[0] > 2 * cfg.f2b_tiles
    plan = _plan(r)
    with _NoHostReads():
        got = plan.render()
    assert torch.equal(got, want)


def test_plan_frame_equals_jax_eager_render():
    """Tolerance 0: the plan's floats equal the JAX package's op-by-op
    render (hence its uint8 image too), over several chunks."""
    jscene = jproc.make_sphere_scene(**SPHERES)
    with jax.disable_jit():
        want = np.asarray(jrender(jscene, JConfig(backend="jnp", partitioning="none",
                                                  ray_chunk=CHUNK)))
    cfg = RenderConfig(backend="cuda", ray_chunk=CHUNK)
    got = _plan(SceneRenderer(scene_from_numpy(jscene), cfg, device="cpu")).render()
    np.testing.assert_array_equal(np.trunc(got.numpy()).astype(np.uint8),
                                  np.trunc(want).astype(np.uint8))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_each_chunk_takes_the_eager_loops_steps(spheres, monkeypatch, mode):
    """`_bounce_step` is called as often per chunk by the plan as by the
    eager loop (`render._trace`, once per chunk)."""
    calls = []
    step, trace = R._bounce_step, R._trace

    def counting_step(*args):
        calls[-1] += 1
        return step(*args)

    def counting_trace(*args, **kwargs):
        calls.append(0)
        return trace(*args, **kwargs)

    monkeypatch.setattr(R, "_bounce_step", counting_step)
    monkeypatch.setattr(R, "_trace", counting_trace)
    cfg = RenderConfig(mode=mode, backend="cuda", ray_chunk=CHUNK)
    _, r = _eager(spheres, cfg)
    eager = list(calls)
    plan = _plan(r)
    calls[:] = [0]
    plan.render()
    assert len(eager) == plan.n_chunks > 1
    assert list(plan.last_frame.steps) == eager
    assert calls == [sum(eager)]
    assert len(set(eager)) > 1  # chunks stop at different depths


class _NoHostReads(TorchDispatchMode):
    """Raises on an operation that reads a value back to the host, and on a
    tensor made from Python data (on the card: a copy from pageable host
    memory). Either breaks a CUDA graph capture."""

    FORBIDDEN = ("_local_scalar_dense", "nonzero", "item", "lift_fresh")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.FORBIDDEN:
            raise AssertionError(f"aten.{name} inside a piece of the frame")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["cpu-cuda", "cpu-cuda_matmul", "gpu-cuda-any_hit",
                                  "cpu-torch"])
def test_pieces_read_nothing_back(spheres, case):
    cfg = RenderConfig(ray_chunk=CHUNK, **CASES[case])
    want, r = _eager(spheres, cfg)
    plan = _plan(r)
    with _NoHostReads():
        for piece in frame_graph.PIECES:
            plan._pieces[piece]()
        # the interpreter reads its conditions with `tolist()`, which the
        # guard lets by; the pieces and the twins it calls read nothing
        got = plan.render()
    assert torch.equal(got, want)


def test_the_guard_catches_a_host_read():
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with _NoHostReads():
            bool(torch.ones(2).any())
    with pytest.raises(AssertionError, match="lift_fresh"):
        with _NoHostReads():
            torch.ones(3)[[0, 2]]


@pytest.mark.parametrize("kw,device,takes", [
    (dict(), "cuda", True),
    (dict(mode="gpu", backend="cuda_matmul"), "cuda", True),
    (dict(backend="torch"), "cuda", True),
    (dict(quantize="smooth", unroll="while"), "cuda", True),
    (dict(unroll="static"), "cuda", False),
    (dict(quantize="smooth"), "cuda", False),  # "auto" resolves to unrolled
    (dict(), "cpu", False),
    (dict(mode="gpu"), "cpu", False),
])
def test_which_frames_take_the_plan(kw, device, takes):
    assert frame_graph.uses_frame_graph(RenderConfig(**kw), device) is takes
    assert frame_graph.uses_frame_graph(RenderConfig(**kw), torch.device(device)) is takes


def test_scene_renderer_on_the_cpu_stays_eager(spheres):
    for cfg in (RenderConfig(), RenderConfig(mode="gpu"), RenderConfig(unroll="static")):
        assert SceneRenderer(spheres, cfg, device="cpu").plan is None


def test_captured_launches_count_once_per_replay():
    before = dict(ck.LAUNCHES)
    with ck.captured_launches() as recorded:
        ck.LAUNCHES["nearest_hit"] += 2  # what the wrappers count while captured
        ck.LAUNCHES["fetch_rows"] += 1
    assert ck.LAUNCHES == before  # a capture launches nothing
    assert recorded == dict(dict.fromkeys(before, 0), nearest_hit=2, fetch_rows=1)
    for _ in range(3):
        ck.add_launches(recorded)
    assert ck.LAUNCHES == dict(before, nearest_hit=before["nearest_hit"] + 6,
                               fetch_rows=before["fetch_rows"] + 3)
    with pytest.raises(RuntimeError):  # a failed capture leaves the counts
        with ck.captured_launches():
            ck.LAUNCHES["any_hit"] += 1
            raise RuntimeError("capture failed")
    assert ck.LAUNCHES["any_hit"] == before["any_hit"]
    ck.LAUNCHES.update(before)


@pytest.mark.cuda
def test_scene_renderer_captures_its_frame_on_the_card(spheres):
    """On the card the frame is one graph, launched; the image and the
    launches equal the eager frame's (`unroll="static"` stays eager)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    for kw in (dict(), dict(mode="gpu", any_hit_min_tris=0), dict(backend="cuda_matmul")):
        cfg = RenderConfig(ray_chunk=CHUNK, **kw)
        graph = SceneRenderer(spheres, cfg, device="cuda")
        eager = SceneRenderer(spheres, RenderConfig(ray_chunk=CHUNK, unroll="static", **kw),
                              device="cuda")
        assert graph.plan is not None and graph.plan.graphs == 1 and eager.plan is None
        counts = []
        for r in (graph, eager):
            ck.reset_launch_counts()
            img = r.render_device()
            torch.cuda.synchronize()
            counts.append(dict(ck.LAUNCHES))
            if r is graph:
                got = img
        assert torch.equal(got, img) and torch.equal(graph.render_device(), got)
        assert counts[0] == counts[1] and counts[0]["fetch_rows"] > 0
