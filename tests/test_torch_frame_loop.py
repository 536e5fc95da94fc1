"""The frame program (`utils/frame_graph.PROGRAM`) on the CPU, where
`interpret` walks the node list the card assembles into one CUDA graph,
calling the captured pieces and the condition kernels' plain twins
(`loop_reset`, `bounce_condition`, `chunk_advance`) over the same buffers.

- the interpreted frame is bit-equal (`torch.equal`) to the eager frame and
  to the JAX package's op-by-op render (`jax.disable_jit()`, backend "jnp";
  tolerance 0), in CPU and GPU mode, over several chunks;
- the loop state's `steps` equals the eager loop's steps per chunk, and its
  counts of the condition kernels' runs are one per chunk and one per step;
- the twins at their edges: the cap reached with rays alive, a first test
  that fails (cutoff above 1), caps 0 and 1, one chunk, a clamped tail;
- the node list, its encoding and the program `csrc/frame_loop.cu` builds
  agree;
- no piece and no twin reads a value back to the host;
- on the card (`cuda` marker), one launch per frame, bit-equal to the eager
  frame.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.render import render_scene as jrender

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import frame_graph as fg
from raytracing_gpu_tpu_torch.utils import profiling

from test_torch_frame_graph import _NoHostReads

R = importlib.import_module("raytracing_gpu_tpu_torch.render")
LOOP_CU = Path(fg.__file__).resolve().parent.parent / "csrc" / "frame_loop.cu"

# 12x12: 576 CPU-mode rays; 8x8 at aliasing 3: 576 GPU-mode rays. Chunks of
# 160 make four, the last clamped to the final ray
SPHERES = dict(width=12, height=12, n_lat=8, n_lon=12)
GPU_SPHERES = dict(width=8, height=8, n_lat=8, n_lon=12)
CHUNK = 160


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(mode):
    return make_sphere_scene(**(GPU_SPHERES if mode == "gpu" else SPHERES))


def _plan(scene, cfg):
    """(the eager frame, the plan of the same frame) on the CPU."""
    r = SceneRenderer(scene, cfg, device="cpu")
    assert r.plan is None
    return r.render_device(), R.frame_plan(r.scene, r.cfg, r.depth, r.pack)


def _counting(monkeypatch):
    """Steps per chunk of every eager trace from now on."""
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
    return calls


# ---- the frame -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_interpreted_frame_equals_eager_frame_and_jax(mode):
    """Tolerance 0 against both: the eager frame and the JAX package's
    op-by-op render (hence its uint8 image too)."""
    kw = dict(mode=mode, ray_chunk=CHUNK)
    jscene = jproc.make_sphere_scene(**(GPU_SPHERES if mode == "gpu" else SPHERES))
    want, plan = _plan(scene_from_numpy(jscene), RenderConfig(backend="cuda", **kw))
    assert plan.n_chunks >= 3 and plan.frame.n_rays % plan.frame.chunk
    with _NoHostReads():
        got = plan.render()
    assert torch.equal(got, want) and got.max() > 0.0
    f = plan.last_frame  # interpreted: no graph launch, no device to sync with
    assert (f.launches, f.syncs) == (0, None)
    assert f.loops == {"loop_reset": plan.n_chunks, "bounce_condition": sum(f.steps),
                       "chunk_advance": plan.n_chunks}
    with jax.disable_jit():
        jax_img = np.asarray(jrender(jscene, JConfig(backend="jnp", partitioning="none",
                                                     **kw)))
    np.testing.assert_array_equal(got.numpy(), jax_img)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_device_steps_are_the_eager_loops(monkeypatch, mode):
    """The loop state's steps (what the card's kernels count) equal the
    eager loop's per chunk, and chunks stop at different depths."""
    calls = _counting(monkeypatch)
    _, plan = _plan(_scene(mode), RenderConfig(mode=mode, backend="cuda", ray_chunk=CHUNK))
    eager = list(calls)
    calls[:] = [0]
    plan.render()
    assert len(eager) == plan.n_chunks >= 3 and len(set(eager)) > 1
    assert plan._loop.steps.tolist() == eager == list(plan.last_frame.steps)
    assert calls == [sum(eager)]  # the interpreter ran the step that often
    assert plan.last_frame.loops == {"loop_reset": plan.n_chunks,
                                     "bounce_condition": sum(eager),
                                     "chunk_advance": plan.n_chunks}
    assert int(plan._loop.chunk_index) == plan.n_chunks


@pytest.mark.parametrize("case,kw,want", [
    # the cap reached while rays are alive: every chunk runs it out
    ("cap", dict(cpu_max_depth=2), lambda n, cap: [cap] * n),
    ("cap-1", dict(cpu_max_depth=1), lambda n, cap: [1] * n),
    # the eager loop's first test fails (every ray has coefficient 1)
    ("no-first-step", dict(reflect_cutoff=1.5), lambda n, cap: [0] * n),
    # one chunk holding the whole frame
    ("one-chunk", dict(ray_chunk=1 << 16), None),
    ("gpu-cap-1", dict(mode="gpu", max_bounce=0), lambda n, cap: [1] * n),
])
def test_frame_at_the_loops_edges(monkeypatch, case, kw, want):
    calls = _counting(monkeypatch)
    kw = dict(kw)
    mode = kw.get("mode", "cpu")
    cfg = RenderConfig(backend="cuda", ray_chunk=kw.pop("ray_chunk", CHUNK), **kw)
    eager_img, plan = _plan(_scene(mode), cfg)
    eager = list(calls)
    got = plan.render()
    assert torch.equal(got, eager_img)
    assert list(plan.last_frame.steps) == eager
    if want is not None:
        assert eager == want(plan.n_chunks, plan.n_bounces)
    if case == "one-chunk":
        assert plan.n_chunks == 1 and eager[0] > 1
    if case == "no-first-step":
        assert not plan.first_step and float(got.max()) == 0.0


# ---- the twins ---------------------------------------------------------------

def _state(n_chunks, chunk_index=0, steps=None, flag=False):
    s = fg.LoopState.zeros(n_chunks, "cpu")
    s.chunk_index.fill_(chunk_index)
    if steps is not None:
        s.steps.copy_(torch.tensor(steps, dtype=torch.int32))
    s.flag.fill_(flag)
    return s


def _cond():
    return torch.zeros((1,), dtype=torch.bool)


@pytest.mark.parametrize("first_step,n_bounces,want", [
    (True, 0, False), (True, 1, True), (True, 29, True), (False, 1, False),
    (False, 0, False)])
def test_loop_reset_twin(first_step, n_bounces, want):
    s, cond = _state(2, steps=[3, 1]), _cond().fill_(not want)
    with _NoHostReads():
        fg.loop_reset(cond, s, first_step, n_bounces)
    assert bool(cond) is want
    assert s.counts.tolist() == [1, 0, 0, 3, 1]  # its run counted, steps kept


@pytest.mark.parametrize("steps,flag,n_bounces,want_steps,want", [
    ([0, 0, 0], True, 3, [0, 1, 0], True),
    ([0, 1, 0], True, 2, [0, 2, 0], False),   # the cap reached, rays alive
    ([0, 0, 0], True, 1, [0, 1, 0], False),   # cap 1: one step
    ([0, 4, 0], False, 9, [0, 5, 0], False),  # every ray dead
])
def test_bounce_condition_twin(steps, flag, n_bounces, want_steps, want):
    s, cond = _state(3, chunk_index=1, steps=steps, flag=flag), _cond()
    with _NoHostReads():
        fg.bounce_condition(cond, s, n_bounces)
    assert s.steps.tolist() == want_steps and bool(cond) is want
    assert int(s.chunk_index) == 1 and s.counts[:3].tolist() == [0, 1, 0]


@pytest.mark.parametrize("n_chunks,chunk_index,want", [
    (1, 0, False),   # one chunk
    (3, 0, True), (3, 1, True), (3, 2, False)])
def test_chunk_advance_twin(n_chunks, chunk_index, want):
    s, cond = _state(n_chunks, chunk_index=chunk_index), _cond()
    with _NoHostReads():
        fg.chunk_advance(cond, s, n_chunks)
    assert int(s.chunk_index) == chunk_index + 1 and bool(cond) is want
    assert s.counts[:3].tolist() == [0, 0, 1]


def _eager_steps(alive, first_step, n_bounces):
    """The eager loop's steps per chunk when step k of chunk c leaves a ray
    alive exactly where alive[c, k]."""
    out = []
    for row in alive:
        n, go = 0, first_step
        while go and n < n_bounces:
            n += 1
            go = n < n_bounces and bool(row[n - 1])
        out.append(n)
    return out


@pytest.mark.parametrize("n_chunks,n_bounces,first_step,p", [
    (1, 1, True, 1.0), (3, 0, True, 1.0), (5, 6, False, 0.9), (36, 11, True, 0.8),
    (20, 29, True, 0.95), (4, 7, True, 1.0), (1, 5, True, 0.5)])
def test_interpreter_follows_seeded_flags(n_chunks, n_bounces, first_step, p):
    """The program over pieces that count their runs and a step that reads
    its flag from a seeded table: the twins' steps are the eager loop's,
    every chunk's rays and fold run once, and nothing is read back."""
    rng = np.random.default_rng(n_chunks * 100 + n_bounces)
    width = max(n_bounces, 1)
    alive = rng.random((n_chunks, width)) < p
    table = torch.from_numpy(alive.reshape(-1).copy())
    s = fg.LoopState.zeros(n_chunks, "cpu")
    rays = torch.zeros((n_chunks,), dtype=torch.int32)
    folds = torch.zeros_like(rays)
    one = torch.ones((1,), dtype=torch.int32)

    def ci():
        return s.chunk_index.reshape(1)

    def step():
        k = s.steps.index_select(0, ci()).long()
        s.flag.copy_(table.index_select(0, ci() * width + k))

    pieces = {"rays": lambda: rays.index_add_(0, ci(), one), "step": step,
              "fold": lambda: folds.index_add_(0, ci(), one)}
    s.counts.fill_(7)  # the program's reset node clears what a frame left
    with _NoHostReads():
        fg.interpret(fg.PROGRAM, s, pieces, n_chunks, n_bounces, first_step)
    want = _eager_steps(alive, first_step, n_bounces)
    assert s.read() == (tuple(want), {"loop_reset": n_chunks, "bounce_condition": sum(want),
                                      "chunk_advance": n_chunks})
    assert rays.tolist() == folds.tolist() == [1] * n_chunks
    assert int(s.chunk_index) == n_chunks


# ---- the program -------------------------------------------------------------

def test_program_has_the_frames_shape():
    assert fg.PROGRAM == (
        ("reset",),
        ("while", "chunks", (
            ("piece", "rays"),
            ("kernel", "loop_reset"),
            ("while", "bounces", (("piece", "step"), ("kernel", "bounce_condition"))),
            ("piece", "fold"),
            ("kernel", "chunk_advance"),
        )),
    )
    op = fg.OPCODES
    assert fg.encode_program(fg.PROGRAM) == [
        op["reset"], op["while"], 0,
        op["piece"], 0, op["kernel"], 0,
        op["while"], 1, op["piece"], 1, op["kernel"], 1, op["end"],
        op["piece"], 2, op["kernel"], 2, op["end"]]


def _cu_enum(name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, LOOP_CU.read_text()).group(1)
    return {k.strip(): int(v) for k, v in (e.split("=") for e in body.split(","))}


def test_encoding_matches_the_cuda_source():
    """The opcodes, pieces, kernels and conditions the assembly reads are
    the ones `encode_program` writes, and the one program it builds
    (`kProgram`) is `encode_program(PROGRAM)`."""
    def numbered(prefix, names):
        return {f"{prefix}_{n.upper()}": i for i, n in enumerate(names)}

    enums = {name: _cu_enum(name) for name in ("Op", "Piece", "Kernel", "Handle")}
    assert enums["Op"] == {f"OP_{k.upper()}": v for k, v in fg.OPCODES.items()}
    assert enums["Piece"] == dict(numbered("P", fg.PIECES), N_PIECES=len(fg.PIECES))
    assert enums["Kernel"] == dict(numbered("K", fg.KERNELS), N_KERNELS=len(fg.KERNELS))
    assert enums["Handle"] == numbered("H", fg.CONDITIONS)
    values = {k: v for e in enums.values() for k, v in e.items()}
    text = LOOP_CU.read_text()
    body = re.search(r"kProgram\[\] = \{([^}]*)\}", text).group(1)
    assert [values[t.strip()] for t in body.split(",")] == fg.encode_program(fg.PROGRAM)
    assert f"N_NODE_TYPES = {len(fg.NODE_TYPES)}" in text  # the histogram's buffer
    for name in fg.KERNELS:
        assert f"__global__ void {name}_kernel(" in text


def test_pieces_and_twins_read_nothing_back():
    """Each piece and each twin alone under the guard, then whole frames."""
    _, plan = _plan(_scene("cpu"), RenderConfig(backend="cuda", ray_chunk=CHUNK))
    cond = _cond()
    with _NoHostReads():
        fg.reset_loops(plan._loop)
        for piece in fg.PIECES:
            plan._pieces[piece]()
        fg.loop_reset(cond, plan._loop, plan.first_step, plan.n_bounces)
        fg.bounce_condition(cond, plan._loop, plan.n_bounces)
        fg.chunk_advance(cond, plan._loop, plan.n_chunks)
        plan.render()
        plan.render()


def test_the_condition_kernels_do_not_count_on_the_cpu():
    """On the CPU the twins run, and no launch is counted."""
    fg.reset_launch_counts()
    before = dict(ck.LAUNCHES)
    _, plan = _plan(_scene("cpu"), RenderConfig(backend="cuda", ray_chunk=CHUNK))
    plan.render()
    assert fg.LAUNCHES == dict.fromkeys(fg.KERNELS, 0)
    assert ck.LAUNCHES == before
    assert plan.graphs == 0 and plan.piece_nodes == {}


@pytest.mark.cuda
def test_frame_graph_on_the_card_equals_eager():
    """On the card a frame is one graph launch with its loops on the device
    and no host sync: bit-equal to the eager frame, the same launches per
    kernel, the condition kernels counting themselves on the device once
    per chunk and once per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    for mode in ("cpu", "gpu"):
        cfg = RenderConfig(mode=mode, backend="cuda", ray_chunk=CHUNK)
        graph = SceneRenderer(_scene(mode), cfg, device="cuda")
        eager = SceneRenderer(_scene(mode), RenderConfig(mode=mode, backend="cuda",
                                                         ray_chunk=CHUNK, unroll="static"),
                              device="cuda")
        assert graph.plan.graphs == 1 and eager.plan is None
        counts = []
        for r in (graph, eager):
            ck.reset_launch_counts()
            fg.reset_launch_counts()
            with profiling.recording():  # the host syncs are counted while recording
                img = r.render_device()
            torch.cuda.synchronize()
            counts.append((dict(ck.LAUNCHES), dict(fg.LAUNCHES)))
            if r is graph:
                got = img
        f = graph.plan.last_frame
        assert torch.equal(got, img) and torch.equal(graph.render_device(), got)
        assert (f.launches, f.syncs) == (1, 0)
        assert counts[0][0] == counts[1][0] and counts[0][0]["fetch_rows"] > 0
        assert counts[0][1] == {"loop_reset": graph.plan.n_chunks,
                                "bounce_condition": sum(f.steps),
                                "chunk_advance": graph.plan.n_chunks}
