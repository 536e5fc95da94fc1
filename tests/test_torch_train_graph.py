"""The captured training step (`utils/step_graph.StepPlan`) on the CPU, where
the step it captures on the card runs uncaptured over the same buffers.

- the plan's step against the eager `step_fn` (`plan=False`) on both kernel
  backends, with and without `remat`, with `kd` + `lights_rgb` free, then
  `vertices` too, then `cam_fov` too, and with `loss_blur`: the step-1 loss
  bit-equal; the
  losses, parameters and Adam moments after 3 steps within rtol 1e-6 /
  atol 1e-7 (they come out bit-equal on the CPU: the plan's dead bounce
  steps add exact zeros; the tolerance leaves room for sums in another
  order);
- the plan's first 3 losses against the JAX package's jitted step on a 1x1
  mesh, rtol 2e-4 (as `test_torch_train.py` holds the eager step);
- a scene whose rays all die at the first bounce: the plan traces every
  bounce step (every ray parked after the first), the eager loop one; the
  gradients of all 13 groups are finite and equal;
- the step's forward and backward passes read nothing back to the host and
  make no tensor from Python data (what breaks a capture on the card);
- which steps take the plan, the optimizer's `capturable` requirement,
  when the plan binds a new state, and libm's `tanf` on the device.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.render import render_scene as jrender

from raytracing_gpu_tpu_torch import RenderConfig
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import camera as tcam
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.parallel import extract_params, make_train_step
from raytracing_gpu_tpu_torch.parallel.checkpoint import (
    restore_train_state,
    save_train_state,
)
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS
from raytracing_gpu_tpu_torch.utils import step_graph

from test_torch_frame_graph import _NoHostReads
from test_torch_kernels import _jittered
from test_torch_train import KW, WRONG_KD, _coords, _jax_losses, _sgd_on_kd

# the package's `render` function shadows the module
R = importlib.import_module("raytracing_gpu_tpu_torch.render")

W = H = 16
# depth 4: the mirror spheres keep some chunks' rays alive for 2-4 bounces,
# so the eager loop stops early where the plan runs on
DEEP = dict(KW, diff_max_depth=4)
STEP_RTOL, STEP_ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(W, H, n_lat=8, n_lon=12)


def _target():
    return torch.from_numpy(np.random.default_rng(5).uniform(
        0.1, 0.6, (W * H, 3)).astype(np.float32))


def _adam(*names):
    return lambda p: torch.optim.Adam([p[k] for k in names], lr=1e-2)


def _count_bounce_steps(monkeypatch):
    """A list that counts `render._bounce_step` calls from now on."""
    calls = [0]
    step = R._bounce_step

    def counting(*args):
        calls[0] += 1
        return step(*args)

    monkeypatch.setattr(R, "_bounce_step", counting)
    return calls


def _run(scene, cfg, optimizer, plan, n_steps, target, monkeypatch, loss_blur=0.0):
    """n_steps of make_train_step(..., plan=plan) from the scene's own
    parameters: (state, loss tensors, bounce steps traced in the forward
    passes)."""
    init_state, step_fn = make_train_step(None, cfg, scene, optimizer=optimizer,
                                          loss_blur=loss_blur, device="cpu", plan=plan)
    assert (step_fn.plan is not None) is plan
    state = init_state(extract_params(scene))
    coords = torch.from_numpy(_coords())
    monkeypatch.setattr(R, "_bounce_step", R._bounce_step)  # undo an earlier count
    calls = _count_bounce_steps(monkeypatch)
    losses = []
    for i in range(n_steps):
        state, loss = step_fn(state, scene, coords, target)
        assert state.step == i + 1
        losses.append(loss)
    return state, losses, calls[0]


CASES = {  # backend, remat, free groups, loss_blur
    "cuda-remat": ("cuda", True, ("kd", "lights_rgb"), 0.0),
    "cuda-noremat": ("cuda", False, ("kd", "lights_rgb"), 0.0),
    "matmul-remat": ("cuda_matmul", True, ("kd", "lights_rgb"), 0.0),
    "matmul-noremat": ("cuda_matmul", False, ("kd", "lights_rgb"), 0.0),
    "cuda-remat-vertices": ("cuda", True, ("kd", "lights_rgb", "vertices"), 0.0),
    "matmul-noremat-vertices": ("cuda_matmul", False, ("kd", "lights_rgb", "vertices"),
                                0.0),
    "cuda-remat-vertices-fov": ("cuda", True, ("kd", "lights_rgb", "vertices", "cam_fov"),
                                0.0),
    "matmul-remat-fov": ("cuda_matmul", True, ("kd", "lights_rgb", "cam_fov"), 0.0),
    # the whole image's blurred loss and one backward pass
    "cuda-remat-blur": ("cuda", True, ("kd", "lights_rgb"), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_step_equals_eager_step(scene, case, monkeypatch):
    backend, remat, free, blur = CASES[case]
    cfg = RenderConfig(backend=backend, remat=remat, **DEEP)
    target = _target()
    eager, eager_losses, eager_steps = _run(scene, cfg, _adam(*free), False, 3,
                                            target, monkeypatch, blur)
    plan, plan_losses, plan_steps = _run(scene, cfg, _adam(*free), True, 3,
                                         target, monkeypatch, blur)
    n_chunks = W * H * 4 // cfg.ray_chunk
    # the plan traces every bounce step of every chunk; the eager loop stops
    # a chunk once its rays are dead (with remat the backward pass recomputes
    # each step: twice the calls)
    per_pass = 2 if remat else 1
    assert plan_steps == 3 * n_chunks * cfg.diff_max_depth * per_pass
    assert eager_steps < plan_steps
    first = float(plan_losses[0])
    assert float(eager_losses[0]) == first  # bit-equal
    np.testing.assert_allclose([float(x) for x in plan_losses],
                               [float(x) for x in eager_losses],
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    assert float(plan_losses[0]) == first  # a copy: later steps leave it
    for k in PARAM_KEYS:
        np.testing.assert_allclose(plan.params[k].detach().numpy(),
                                   eager.params[k].detach().numpy(),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
        assert plan.params[k].requires_grad == (k in free)
    moved = [k for k in free if not torch.equal(plan.params[k], extract_params(scene)[k])]
    assert moved == list(free)
    a, b = eager.opt_state.state_dict(), plan.opt_state.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, slot in a["state"].items():
        for name, v in slot.items():
            np.testing.assert_allclose(b["state"][i][name].numpy(), v.numpy(),
                                       rtol=STEP_RTOL, atol=STEP_ATOL,
                                       err_msg=f"{i} {name}")


@pytest.mark.parametrize("port_backend,jax_backend,partitioning", [
    ("cuda", "pallas", "octree"),
    ("torch", "jnp", "none"),
])
def test_plan_losses_match_jax(port_backend, jax_backend, partitioning):
    """kd recovery by SGD through the plan: the first 3 losses are the JAX
    package's jitted step's (1x1 mesh), rtol 2e-4."""
    jscene = _jittered(jproc.make_sphere_scene(width=W, height=H, n_lat=8, n_lon=12))
    jcfg = JConfig(backend=jax_backend, partitioning=partitioning, **KW)
    target = (np.asarray(jrender(jscene, jcfg)) / 255.0).reshape(-1, 3).astype(np.float32)
    tscene = scene_from_numpy(jscene)
    params0 = dict(extract_params(tscene))
    params0["kd"] = params0["kd"].clone()
    params0["kd"][0] = torch.from_numpy(WRONG_KD)
    cfg = RenderConfig(backend=port_backend, partitioning=partitioning, **KW)
    init_state, step_fn = make_train_step(None, cfg, tscene, optimizer=_sgd_on_kd(),
                                          device="cpu", plan=True)
    state = init_state(params0)
    coords, tgt = torch.from_numpy(_coords()), torch.from_numpy(target)
    losses = [float(step_fn(state, tscene, coords, tgt)[1]) for _ in range(3)]
    assert losses[2] < losses[0]
    want, _ = _jax_losses(jscene, jcfg, target, 3)
    np.testing.assert_allclose(losses, want, rtol=2e-4)


def _dead_after_first_bounce(scene):
    """The scene with no mirror in view: every real object's nr is 0, and
    one object without triangles keeps nr 0.5, so the depth stays 4."""
    nr = torch.zeros_like(scene.materials.nr)
    nr[scene.n_objects] = 0.5
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, nr=nr))


@pytest.mark.parametrize("backend,remat", [("cuda", True), ("cuda", False),
                                           ("cuda_matmul", True)])
def test_fixed_depth_gradients_on_a_dead_scene(scene, backend, remat, monkeypatch):
    """Every ray dies at the first bounce: the eager loop stops there, the
    plan runs 3 more steps with every ray parked (no pair tile kept, empty
    sweeps). The gradients of all 13 groups are finite and equal."""
    dead = _dead_after_first_bounce(scene)
    cfg = RenderConfig(backend=backend, remat=remat, **DEEP)

    def every_group(p):  # rate 0: the gradients stay, nothing moves
        return torch.optim.SGD(list(p.values()), lr=0.0)

    target = _target()
    eager, eager_losses, eager_steps = _run(dead, cfg, every_group, False, 1, target,
                                            monkeypatch)
    plan, plan_losses, plan_steps = _run(dead, cfg, every_group, True, 1, target,
                                         monkeypatch)
    n_chunks = W * H * 4 // cfg.ray_chunk
    per_pass = 2 if remat else 1
    assert eager_steps == n_chunks * per_pass
    assert plan_steps == n_chunks * cfg.diff_max_depth * per_pass
    assert float(plan_losses[0]) == float(eager_losses[0])
    for k in PARAM_KEYS:
        g = plan.params[k].grad
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_array_equal(g.numpy(), eager.params[k].grad.numpy(), err_msg=k)
    assert bool(plan.params["vertices"].grad.abs().sum() > 0)


@pytest.mark.parametrize("backend,remat,loss_blur", [("cuda", True, 0.0),
                                                     ("cuda_matmul", False, 0.0),
                                                     ("cuda", True, 1.0)])
def test_step_reads_nothing_back(scene, backend, remat, loss_blur):
    """The plan's forward and backward passes under the dispatch guard, with
    the vertices and the field of view free (the pack rebuild, the camera's
    `tanf`, the fetch's backward, remat's recomputation, the blur). The
    CPU's plain Adam reads its step count (the card's is capturable) and
    stays outside; an SGD step runs inside the guard too."""
    cfg = RenderConfig(backend=backend, remat=remat, **DEEP)
    coords, target = torch.from_numpy(_coords()), _target()
    for optimizer, whole in ((_adam("kd", "vertices", "cam_fov"), False),
                             (lambda p: torch.optim.SGD([p["kd"], p["cam_fov"]], lr=1e-3),
                              True)):
        init_state, step_fn = make_train_step(None, cfg, scene, optimizer=optimizer,
                                              loss_blur=loss_blur, device="cpu",
                                              plan=True)
        state = init_state(extract_params(scene))
        _, want = step_fn(state, scene, coords, target)  # binds the buffers
        plan = step_fn.plan
        if whole:
            with _NoHostReads():
                step_fn(state, scene, coords, target)
            continue
        state.opt_state.zero_grad(set_to_none=True)
        with _NoHostReads():
            plan._forward_backward()
        guarded = float(plan._loss)
        # the next step starts from the same parameters: the same loss
        assert float(step_fn(state, scene, coords, target)[1]) == guarded != float(want)
        assert all(bool(torch.isfinite(state.params[k].grad).all())
                   and bool(state.params[k].grad.abs().sum() > 0)
                   for k in ("kd", "vertices", "cam_fov"))


@pytest.mark.parametrize("kw,device,mesh,takes", [
    (dict(), "cuda", None, True),
    (dict(backend="cuda_matmul"), "cuda", None, True),
    (dict(remat=False), "cuda", None, True),
    (dict(backend="torch", partitioning="none"), "cuda", None, True),
    (dict(backend="torch"), "cuda", None, False),  # per-step with_accel
    (dict(), "cuda", "a mesh", False),
    (dict(), "cpu", None, False),
    (dict(backend="cuda_matmul"), "cpu", None, False),
])
def test_which_steps_capture(kw, device, mesh, takes):
    cfg = RenderConfig(quantize="smooth", **kw)
    assert step_graph.uses_step_graph(cfg, device, mesh) is takes
    assert step_graph.uses_step_graph(cfg, torch.device(device), mesh) is takes
    blocker = step_graph.step_graph_blocker(cfg, mesh)
    assert (blocker is None) is (takes or device == "cpu")


def test_plan_choice_and_blockers(scene):
    cfg = RenderConfig(backend="cuda", **KW)
    assert make_train_step(None, cfg, scene, device="cpu")[1].plan is None
    assert make_train_step(None, cfg, scene, device="cpu", plan=True)[1].plan is not None
    assert make_train_step(None, cfg, scene, loss_blur=1.0, device="cpu",
                           plan=True)[1].plan is not None
    with pytest.raises(ValueError, match="object-level boxes"):
        make_train_step(None, RenderConfig(backend="torch", **KW), scene, device="cpu",
                        plan=True)


def test_optimizer_must_be_capturable():
    p = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(ValueError, match="capturable=True"):
        step_graph.require_capturable(torch.optim.Adam(p, lr=1e-2))
    with pytest.raises(ValueError, match="capturable=True"):
        step_graph.require_capturable(torch.optim.AdamW(p, lr=1e-2))
    # constructing one is fine on the CPU (only its step needs a card)
    step_graph.require_capturable(torch.optim.Adam(p, lr=1e-2, capturable=True))
    mixed = torch.optim.Adam([{"params": p[:1]}], lr=1e-2, capturable=True)
    mixed.add_param_group({"params": [torch.zeros(2, requires_grad=True)],
                           "capturable": False})
    with pytest.raises(ValueError, match="Adam with capturable=True"):
        step_graph.require_capturable(mixed)
    step_graph.require_capturable(torch.optim.SGD(p, lr=0.1, momentum=0.9))


def test_plan_binds_a_new_state(scene, tmp_path):
    """The key the plan captures on: the same state after a step keeps it;
    a fresh state, one restored from a checkpoint (new optimizer-state
    tensors) and a new learning rate each change it."""
    cfg = RenderConfig(backend="cuda", **KW)
    init_state, step_fn = make_train_step(None, cfg, scene, optimizer=_adam("kd"),
                                          device="cpu", plan=True)
    coords, target = torch.from_numpy(_coords()), _target()
    state = init_state(extract_params(scene))
    step_fn(state, scene, coords, target)
    key = step_graph._state_key(state, scene, coords, target)
    assert step_graph._same_key(key, step_fn.plan._key)
    step_fn(state, scene, coords, target)
    assert step_graph._same_key(step_graph._state_key(state, scene, coords, target), key)
    fresh = init_state(extract_params(scene))
    step_fn(fresh, scene, coords, target)
    assert not step_graph._same_key(step_graph._state_key(fresh, scene, coords, target), key)
    path = save_train_state(str(tmp_path), state)
    restore_train_state(path, like=state)
    assert not step_graph._same_key(step_graph._state_key(state, scene, coords, target), key)
    key = step_graph._state_key(state, scene, coords, target)
    state.opt_state.param_groups[0]["lr"] = 5e-3
    assert not step_graph._same_key(step_graph._state_key(state, scene, coords, target), key)
    assert not step_graph._same_key(
        step_graph._state_key(state, scene, coords[:512], target[:128]),
        step_graph._state_key(state, scene, coords, target))


# every 20,001st fov from 1 to 179 degrees, and each float32 within 20,000
# ulps of the kernel's and the reduction's thresholds
def _tanf_inputs():
    fov = np.linspace(1.0, 179.0, 20001).astype(np.float32)
    x = fov * np.float32(math.pi / 360.0)
    edges = [np.float32(v).view(np.int32) for v in (math.pi / 4, 0.6744, math.pi / 2)]
    return np.concatenate([x] + [np.arange(e - 20000, e + 20000, dtype=np.int32)
                                 .view(np.float32) for e in edges])


def test_tanf_is_libms_on_the_cpu():
    x = _tanf_inputs()
    libm = tcam._libm_tanf()
    want = np.array([libm(float(v)) for v in x], np.float32)
    got = tcam.tanf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(tcam.tanf(torch.from_numpy(-x)).numpy(), -want)
    outside = torch.tensor([0.0, 1e-5, 2.4, 3.0], dtype=torch.float32)
    assert bool(torch.isnan(tcam.tanf(outside)).all())


@pytest.mark.cuda
def test_make_train_step_captures_on_the_card(scene):
    """On the card the default step is captured after its first call and
    replayed, and its losses and parameters follow the eager step's; a
    replay adds exactly the launches its capture recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    cfg = RenderConfig(backend="cuda", **DEEP)
    coords, target = torch.from_numpy(_coords()).cuda(), _target().cuda()
    runs = []
    for plan in (None, False):
        init_state, step_fn = make_train_step(None, cfg, scene, device="cuda", plan=plan)
        assert (step_fn.plan is not None) is (plan is None)
        state = init_state(extract_params(scene))
        losses = []
        for _ in range(3):
            before = dict(ck.LAUNCHES)
            losses.append(float(step_fn(state, scene, coords, target)[1]))
            added = {k: ck.LAUNCHES[k] - before[k] for k in before}
        runs.append((state, losses, step_fn.plan, added))
    assert step_fn.plan is None
    (graph, losses, step_plan, added), (eager, eager_losses, _, _) = runs
    assert step_plan.last_call == "replay"
    assert added == step_plan.graph_launches and added["nearest_hit"] > 0
    assert losses[0] == eager_losses[0]
    np.testing.assert_allclose(losses, eager_losses, rtol=1e-3)
    for k in PARAM_KEYS:
        scale = float(eager.params[k].abs().max())
        np.testing.assert_allclose(graph.params[k].detach().cpu().numpy(),
                                   eager.params[k].detach().cpu().numpy(),
                                   rtol=1e-3, atol=1e-4 * max(scale, 1.0), err_msg=k)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(None, cfg, scene, device="cuda",
                        optimizer=lambda p: torch.optim.Adam(list(p.values())))[0](
            extract_params(scene))
