"""`render_image` through its plan (`utils/image_graph.ImagePlan`) on the CPU,
where the passes it captures on the card run uncaptured over the same
buffers (`plan=True`).

- the plan against the eager call (`plan=False`) with all 13 parameter
  groups requiring grad, in both modes, on the three backends, with and
  without `remat`, with a tail chunk, for two parameter sets in a row: the
  image bit-equal (`torch.equal`), the gradients within rtol 1e-3 / atol
  1e-4 of a group's largest entry (as `test_torch_grad.py` holds them);
  without grad the same image;
- the plan's gradients against `jax.grad` of the JAX package's
  `render_image`, on the `_jittered` scene with `test_grad_matches_jax`'s
  tolerance;
- a scene whose rays all die at the first bounce: the plan runs every
  bounce step, the eager loop one, and the gradients are finite and equal;
- no pass reads a value back to the host or makes a tensor from Python data
  (what breaks a capture on the card), for each path that captures;
- the no-grad while-loop path through `FramePlan`'s interpreter over the
  plan's buffers, equal to `SceneRenderer`'s frame with the same steps per
  chunk, also after the camera and the vertices move;
- the plan cache, two outstanding images of one plan (each in its own
  slot, both differentiated; more in `test_torch_image_slots.py`),
  `retain_graph` and `create_graph`, and which calls take a plan.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.parallel.train import extract_params as jextract
from raytracing_gpu_tpu.parallel.train import insert_params as jinsert
from raytracing_gpu_tpu.render import render_image as jrender_image

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, render_image
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.parallel.train import (
    PARAM_KEYS,
    extract_params,
    insert_params,
    params_from_numpy,
)
from raytracing_gpu_tpu_torch.utils import image_graph

from test_torch_frame_graph import _NoHostReads
from test_torch_kernels import _jittered

# the package's `render` function shadows the module
R = importlib.import_module("raytracing_gpu_tpu_torch.render")

# 8x8: 256 CPU-mode rays, and 256 GPU-mode rays at aliasing 2; chunks of 96
# leave a tail chunk of 64 in both
SMALL = dict(width=8, height=8, n_lat=6, n_lon=9)
CHUNK = 96
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plans():
    """Every test starts and ends with an empty plan cache."""
    image_graph.clear_image_plans()
    yield
    image_graph.clear_image_plans()


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(**SMALL)


def _cfg(**kw):
    return RenderConfig(**{"quantize": "smooth", "ray_chunk": CHUNK,
                           "diff_max_depth": 3, "aliasing": 2, **kw})


def _moved(params, seed):
    """The parameters with `kd` and `lights_rgb` moved, from a seed."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for k in ("kd", "lights_rgb"):
        noise = rng.uniform(-0.2, 0.2, tuple(params[k].shape)).astype(np.float32)
        out[k] = (params[k] + torch.from_numpy(noise)).clamp(0.05, 1.0)
    return out


def _own(params, grad=True):
    """Own copies of the 13 groups, requiring grad when `grad`."""
    return {k: v.detach().clone().requires_grad_(grad) for k, v in params.items()}


def _image_and_grads(scene, cfg, plan, params=None, **kw):
    """(image, {group: gradient of mean(image)}) with every group requiring
    grad."""
    p = _own(params or extract_params(scene))
    img = render_image(insert_params(scene, p), cfg, device="cpu", plan=plan, **kw)
    img.mean().backward()
    return img.detach(), {k: v.grad for k, v in p.items()}


def _require_close_grads(got, want):
    for k in PARAM_KEYS:
        assert bool(torch.isfinite(got[k]).all()), k
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * scale, err_msg=k)


CASES = {
    "cpu-cuda-remat": dict(backend="cuda"),
    "cpu-cuda-noremat": dict(backend="cuda", remat=False),
    "cpu-matmul-remat": dict(backend="cuda_matmul"),
    "cpu-torch-noremat": dict(backend="torch", partitioning="none", remat=False),
    "cpu-cuda-anyhit": dict(backend="cuda", any_hit_min_tris=0),
    "gpu-cuda-remat": dict(mode="gpu", backend="cuda", max_bounce=2),
    "gpu-matmul-noremat": dict(mode="gpu", backend="cuda_matmul", max_bounce=2,
                               remat=False),
    "gpu-torch-remat": dict(mode="gpu", backend="torch", partitioning="none",
                            max_bounce=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_equals_eager(scene, case):
    """Two calls of one plan (the second with moved parameters) against the
    eager call on the same parameters."""
    cfg = _cfg(**CASES[case])
    for i, params in enumerate((extract_params(scene), _moved(extract_params(scene), 7))):
        want_img, want = _image_and_grads(scene, cfg, False, params)
        got_img, got = _image_and_grads(scene, cfg, True, params)
        assert got_img.shape == (8, 8, 3) and float(got_img.max()) > 0.0
        assert torch.equal(got_img, want_img)
        _require_close_grads(got, want)
        (plan,) = image_graph.image_plans()
        assert (plan.grad, plan.frame_program, plan.last_call) == (True, False, "eager")
        assert plan.generation == i + 1 and plan.captures == 0
    reached = [k for k in PARAM_KEYS if bool(got[k].any())]
    if cfg.mode == "cpu":
        assert {"vertices", "normals", "kd", "cam_fov"} <= set(reached)
    else:  # the downscale's uint8 truncation has a zero derivative
        assert reached == []


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_no_grad_unrolled_plan_equals_eager(scene, mode):
    """Without grad (grad mode off, though the scene's tensors require it)
    the unrolled strategy's plan renders the forward pass alone."""
    cfg = _cfg(mode=mode, max_bounce=2)
    p = _own(extract_params(scene))
    with torch.no_grad():
        got = render_image(insert_params(scene, p), cfg, device="cpu", plan=True)
        want = render_image(insert_params(scene, p), cfg, device="cpu", plan=False)
    assert torch.equal(got, want) and not got.requires_grad
    (plan,) = image_graph.image_plans()
    assert not plan.grad and not plan.frame_program and plan.generation == 1


@pytest.mark.parametrize("port_backend,jax_backend", [("torch", "jnp"),
                                                      ("cuda", "pallas")])
def test_plan_grads_match_jax(port_backend, jax_backend):
    kw = dict(mode="cpu", quantize="smooth", ray_chunk=512, diff_max_depth=2,
              partitioning="none")
    jscene = _jittered(jproc.make_sphere_scene(**SMALL))
    dev = scene_to_device(jscene)
    jparams = jextract(dev)
    jcfg = JConfig(backend=jax_backend, **kw)
    want = jax.grad(lambda p: jnp.mean(jrender_image(jinsert(dev, p), jcfg)))(jparams)
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               device="cpu")
    _, got = _image_and_grads(scene_from_numpy(jscene),
                              RenderConfig(backend=port_backend, **kw), True, params)
    assert image_graph.image_plans()[0].last_call == "eager"
    for k in PARAM_KEYS:
        w = np.asarray(want[k])
        assert np.isfinite(got[k].numpy()).all(), k
        assert np.abs(w).max() > 0.0, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _dead_after_first_bounce(scene):
    """No mirror in view: every real object's nr is 0 (one object without
    triangles keeps 0.5)."""
    nr = torch.zeros_like(scene.materials.nr)
    nr[scene.n_objects] = 0.5
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, nr=nr))


def _count_bounce_steps(monkeypatch):
    calls = [0]
    step = R._bounce_step

    def counting(*args):
        calls[0] += 1
        return step(*args)

    monkeypatch.setattr(R, "_bounce_step", counting)
    return calls


@pytest.mark.parametrize("kw", [dict(backend="cuda"),
                                dict(backend="cuda_matmul", remat=False),
                                dict(mode="gpu", backend="cuda", max_bounce=3)],
                         ids=["cpu-cuda-remat", "cpu-matmul-noremat", "gpu-cuda-remat"])
def test_fixed_depth_gradients_on_a_dead_scene(scene, kw, monkeypatch):
    """Every ray dies at the first bounce: the eager loop stops there, the
    plan runs every other step with every ray parked. The gradients of all
    13 groups are finite and equal."""
    dead = _dead_after_first_bounce(scene)
    cfg = _cfg(diff_max_depth=4, **kw)
    calls = _count_bounce_steps(monkeypatch)
    want_img, want = _image_and_grads(dead, cfg, False)
    eager_steps, calls[0] = calls[0], 0
    got_img, got = _image_and_grads(dead, cfg, True)
    n_chunks = -(-256 // CHUNK)
    per_pass = 2 if cfg.remat else 1
    depth = cfg.max_bounce + 1 if cfg.mode == "gpu" else cfg.diff_max_depth
    assert eager_steps == n_chunks * per_pass
    assert calls[0] == n_chunks * depth * per_pass
    assert torch.equal(got_img, want_img)
    for k in PARAM_KEYS:
        assert bool(torch.isfinite(got[k]).all()), k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # GPU mode's downscale truncates to uint8: a zero derivative
    assert bool(got["vertices"].abs().sum() > 0) is (cfg.mode == "cpu")


@pytest.mark.parametrize("kw,grad", [
    (dict(backend="cuda"), True),
    (dict(mode="gpu", backend="cuda_matmul", max_bounce=2), True),
    (dict(backend="cuda"), False),
    (dict(quantize="match", backend="cuda"), False),
    (dict(quantize="match", mode="gpu", backend="cuda", max_bounce=2), False),
], ids=["grad-cpu", "grad-gpu-matmul", "nograd-unrolled", "nograd-frame-cpu",
        "nograd-frame-gpu"])
def test_passes_read_nothing_back(scene, kw, grad):
    """A call after the one that made the plan, forward and backward, under
    the dispatch guard, with the vertices and the field of view among the
    grad-requiring tensors (the pack rebuild, the camera's `tanf`)."""
    cfg = _cfg(**kw)
    p = _own(extract_params(scene), grad)
    moved = insert_params(scene, p)
    with torch.set_grad_enabled(grad):
        want = render_image(moved, cfg, device="cpu", plan=True)
        with _NoHostReads():
            got = render_image(moved, cfg, device="cpu", plan=True)
            if grad:
                got.mean().backward()
    assert torch.equal(got.detach(), want.detach())
    (plan,) = image_graph.image_plans()
    assert plan.generation == 2 and plan.grad is grad
    assert plan.frame_program is (cfg.quantize == "match")
    if grad:  # GPU mode's downscale truncates to uint8: a zero derivative
        for k in ("kd", "vertices", "cam_fov"):
            assert bool(torch.isfinite(p[k].grad).all()), k
            assert bool(p[k].grad.abs().sum() > 0) is (cfg.mode == "cpu"), k


def _moved_scene(scene):
    """The camera moved and turned, the field of view widened, and the
    vertices shifted: a new pack and a new basis."""
    cam = dataclasses.replace(scene.camera, position=scene.camera.position + 0.05,
                              u=scene.camera.u + 0.02, fov=scene.camera.fov + 3.0)
    rng = np.random.default_rng(3)
    v = scene.geometry.vertices
    geo = dataclasses.replace(scene.geometry, vertices=v + torch.from_numpy(
        rng.uniform(-0.01, 0.01, tuple(v.shape)).astype(np.float32)))
    return dataclasses.replace(scene, camera=cam, geometry=geo)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_no_grad_match_path_equals_scene_renderer(scene, mode):
    """The while-loop strategy without grad: the plan's frame program
    (`FramePlan` interpreted over the plan's scene, pack and basis) equals
    `SceneRenderer`'s frame with the same steps per chunk; a second call
    with the camera and the vertices moved equals a fresh renderer of the
    moved scene."""
    cfg = RenderConfig(mode=mode, backend="cuda", ray_chunk=CHUNK, aliasing=2)
    for i, s in enumerate((scene, _moved_scene(scene))):
        got = render_image(s, cfg, device="cpu")  # the CPU default: eager
        assert len(image_graph.image_plans()) == i
        r = SceneRenderer(s, cfg, device="cpu")
        want = r.render_device()
        assert torch.equal(got, want)
        got = render_image(s, cfg, device="cpu", plan=True)
        assert torch.equal(got, want)
        (plan,) = image_graph.image_plans()
        assert plan.frame_program and plan.generation == i + 1
        ref = R.frame_plan(r.scene, cfg, r.depth, r.pack)
        assert torch.equal(ref.render(), want)
        assert plan._frame.last_frame.steps == ref.last_frame.steps
    assert not torch.equal(got, render_image(scene, cfg, device="cpu", plan=True))


def test_the_plan_cache(scene):
    """The same key replays the same plan; another set of grad-requiring
    tensors, config, depth or image size makes another; at most MAX_PLANS
    are kept, the least recently used dropped first."""
    small = make_sphere_scene(4, 4, n_lat=6, n_lon=9)
    cfg = _cfg(diff_max_depth=1)

    def call(s, c=cfg, depth=None, groups=("kd",)):
        p = {k: v.detach().clone().requires_grad_(k in groups)
             for k, v in extract_params(s).items()}
        render_image(insert_params(s, p), c, depth=depth, device="cpu", plan=True)
        return image_graph.image_plans()[-1]

    first = call(small)
    assert call(small) is first and first.generation == 2
    others = [call(small, groups=("kd", "vertices")),
              call(small, c=dataclasses.replace(cfg, remat=False)),
              call(small, depth=2)]
    assert len({id(p) for p in [first, *others]}) == 4
    assert image_graph.image_plans() == [first, *others]
    assert call(small) is first  # now the most recently used
    bigger = call(scene)
    assert bigger not in (first, *others)
    assert len(image_graph.image_plans()) == image_graph.MAX_PLANS == 4
    assert others[0] not in image_graph.image_plans()  # the least recently used
    assert call(small, groups=("kd", "vertices")) is not others[0]


def test_grad_and_no_grad_calls_keep_plans_apart(scene):
    cfg = _cfg(diff_max_depth=1)
    p = _own(extract_params(scene))
    s = insert_params(scene, p)
    render_image(s, cfg, device="cpu", plan=True)
    with torch.no_grad():
        render_image(s, cfg, device="cpu", plan=True)
    grad_plan, plain_plan = image_graph.image_plans()
    assert grad_plan.grad and not plain_plan.grad


def test_stale_forward_raises(scene):
    """Two forward passes of one plan, then the first image's backward: it
    no longer raises (each outstanding image has a slot of its own), and
    the first image's gradient equals its eager one; the second image's
    backward after it equals its own."""
    cfg = _cfg()
    p = _own(extract_params(scene))
    first = render_image(insert_params(scene, p), cfg, device="cpu", plan=True)
    moved = _moved(extract_params(scene), 11)
    q = _own(moved)
    second = render_image(insert_params(scene, q), cfg, device="cpu", plan=True)
    first.mean().backward()
    assert all(v.grad is None for v in q.values())
    _, want = _image_and_grads(scene, cfg, False)
    _require_close_grads({k: v.grad for k, v in p.items()}, want)
    second.mean().backward()
    _, want = _image_and_grads(scene, cfg, False, moved)
    _require_close_grads({k: v.grad for k, v in q.items()}, want)
    (plan,) = image_graph.image_plans()
    assert len(plan.slots) == 2 and plan.generation == 2


def test_retain_graph_twice_on_the_newest_image(scene):
    """`backward(retain_graph=True)` twice replays the backward pass twice
    (`remat` recomputes each step twice): the gradients add up, as the
    eager call's do."""
    cfg = _cfg()
    got = {}
    for plan in (True, False):
        p = _own(extract_params(scene))
        loss = render_image(insert_params(scene, p), cfg, device="cpu", plan=plan).mean()
        loss.backward(retain_graph=True)
        once = {k: v.grad.clone() for k, v in p.items()}
        loss.backward(retain_graph=True)
        for k in PARAM_KEYS:
            torch.testing.assert_close(p[k].grad, 2 * once[k], rtol=0, atol=0)
        got[plan] = {k: v.grad for k, v in p.items()}
    _require_close_grads(got[True], got[False])


def test_create_graph_raises(scene):
    cfg = _cfg(diff_max_depth=1)
    p = _own(extract_params(scene))
    img = render_image(insert_params(scene, p), cfg, device="cpu", plan=True)
    with pytest.raises(RuntimeError, match="once-differentiable"):
        torch.autograd.grad(img.mean(), [p["kd"]], create_graph=True)


@pytest.mark.parametrize("kw,device,grad,takes", [
    (dict(quantize="smooth"), "cuda", True, True),
    (dict(quantize="smooth", unroll="static", backend="cuda_matmul"), "cuda", True, True),
    (dict(quantize="match", unroll="static"), "cuda", True, True),
    (dict(quantize="match"), "cuda", False, True),                 # the frame program
    (dict(quantize="smooth", unroll="while"), "cuda", False, True),
    (dict(quantize="smooth", backend="torch", partitioning="none"), "cuda", True, True),
    (dict(quantize="match"), "cuda", True, False),                 # no reverse mode
    (dict(quantize="smooth", unroll="while"), "cuda", True, False),
    (dict(quantize="smooth", backend="torch"), "cuda", True, False),  # with_accel
    (dict(quantize="match", backend="torch"), "cuda", False, False),
    (dict(quantize="smooth"), "cpu", True, False),
    (dict(quantize="match"), "cpu", False, False),
])
def test_which_calls_capture(kw, device, grad, takes):
    cfg = RenderConfig(**kw)
    assert image_graph.uses_image_graph(cfg, device, grad) is takes
    assert image_graph.uses_image_graph(cfg, torch.device(device), grad) is takes
    blocker = image_graph.image_graph_blocker(cfg, grad)
    assert (blocker is None) is (takes or device == "cpu")


def test_plan_true_raises_with_the_reason(scene):
    p = _own(extract_params(scene))
    with pytest.raises(ValueError, match="plan=True.*lax.while_loop"):
        render_image(insert_params(scene, p), RenderConfig(quantize="match"),
                     device="cpu", plan=True)
    with pytest.raises(ValueError, match="plan=True.*with_accel"):
        render_image(scene, RenderConfig(backend="torch"), device="cpu", plan=True)
    assert not image_graph.image_plans()


def test_defaults_and_plan_false(scene):
    """On the CPU `plan=None` renders eagerly and makes no plan, as
    `plan=False` does anywhere; without `device="cpu"` and without a card
    the call raises."""
    cfg = _cfg(diff_max_depth=1)
    render_image(scene, cfg, device="cpu")
    render_image(scene, cfg, device="cpu", plan=False)
    assert not image_graph.image_plans()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(scene, cfg, plan=True)


@pytest.mark.cuda
def test_render_image_replays_on_the_card(scene):
    """On the card the first call captures, the next replays two graphs per
    forward and backward pass, adding exactly the launches their captures
    recorded, and the image and gradients follow the eager call's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    cfg = _cfg()
    runs = {}
    for plan in (None, False, None):
        p = {k: v.detach().clone().cuda().requires_grad_()
             for k, v in extract_params(scene).items()}
        before = dict(ck.LAUNCHES)
        img = render_image(insert_params(scene.to("cuda"), p), cfg, plan=plan)
        img.mean().backward()
        added = {k: ck.LAUNCHES[k] - before[k] for k in before}
        runs.setdefault(plan, []).append((img.detach().cpu(),
                                          {k: v.grad.cpu() for k, v in p.items()}))
    (plan,) = image_graph.image_plans()
    assert (plan.captures, plan.replays, plan.last_call) == (1, 1, "replay")
    (slot,) = plan.slots
    replayed = {k: slot.forward_launches[k] + slot.backward_launches[k] for k in added}
    assert added == replayed and replayed["nearest_hit"] > 0
    (eager_img, eager), = runs[False]
    for img, grads in runs[None]:
        assert torch.equal(img, eager_img)
        _require_close_grads(grads, eager)
