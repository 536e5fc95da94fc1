"""Several outstanding images of one `render_image` plan on the CPU
(`plan=True`: the slots' passes run uncaptured over their own buffers), on
the 8x8 sphere scene of `test_torch_image_graph.py`:

- two views of one scene (the camera moved and turned) through one plan,
  `(a.mean() + b.mean()).backward()`, against the same with `plan=False`
  and against `jax.grad` of the JAX package's `render_image` sum;
- backward passes in the reverse order of the forward passes, and
  `backward(retain_graph=True)` twice on an older image, each against its
  own eager call;
- which slot a call takes: a training loop reuses one, a dropped image
  frees its slot, beyond `MAX_SLOTS` outstanding images a call renders
  eagerly and is counted, and the choice reads nothing back to the host;
- under a saved-tensor hook that copies what autograd saves (the slot's
  token too, so the slot is freed as the forward pass returns): one image
  still gets its eager gradient, and an image whose slot a later forward
  pass took raises instead of returning that image's gradients.

Images are held bit-equal (`torch.equal`), gradients within rtol 1e-3 /
atol 1e-4 of a group's largest entry.
"""

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

from raytracing_gpu_tpu_torch import RenderConfig, render_image
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.parallel.train import (
    PARAM_KEYS,
    extract_params,
    insert_params,
    params_from_numpy,
)
from raytracing_gpu_tpu_torch.utils import image_graph

from test_torch_frame_graph import _NoHostReads
from test_torch_image_graph import SMALL, _cfg, _moved, _own, _require_close_grads
from test_torch_kernels import _jittered

# the second view: the camera moved and turned (`chip_smoke.moved_scene`)
VIEW_B = {"cam_position": 0.05, "cam_u": 0.01}


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


def _view_b(params):
    """The parameters of the second view, computed from the first's (so
    its gradient reaches them)."""
    return {**params, **{k: params[k] + d for k, d in VIEW_B.items()}}


def _render(scene, params, cfg, plan):
    return render_image(insert_params(scene, params), cfg, device="cpu", plan=plan)


def _grads(params):
    return {k: v.grad for k, v in params.items()}


def _eager(scene, cfg, params):
    """(image, {group: gradient of mean(image)}) of the eager call."""
    p = _own(params)
    img = _render(scene, p, cfg, False)
    img.mean().backward()
    return img.detach(), _grads(p)


def _plan():
    (plan,) = image_graph.image_plans()
    return plan


def _busy(plan):
    return [s.busy for s in plan.slots]


@pytest.mark.parametrize("kw", [dict(backend="cuda"),
                                dict(backend="cuda_matmul", remat=False)],
                         ids=["cuda-remat", "matmul-noremat"])
def test_two_views_through_one_plan(scene, kw):
    """Two views of one scene, one plan, two slots: the sum's gradient and
    both images as the eager calls give them."""
    cfg = _cfg(**kw)
    got = {}
    for plan in (True, False):
        p = _own(extract_params(scene))
        a = _render(scene, p, cfg, plan)
        b = _render(scene, _view_b(p), cfg, plan)
        (a.mean() + b.mean()).backward()
        got[plan] = (a.detach(), b.detach(), _grads(p))
    assert torch.equal(got[True][0], got[False][0])
    assert torch.equal(got[True][1], got[False][1])
    assert not torch.equal(got[True][0], got[True][1])
    _require_close_grads(got[True][2], got[False][2])
    plan = _plan()
    assert len(plan.slots) == 2 and plan.generation == 2 and plan.eager_calls == 0
    assert _busy(plan) == [False, False]


def test_two_views_match_jax(scene):
    """The sum over two views against `jax.grad` of the JAX package's
    `render_image` sum, on the `_jittered` scene with
    `test_grad_matches_jax`'s tolerance; inputs from one numpy seed."""
    kw = dict(mode="cpu", quantize="smooth", ray_chunk=512, diff_max_depth=2,
              partitioning="none")
    jscene = _jittered(jproc.make_sphere_scene(**SMALL))
    dev = scene_to_device(jscene)
    jcfg = JConfig(backend="pallas", **kw)

    def loss(p):
        q = {**p, **{k: p[k] + d for k, d in VIEW_B.items()}}
        return (jnp.mean(jrender_image(jinsert(dev, p), jcfg))
                + jnp.mean(jrender_image(jinsert(dev, q), jcfg)))

    jparams = jextract(dev)
    want = jax.grad(loss)(jparams)
    p = _own(params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               device="cpu"))
    s = scene_from_numpy(jscene)
    cfg = RenderConfig(backend="cuda", **kw)
    a = _render(s, p, cfg, True)
    b = _render(s, _view_b(p), cfg, True)
    (a.mean() + b.mean()).backward()
    assert len(_plan().slots) == 2
    for k in PARAM_KEYS:
        w = np.asarray(want[k])
        g = p[k].grad.numpy()
        assert np.isfinite(g).all(), k
        assert np.abs(w).max() > 0.0, k
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_backward_in_reverse_order(scene):
    """Forward a, forward b, backward b, backward a: each gradient its own
    eager call's."""
    cfg = _cfg()
    pa, pb = extract_params(scene), _moved(extract_params(scene), 5)
    a_own, b_own = _own(pa), _own(pb)
    a = _render(scene, a_own, cfg, True)
    b = _render(scene, b_own, cfg, True)
    b.mean().backward()
    assert _busy(_plan()) == [True, False]
    a.mean().backward()
    for img, own, params in ((a, a_own, pa), (b, b_own, pb)):
        want_img, want = _eager(scene, cfg, params)
        assert torch.equal(img.detach(), want_img)
        _require_close_grads(_grads(own), want)
    assert _busy(_plan()) == [False, False]


def test_a_training_loop_reuses_one_slot(scene):
    """Five steps of `loss = render_image(...).mean(); loss.backward()`,
    each with new parameters: one slot, and the last step's gradient the
    eager call's."""
    cfg = _cfg()
    for step in range(5):
        params = _moved(extract_params(scene), 100 + step)
        p = _own(params)
        loss = _render(scene, p, cfg, True).mean()
        loss.backward()
    plan = _plan()
    assert len(plan.slots) == 1 and plan.generation == 5 and _busy(plan) == [False]
    _require_close_grads(_grads(p), _eager(scene, cfg, params)[1])


def test_retain_graph_twice_on_an_older_image(scene):
    """`backward(retain_graph=True)` twice on the older of two outstanding
    images gives twice its eager gradient; its slot stays busy until its
    loss is dropped."""
    cfg = _cfg()
    p = _own(extract_params(scene))
    loss = _render(scene, p, cfg, True).mean()
    q = _own(_moved(extract_params(scene), 9))
    newer = _render(scene, q, cfg, True)
    loss.backward(retain_graph=True)
    loss.backward(retain_graph=True)
    want = _eager(scene, cfg, extract_params(scene))[1]
    _require_close_grads(_grads(p), {k: 2 * v for k, v in want.items()})
    plan = _plan()
    assert _busy(plan) == [True, True]
    del loss
    assert _busy(plan) == [False, True]
    newer.mean().backward()
    _require_close_grads(_grads(q), _eager(scene, cfg, _moved(extract_params(scene), 9))[1])


def test_a_dropped_image_frees_its_slot(scene):
    """An image dropped without a backward pass (also after a tensor
    computed from it) frees its slot for the next call, whose gradient is
    its own."""
    cfg = _cfg(diff_max_depth=2)
    img = _render(scene, _own(extract_params(scene)), cfg, True)
    plan = _plan()
    del img
    assert _busy(plan) == [False]
    img = _render(scene, _own(extract_params(scene)), cfg, True)
    loss = img.mean()
    del img
    assert _busy(plan) == [True]
    del loss
    assert _busy(plan) == [False]
    params = _moved(extract_params(scene), 13)
    p = _own(params)
    _render(scene, p, cfg, True).mean().backward()
    assert len(plan.slots) == 1 and plan.generation == 3
    _require_close_grads(_grads(p), _eager(scene, cfg, params)[1])


def test_beyond_max_slots_renders_eagerly(scene, monkeypatch):
    """With `MAX_SLOTS` 2, a third outstanding image renders eagerly, is
    counted, and the sum of the three images' means has the eager
    gradient; then the slots are free again."""
    monkeypatch.setattr(image_graph, "MAX_SLOTS", 2)
    cfg = _cfg(diff_max_depth=2)
    moves = [None, 21, 22]
    got = {}
    for plan in (True, False):
        p = _own(extract_params(scene))
        loss = 0.0
        for seed in moves:
            params = p if seed is None else {**p, **{
                k: v + float(seed) * 1e-3 for k, v in p.items() if k in ("kd", "lights_rgb")}}
            loss = loss + _render(scene, params, cfg, plan).mean()
        loss.backward()
        got[plan] = _grads(p)
    plan = _plan()
    assert len(plan.slots) == 2 and plan.eager_calls == 1 and plan.generation == 2
    assert _busy(plan) == [False, False]
    _require_close_grads(got[True], got[False])


def test_slot_choice_reads_nothing_back(scene):
    """A new slot, a busy one skipped, both freed and one taken again, and
    the backward passes, under the dispatch guard."""
    cfg = _cfg(diff_max_depth=2)
    want = [_eager(scene, cfg, _moved(extract_params(scene), s))
            for s in (31, 32)]
    p, q = (_own(_moved(extract_params(scene), s)) for s in (31, 32))
    _render(scene, _own(extract_params(scene)), cfg, True)  # makes the plan
    with _NoHostReads():
        a = _render(scene, p, cfg, True)
        b = _render(scene, q, cfg, True)
        (a.mean() + b.mean()).backward()
        c = _render(scene, _own(extract_params(scene)), cfg, True)
    plan = _plan()
    assert len(plan.slots) == 2 and _busy(plan) == [True, False]
    del c
    for img, own, (want_img, want_grads) in ((a, p, want[0]), (b, q, want[1])):
        assert torch.equal(img.detach(), want_img)
        _require_close_grads(_grads(own), want_grads)


def _copying_hooks():
    """Saved-tensor hooks that keep a copy of each saved tensor, as
    `torch.autograd.graph.save_on_cpu` does."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t.clone(), lambda t: t)


def test_copying_hook_one_image_at_a_time(scene):
    """Under a copying hook the token dies with the forward pass, so the
    slot is free at once; an image differentiated before the next forward
    pass still has its eager gradient, step after step."""
    cfg = _cfg(diff_max_depth=2)
    for seed in (41, 42):
        params = _moved(extract_params(scene), seed)
        p = _own(params)
        with _copying_hooks():
            img = _render(scene, p, cfg, True)
            assert _busy(_plan()) == [False]
            img.mean().backward()
        _require_close_grads(_grads(p), _eager(scene, cfg, params)[1])
    assert len(_plan().slots) == 1


def test_copying_hook_reused_slot_raises(scene):
    """Under a copying hook two outstanding images share the slot freed
    early: the older image's backward pass raises rather than return the
    newer image's gradients."""
    cfg = _cfg(diff_max_depth=2)
    p = _own(extract_params(scene))
    with _copying_hooks():
        a = _render(scene, p, cfg, True)
        b = _render(scene, _view_b(p), cfg, True)
        assert len(_plan().slots) == 1
        with pytest.raises(RuntimeError, match="later forward pass has taken it"):
            (a.mean() + b.mean()).backward()


@pytest.mark.cuda
def test_two_views_on_the_card(scene):
    """On the card two views of one plan capture a second slot; images and
    the sum's gradient follow the eager calls'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    cfg = _cfg()
    got = {}
    for plan in (None, False):
        p = {k: v.detach().clone().cuda().requires_grad_()
             for k, v in extract_params(scene).items()}
        imgs = [render_image(insert_params(scene.to("cuda"), q), cfg, plan=plan)
                for q in (p, _view_b(p))]
        sum(img.mean() for img in imgs).backward()
        got[plan] = ([img.detach().cpu() for img in imgs],
                     {k: v.grad.cpu() for k, v in p.items()})
    plan = _plan()
    assert (plan.captures, len(plan.slots), _busy(plan)) == (2, 2, [False, False])
    for g, e in zip(got[None][0], got[False][0]):
        assert torch.equal(g, e)
    _require_close_grads(got[None][1], got[False][1])
