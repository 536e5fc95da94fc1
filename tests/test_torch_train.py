"""The port's single-device training step against the JAX package's.

The same scene, coordinates, target and starting parameters (numpy) go
through the JAX package's `make_train_step` on a 1x1 mesh and the port's.
Tolerances:
- `predict_pixels`: atol 2e-5 in the [0,1] domain (float32 shading chains,
  FMA contraction under jit);
- the first 3 losses of kd recovery by SGD: rtol 2e-4. The losses are sums
  over 256 pixels of squared float32 residuals, and each later loss also
  carries the earlier gradients' rounding;
- Adam: the parameters after each of 3 steps against a numpy transcription
  of optax's `adam` update applied to the port's own gradients, rtol 1e-5
  atol 1e-7.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import camera as jcam
from raytracing_gpu_tpu.parallel import make_mesh
from raytracing_gpu_tpu.parallel import make_train_step as jmake_train_step
from raytracing_gpu_tpu.parallel.render import split_scene
from raytracing_gpu_tpu.parallel.train import PARAM_SPECS
from raytracing_gpu_tpu.parallel.train import extract_params as jextract
from raytracing_gpu_tpu.parallel.train import predict_pixels as jpredict
from raytracing_gpu_tpu.render import render_scene as jrender

from raytracing_gpu_tpu_torch import RenderConfig
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import camera as tcam
from raytracing_gpu_tpu_torch.parallel import (
    TrainState,
    extract_params,
    init_train_state,
    insert_params,
    make_train_step,
    predict_pixels,
)
from raytracing_gpu_tpu_torch.parallel.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    resume_or_init,
    save_train_state,
)
from raytracing_gpu_tpu_torch.parallel.train import (
    PARAM_KEYS,
    _blur_residual,
    params_from_numpy,
    params_to_numpy,
)

from test_torch_kernels import _jittered

W = H = 16
KW = dict(mode="cpu", quantize="smooth", ray_chunk=512, diff_max_depth=2)
WRONG_KD = np.array([0.9, 0.9, 0.1], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jscene():
    # jittered: the symmetric scene's centre column runs along a seam of
    # exact ties, which the jitted JAX render breaks the other way
    return _jittered(jproc.make_sphere_scene(width=W, height=H, n_lat=8, n_lon=12))


@pytest.fixture(scope="module")
def tscene(jscene):
    return scene_from_numpy(jscene)


def _coords():
    return np.asarray(jcam.cpu_subpixel_coords(W, H)).reshape(-1, 2)


def _sgd_on_kd(lr=2.0):
    return lambda p: torch.optim.SGD([p["kd"]], lr=lr)


def test_params_round_trip_and_bridge(jscene, tscene):
    jparams = {k: np.asarray(v) for k, v in jextract(scene_to_device(jscene)).items()}
    assert sorted(jparams) == sorted(PARAM_KEYS) == sorted(PARAM_SPECS)
    params = extract_params(tscene)
    assert list(params) == list(PARAM_KEYS)
    bridged = params_from_numpy(jparams)
    for k in PARAM_KEYS:
        assert bridged[k].dtype == torch.float32
        assert torch.equal(bridged[k], params[k]), k
    back = params_to_numpy(bridged)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(back[k], jparams[k], err_msg=k)
    # insert(extract) is the identity, and insert puts every group in place
    again = extract_params(insert_params(tscene, params))
    assert all(again[k] is params[k] for k in PARAM_KEYS)
    moved = {k: v + 1.0 for k, v in params.items()}
    scene2 = insert_params(tscene, moved)
    assert all(torch.equal(extract_params(scene2)[k], moved[k]) for k in PARAM_KEYS)
    assert scene2.geometry.tri_obj is tscene.geometry.tri_obj
    assert scene2.lights.kind == tscene.lights.kind


@pytest.mark.parametrize("port_backend,jax_backend", [("torch", "jnp"), ("cuda", "pallas")])
def test_predict_pixels_matches_jax(jscene, tscene, port_backend, jax_backend):
    coords = _coords()
    want = np.asarray(jax.jit(lambda s, c: jpredict(s, JConfig(backend=jax_backend, **KW), 2, c))(
        scene_to_device(jscene), jnp.asarray(coords)))
    with torch.no_grad():
        got = predict_pixels(tscene, RenderConfig(backend=port_backend, **KW), 2,
                             torch.from_numpy(coords), device="cpu").numpy()
    assert got.shape == want.shape == (W * H, 3) and got.max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the port's own coordinates are the JAX package's
    ids = torch.arange(W * H * 4)
    np.testing.assert_array_equal(tcam.cpu_subpixel_coords_traced(W, H, ids).numpy(), coords)


def _jax_losses(jscene, jcfg, target, n_steps):
    import optax

    dev = scene_to_device(jscene)
    params0 = jextract(dev)
    params0["kd"] = params0["kd"].at[0].set(jnp.asarray(WRONG_KD))
    opt = optax.chain(
        optax.masked(optax.set_to_zero(), {k: k != "kd" for k in PARAM_SPECS}),
        optax.sgd(2.0))
    init_state, step_fn = jmake_train_step(make_mesh(1, 1), jcfg, dev, optimizer=opt)
    state = init_state(params0)
    geo, rest = split_scene(dev)
    losses = []
    for _ in range(n_steps):
        state, loss = step_fn(state, geo, rest, jnp.asarray(_coords()),
                              jnp.asarray(target), W * H)
        losses.append(float(loss))
    return losses, np.asarray(state.params["kd"])


@pytest.mark.parametrize("port_backend,jax_backend,partitioning,n_steps", [
    ("torch", "jnp", "none", 10),     # test_train_step_reduces_loss
    ("cuda", "pallas", "octree", 6),  # test_train_step_accelerated: tile hierarchy
    ("torch", "jnp", "octree", 6),    # ... and the per-step object-level accel
])
def test_train_step_reduces_loss(jscene, tscene, port_backend, jax_backend,
                                 partitioning, n_steps):
    """Recover a perturbed diffuse color with every other group frozen: the
    loss falls, kd moves toward the truth, and the first losses are the JAX
    package's."""
    jcfg = JConfig(backend=jax_backend, partitioning=partitioning, **KW)
    target = (np.asarray(jrender(jscene, jcfg)) / 255.0).reshape(-1, 3).astype(np.float32)
    cfg = RenderConfig(backend=port_backend, partitioning=partitioning, **KW)
    true_kd = tscene.materials.kd[0].clone()
    params0 = dict(extract_params(tscene))
    params0["kd"] = params0["kd"].clone()
    params0["kd"][0] = torch.from_numpy(WRONG_KD)
    init_state, step_fn = make_train_step(cfg, tscene, optimizer=_sgd_on_kd(),
                                          device="cpu")
    state = init_state(params0)
    assert [k for k, p in state.params.items() if p.requires_grad] == ["kd"]
    coords, tgt = torch.from_numpy(_coords()), torch.from_numpy(target)
    losses = []
    for i in range(n_steps):
        state, loss = step_fn(state, tscene, coords, tgt)
        assert state.step == i + 1
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.95, losses
    err0 = float((params0["kd"][0] - true_kd).abs().sum())
    err1 = float((state.params["kd"][0].detach() - true_kd).abs().sum())
    assert err1 < err0
    # frozen groups did not move, and the caller's tensors were not touched
    assert torch.equal(state.params["vertices"], tscene.geometry.vertices)
    assert torch.equal(params0["kd"][0], torch.from_numpy(WRONG_KD))
    want, _ = _jax_losses(jscene, jcfg, target, 3)
    np.testing.assert_allclose(losses[:3], want, rtol=2e-4)


def _optax_adam(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam's update in numpy float32: scale_by_adam (bias-corrected
    moments, eps outside the root, eps_root 0) then scale(-lr)."""
    f = np.float32
    m = f(b1) * m + f(1 - b1) * g
    v = f(b2) * v + f(1 - b2) * g * g
    mhat = m / f(1 - b1 ** t)
    vhat = v / f(1 - b2 ** t)
    return f(-lr) * mhat / (np.sqrt(vhat) + f(eps)), m, v


def test_adam_is_optax_adam(tscene):
    """The default optimizer (`torch.optim.Adam`) moves every group as
    optax's adam would on the same gradients."""
    cfg = RenderConfig(backend="cuda", **KW)
    init_state, step_fn = make_train_step(cfg, tscene, learning_rate=1e-2, device="cpu")
    state = init_state(extract_params(tscene))
    assert all(p.requires_grad for p in state.params.values())
    coords = torch.from_numpy(_coords())
    target = torch.zeros((W * H, 3))
    m = {k: np.zeros(tuple(p.shape), np.float32) for k, p in state.params.items()}
    v = {k: np.zeros(tuple(p.shape), np.float32) for k, p in state.params.items()}
    for t in range(1, 4):
        before = params_to_numpy(state.params)
        state, loss = step_fn(state, tscene, coords, target)
        assert np.isfinite(float(loss))
        for k in PARAM_KEYS:
            g = state.params[k].grad.numpy()
            upd, m[k], v[k] = _optax_adam(g, m[k], v[k], t, 1e-2)
            np.testing.assert_allclose(state.params[k].detach().numpy(), before[k] + upd,
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {t}")
    assert float((state.params["vertices"].detach()
                  - tscene.geometry.vertices).abs().sum()) > 0.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chunkwise_backward_is_the_whole_image_gradient(tscene, backend):
    """The step's chunk-by-chunk backward (4 chunks of 256 rays) leaves the
    gradient of the whole image's loss: rtol 1e-4, atol 1e-6 of the group's
    largest entry (the chunks' sums are added in another order). Not held
    for "cuda_matmul", whose sweeps recentre on each chunk's rays, so its
    winners on exact edges depend on the chunking."""
    cfg = RenderConfig(backend=backend, **dict(KW, ray_chunk=256))
    coords = torch.from_numpy(_coords())
    target = torch.full((W * H, 3), 0.25)
    init_state, step_fn = make_train_step(
        cfg, tscene, optimizer=lambda p: torch.optim.SGD(list(p.values()), lr=0.0),
        device="cpu")
    state, loss = step_fn(init_state(extract_params(tscene)), tscene, coords, target)
    p = {k: v.detach().clone().requires_grad_() for k, v in extract_params(tscene).items()}
    whole_cfg = dataclasses.replace(cfg, ray_chunk=W * H * 4)
    err = predict_pixels(insert_params(tscene, p), whole_cfg, 2, coords,
                         device="cpu") - target
    want_loss = (err * err).sum() / (3 * W * H)
    want_loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k in PARAM_KEYS:
        w = p[k].grad.numpy()
        np.testing.assert_allclose(state.params[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1.0), err_msg=k)


def test_loss_blur(tscene):
    cfg = RenderConfig(backend="cuda", **KW)
    coords, target = torch.from_numpy(_coords()), torch.zeros((W * H, 3))
    init_state, step_fn = make_train_step(cfg, tscene, optimizer=_sgd_on_kd(0.1),
                                          loss_blur=1.0, device="cpu")
    state, blurred = step_fn(init_state(extract_params(tscene)), tscene, coords, target)
    _, step_plain = make_train_step(cfg, tscene, optimizer=_sgd_on_kd(0.1), device="cpu")
    _, plain = step_plain(init_state(extract_params(tscene)), tscene, coords, target)
    assert np.isfinite(float(blurred)) and 0.0 < float(blurred) < float(plain)
    assert bool(state.params["kd"].grad.abs().sum() > 0)
    # the blur itself: the JAX package's, on a random residual
    from raytracing_gpu_tpu.parallel.train import _blur_residual as jblur

    err = np.random.RandomState(2).randn(W * H, 3).astype(np.float32)
    np.testing.assert_allclose(_blur_residual(torch.from_numpy(err), W * H, 1.3).numpy(),
                               np.asarray(jblur(jnp.asarray(err), W * H, 1.3)),
                               rtol=1e-5, atol=1e-6)
    # a non-square image raises, with the JAX package's message
    with pytest.raises(ValueError, match="loss_blur needs a square image"):
        step_fn(state, tscene, coords[:4 * 8 * 16], target[:8 * 16])


def test_match_and_missing_device_raise(tscene):
    with pytest.raises(ValueError, match="quantize='smooth'"):
        make_train_step(RenderConfig(quantize="match"), tscene, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_train_step(RenderConfig(quantize="smooth"), tscene)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_train_state(tscene)


def test_checkpoint_roundtrip_and_overwrite(tscene, tmp_path):
    cfg = RenderConfig(backend="cuda", **KW)
    init_state, step_fn = make_train_step(cfg, tscene, device="cpu")
    state = init_train_state(tscene, device="cpu")
    assert isinstance(state, TrainState) and state.step == 0
    ckdir = str(tmp_path / "ckpts")
    p0 = save_train_state(ckdir, state)
    assert p0.endswith("step_00000000") and latest_checkpoint(ckdir) == p0
    coords, target = torch.from_numpy(_coords()), torch.zeros((W * H, 3))
    for _ in range(2):
        state, _ = step_fn(state, tscene, coords, target)
    p2 = save_train_state(ckdir, state)
    assert p2.endswith("step_00000002") and latest_checkpoint(ckdir) == p2

    restored, resumed = resume_or_init(ckdir, init_train_state(tscene, device="cpu"))
    assert resumed and restored.step == 2
    for k in PARAM_KEYS:
        assert torch.equal(restored.params[k], state.params[k]), k
        assert restored.params[k].requires_grad
    a, b = state.opt_state.state_dict(), restored.opt_state.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, slot in a["state"].items():
        for name, val in slot.items():
            assert torch.equal(val, b["state"][i][name]), (i, name)
    # the resumed state trains on exactly as the original does
    state, l1 = step_fn(state, tscene, coords, target)
    restored, l2 = step_fn(restored, tscene, coords, target)
    assert float(l1) == float(l2)
    assert torch.equal(state.params["kd"], restored.params["kd"])

    # saving a step again overwrites it
    with torch.no_grad():
        state.params["kd"].add_(1.0)
    state.step = 2
    assert save_train_state(ckdir, state) == p2
    raw = restore_train_state(p2)
    assert raw.step == 2 and torch.equal(raw.params["kd"], state.params["kd"])
    assert set(raw.opt_state) == {"state", "param_groups"}
    assert sorted(p.name for p in (tmp_path / "ckpts").iterdir()) == [
        "step_00000000", "step_00000002"]

    # an empty directory: the init state comes back
    fresh = init_train_state(tscene, device="cpu")
    same, resumed = resume_or_init(str(tmp_path / "nothing"), fresh)
    assert same is fresh and not resumed
