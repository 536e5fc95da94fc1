"""Gradients of the port's differentiable render.

Against the JAX package: the same scene and parameters (numpy, from a seed)
go through `jax.grad` of its `render_image` and through the port's
`render_image(...).mean().backward()`, for all 13 parameter groups, on the
backend pairs torch/jnp and cuda/pallas (the kernels' plain versions here,
Pallas in interpret mode there). Tolerance per group: rtol 1e-3 and atol
1e-4 of the group's largest gradient. Both sides sum float32 products over
the image's rays in another order, and the jitted JAX side contracts
multiply-adds into FMAs; measured agreement is 3e-4 of the largest entry.
The scene's vertices are jittered: on the symmetric scene the jitted JAX
render breaks exact seam ties the other way, which moves a gradient from one
triangle to its neighbour.

Against central finite differences: the checks of tests/test_grad.py on the
port, with the kernel backends too.

And the port's own contracts: the first winner of an exact tie alone gets
the gradient, the fetch's adjoint, `remat` changes neither the gradient nor
the number of sweeps, and the camera basis is differentiable without
changing any `match` image.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import Geometry as JGeometry
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import intersect as jint
from raytracing_gpu_tpu.parallel.train import extract_params as jextract
from raytracing_gpu_tpu.parallel.train import insert_params as jinsert
from raytracing_gpu_tpu.render import render_image as jrender_image

from raytracing_gpu_tpu_torch import RenderConfig, render_image, render_scene
from raytracing_gpu_tpu_torch.models.scene import Geometry, scene_from_numpy
from raytracing_gpu_tpu_torch.ops import camera as tcam
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as tint
from raytracing_gpu_tpu_torch.parallel.train import (
    PARAM_KEYS,
    extract_params,
    insert_params,
    params_from_numpy,
)

from test_torch_kernels import _jittered

KW = dict(mode="cpu", quantize="smooth", ray_chunk=512, diff_max_depth=2)
SMALL = dict(width=8, height=8, n_lat=6, n_lon=9)


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
    return _jittered(jproc.make_sphere_scene(**SMALL))


@pytest.fixture(scope="module")
def tscene(jscene):
    return scene_from_numpy(jscene)


def _grads(tscene, cfg, params=None):
    """{group: gradient of mean(render_image)} as numpy, for every group."""
    params = params or extract_params(tscene)
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    render_image(insert_params(tscene, p), cfg, device="cpu").mean().backward()
    assert all(v.grad is not None for v in p.values())
    return {k: v.grad.numpy() for k, v in p.items()}


def _loss(tscene, cfg) -> float:
    with torch.no_grad():
        return float(render_image(tscene, cfg, device="cpu").mean())


@pytest.mark.parametrize("port_backend,jax_backend",
                         [("torch", "jnp"), ("cuda", "pallas")])
def test_grad_matches_jax(jscene, tscene, port_backend, jax_backend):
    dev = scene_to_device(jscene)
    jparams = jextract(dev)
    jcfg = JConfig(backend=jax_backend, **KW)
    want = jax.grad(lambda p: jnp.mean(jrender_image(jinsert(dev, p), jcfg)))(jparams)
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               device="cpu")
    got = _grads(tscene, RenderConfig(backend=port_backend, **KW), params)
    assert sorted(got) == sorted(PARAM_KEYS) == sorted(want)
    for k in PARAM_KEYS:
        w = np.asarray(want[k])
        assert np.isfinite(got[k]).all(), k
        assert np.abs(w).max() > 0.0, k
        np.testing.assert_allclose(got[k], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# ---- finite differences (tests/test_grad.py on the port)

CFG = RenderConfig(**KW)  # backend "cuda": the kernel path's plain versions


def _replace_leaf(scene, group, field, value):
    part = dataclasses.replace(getattr(scene, group),
                               **{field: torch.from_numpy(np.array(value, np.float32))})
    return dataclasses.replace(scene, **{group: part})


def _fd_check(scene, cfg, key, group, field, eps, rtol, atol=1e-6, probes=3):
    g = _grads(scene, cfg)[key].ravel()
    x0 = getattr(getattr(scene, group), field).numpy()
    rng = np.random.RandomState(0)
    idxs = list(np.argsort(-np.abs(g))[:probes]) + list(rng.choice(len(g), 2))
    for i in idxs:
        xp, xm = x0.copy().ravel(), x0.copy().ravel()
        xp[i] += eps
        xm[i] -= eps
        lp = _loss(_replace_leaf(scene, group, field, xp.reshape(x0.shape)), cfg)
        lm = _loss(_replace_leaf(scene, group, field, xm.reshape(x0.shape)), cfg)
        fd = (lp - lm) / (2 * eps)
        assert abs(g[i] - fd) <= rtol * max(abs(fd), abs(g[i])) + atol, (
            f"{key}[{i}]: ad={g[i]:.6g} fd={fd:.6g}")


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_matmul"])
def test_grad_light_rgb(backend):
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    _fd_check(scene, RenderConfig(backend=backend, **KW), "lights_rgb", "lights",
              "rgb", eps=1e-2, rtol=2e-2)


def test_grad_kd():
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    _fd_check(scene, CFG, "kd", "materials", "kd", eps=1e-2, rtol=2e-2)


def test_grad_vertices():
    """Vertex probes can cross a silhouette or a shadow edge, where the
    gradient is a Dirac that piecewise-smooth differentiation does not
    give: keep the coordinates whose finite difference agrees with itself
    at two epsilons, and hold the gradient to those."""
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    g = _grads(scene, CFG)["vertices"].ravel()
    x0 = scene.geometry.vertices.numpy()

    def fd(i, eps):
        xp, xm = x0.copy().ravel(), x0.copy().ravel()
        xp[i] += eps
        xm[i] -= eps
        return (_loss(_replace_leaf(scene, "geometry", "vertices", xp.reshape(x0.shape)), CFG)
                - _loss(_replace_leaf(scene, "geometry", "vertices", xm.reshape(x0.shape)), CFG)
                ) / (2 * eps)

    validated = 0
    for i in np.argsort(-np.abs(g))[:12]:
        f1, f2 = fd(i, 1e-2), fd(i, 5e-3)
        if abs(f1 - f2) > 0.2 * max(abs(f1), abs(f2), 1e-4):
            continue
        assert abs(g[i] - f1) <= 0.1 * max(abs(f1), abs(g[i])) + 5e-4, (
            f"coord {i}: ad={g[i]:.6g} fd={f1:.6g}")
        validated += 1
    assert validated >= 3, f"only {validated} smooth probes found"


def test_grad_camera_fov():
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    g = float(_grads(scene, CFG)["cam_fov"])

    def f(v):
        return _loss(_replace_leaf(scene, "camera", "fov", np.float32(v)), CFG)

    fd = (f(90.1) - f(89.9)) / 0.2
    assert np.isfinite(g) and g != 0.0
    assert abs(g - fd) <= 0.1 * max(abs(fd), abs(g)) + 1e-5


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_matmul"])
def test_grads_finite_and_present_everywhere(backend):
    """No NaN through masked lanes, degenerate normals or parked rays; the
    mirrors carry gradient to nr; geometry, materials and every camera
    parameter get a gradient that is not all zero."""
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    grads = _grads(scene, RenderConfig(backend=backend, **KW))
    for k in PARAM_KEYS:
        assert np.isfinite(grads[k]).all(), k
        assert np.abs(grads[k]).sum() > 0.0, k


# ---- the port's own contracts

def _two_coincident_triangles():
    tri = np.array([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]]], np.float32)
    vertices = np.concatenate([tri, tri, np.zeros((126, 3, 3), np.float32)])
    normals = np.zeros((128, 3, 3), np.float32)
    normals[:, :, 2] = -1.0
    valid = np.zeros((128,), bool)
    valid[:2] = True
    o = np.array([[0.0, 0.0, 0.0], [0.2, -0.3, 0.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    return vertices, normals, np.zeros((128,), np.int32), valid, o, d


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_exact_tie_gives_the_first_winner_the_gradient(backend):
    """Two coincident triangles tie exactly. The JAX package reads the
    winner's distance by index, so the first alone gets the gradient; a
    minimum's backward would split it over both."""
    vertices, normals, tri_obj, valid, o, d = _two_coincident_triangles()
    jgeo = JGeometry(vertices=jnp.asarray(vertices), normals=jnp.asarray(normals),
                     tri_obj=jnp.asarray(tri_obj), valid=jnp.asarray(valid))

    def jloss(v):
        hit = jint.collide(jnp.asarray(o), jnp.asarray(d),
                           dataclasses.replace(jgeo, vertices=v))
        return jnp.sum(jnp.where(hit.mask, hit.dist, 0.0))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(vertices)))
    v = torch.from_numpy(vertices).requires_grad_()
    geo = Geometry(vertices=v, normals=torch.from_numpy(normals),
                   tri_obj=torch.from_numpy(tri_obj), valid=torch.from_numpy(valid))
    hit = tint.collide(torch.from_numpy(o), torch.from_numpy(d), geo, backend=backend)
    assert bool(hit.mask.all())
    hit.dist.sum().backward()
    got = v.grad.numpy()
    assert np.abs(got[0]).sum() > 0.0
    assert not got[1:].any()  # the tied second triangle gets nothing
    # (the JAX package's all-pairs gradient is NaN on the degenerate padding
    # triangles; the port's is zero there, as held above)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6)
    assert np.abs(want[0]).sum() > 0.0 and not want[1].any()


def test_fetch_rows_adjoint():
    """`FetchRows.backward` (what the card runs) against autograd of the
    plain `table[idx]`, with slots fetched several times, slot 0 (where the
    missed rays point) and a stride-2 index view like K1's keys."""
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.rand(512, ck.TABLE_WIDTH_MAT).astype(np.float32))
    keys = torch.from_numpy(rng.randint(0, 40, (300, 2)).astype(np.int32))
    keys[::5, 0] = 0
    idx = keys[:, 0]
    assert idx.stride(0) == 2
    g = torch.from_numpy(rng.randn(300, ck.TABLE_WIDTH_MAT).astype(np.float32))
    g[::5] = 0.0  # the caller masks the missed rays' rows
    t = table.clone().requires_grad_()
    ck.fetch_rows(t, idx).backward(g)
    ctx = types.SimpleNamespace(saved_tensors=(idx,), table_shape=tuple(table.shape))
    got, none = ck.FetchRows.backward(ctx, g)
    assert none is None and got.shape == table.shape
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert not got[40:].any()  # unreferenced slots: exactly zero
    assert bool((got[:40].abs().sum(1) > 0).any())


def test_missed_rays_send_no_gradient_to_their_rows(tscene):
    """A missed ray fetches slot 0. Its row's cotangent must be exactly zero
    (the bounce loop masks what it computes from it), or slot 0's triangle
    would collect gradient from rays that never touched it."""
    seen = {}
    orig = ck.fetch_rows

    def spy(table, idx):
        rows = orig(table, idx)
        if rows.requires_grad:
            rows.register_hook(lambda grad, n=len(seen): seen.setdefault(n, grad.clone()))
        seen.setdefault("rows", []).append(rows)
        return rows

    hits = []
    orig_collide = tint.collide

    def collide_spy(*a, **kw):
        hits.append(orig_collide(*a, **kw))
        return hits[-1]

    # the module, not the package's `render` function of the same name
    trender = importlib.import_module("raytracing_gpu_tpu_torch.render")

    mp = pytest.MonkeyPatch()
    mp.setattr(ck, "fetch_rows", spy)
    mp.setattr(trender, "collide", collide_spy)
    try:
        p = {k: v.detach().clone().requires_grad_()
             for k, v in extract_params(tscene).items()}
        cfg = RenderConfig(remat=False, **KW)
        render_image(insert_params(tscene, p), cfg, device="cpu").mean().backward()
    finally:
        mp.undo()
    grads = [seen[k] for k in sorted(k for k in seen if k != "rows")]
    assert len(grads) == len(hits) >= 2
    n_missed = 0
    for hit, grad in zip(hits, grads):
        missed = ~hit.mask
        n_missed += int(missed.sum())
        assert not grad[missed].any()
        assert bool(grad[hit.mask].any())
    assert n_missed > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_remat_same_gradient_and_no_second_sweep(tscene, backend, monkeypatch):
    """Checkpointing the bounce steps changes no gradient, and the backward
    pass recomputes the steps without sweeping again: the sweeps run as
    often with `remat` on as off."""
    calls = {"n": 0}
    name = "_kernel_sweep" if backend == "cuda" else "_all_pairs_sweep"
    orig = getattr(tint, name)

    def counted(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tint, name, counted)
    out = {}
    for remat in (True, False):
        calls["n"] = 0
        out[remat] = (_grads(tscene, RenderConfig(backend=backend, remat=remat, **KW)),
                      calls["n"])
    assert out[True][1] == out[False][1] > 0
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(out[True][0][k], out[False][0][k], err_msg=k)
    # and `unroll="while"` switches the checkpointing off, not the gradient
    calls["n"] = 0
    g = _grads(tscene, RenderConfig(backend=backend, unroll="while", **KW))
    assert calls["n"] == out[True][1]
    np.testing.assert_array_equal(g["vertices"], out[True][0]["vertices"])


def test_sweeps_see_no_graph(tscene, monkeypatch):
    """The sweeps run under no_grad on every backend: what they return
    carries no graph even when rays and scene require grad."""
    p = {k: v.detach().clone().requires_grad_() for k, v in extract_params(tscene).items()}
    scene = insert_params(tscene, p)
    o = torch.tensor([[0.0, 2.0, -8.0]] * 4).requires_grad_()
    d = torch.tensor([[0.0, -0.1, 1.0], [0.2, -0.2, 1.0], [-0.2, -0.1, 1.0],
                      [0.0, 1.0, 0.0]])
    for backend in ("torch", "cuda", "cuda_matmul"):
        pack = None
        if backend != "torch":
            g = scene.geometry
            pack = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj,
                                    scene.materials)
            assert pack.table.requires_grad
            assert not any(t.requires_grad for t in (pack.v0, pack.e1, pack.e2,
                                                     pack.tile_aabb))
        hit = tint.collide(o, d, scene.geometry, backend=backend, pack=pack)
        assert hit.point.requires_grad and hit.normal.requires_grad
        assert bool(hit.mask[:3].all()) and not bool(hit.mask[3])
        assert not tint.collide_dist(o, d, scene.geometry, backend=backend,
                                     pack=pack).requires_grad


def test_camera_basis_traced_equals_host_path():
    """The differentiable camera basis is the host basis to the bit (0 ulp),
    so switching it on changes no ray; its gradient reaches all four
    camera parameters."""
    rng = np.random.RandomState(7)
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    for _ in range(100):
        cam = dataclasses.replace(
            scene.camera, width=int(rng.randint(4, 900)),
            position=torch.from_numpy(rng.randn(3).astype(np.float32)),
            u=torch.from_numpy(rng.randn(3).astype(np.float32)),
            v=torch.from_numpy(rng.randn(3).astype(np.float32)),
            fov=torch.tensor(np.float32(rng.uniform(10.0, 170.0))))
        host = tcam.camera_basis(cam)
        leaves = {f: getattr(cam, f).clone().requires_grad_()
                  for f in ("position", "u", "v", "fov")}
        traced = tcam.camera_basis(dataclasses.replace(cam, **leaves))
        for a, b in zip(host, traced):
            assert not a.requires_grad and b.requires_grad
            assert torch.equal(a, b.detach())
    sum(t.sum() for t in traced).backward()
    assert all(bool(t.grad.abs().sum() > 0) for t in leaves.values())
    with torch.no_grad():  # recording off: the host path even for such leaves
        assert not tcam.camera_basis(dataclasses.replace(cam, **leaves))[2].requires_grad


def test_match_render_unchanged_by_grad_leaves():
    """A `match` render of a scene whose leaves require grad (the traced
    camera basis, the detached pack) equals the plain render bit for bit."""
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    for backend in ("torch", "cuda"):
        cfg = RenderConfig(backend=backend)
        want = render_scene(scene, cfg, device="cpu")
        p = {k: v.detach().clone().requires_grad_() for k, v in extract_params(scene).items()}
        got = render_image(insert_params(scene, p), cfg, depth=64, device="cpu")
        np.testing.assert_array_equal(got.detach().numpy(), want, err_msg=backend)


def test_render_image_defaults_and_gpu_mode():
    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    img = render_image(scene, device="cpu")  # smooth, diff_max_depth
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    want = render_image(scene, RenderConfig(quantize="smooth"), depth=6, device="cpu")
    assert torch.equal(img, want)
    gpu = render_image(scene, RenderConfig(mode="gpu", quantize="smooth", aliasing=2,
                                           max_bounce=2), device="cpu")
    assert gpu.shape == (8, 8, 3) and float(gpu.max()) > 0.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_render_image_and_predict_pixels_default_to_the_card():
    """Like every entry point, the differentiable ones run on the card
    unless the caller asks for the CPU: a scene of CPU tensors does not pull
    them onto the plain path."""
    from raytracing_gpu_tpu_torch.parallel.train import predict_pixels

    scene = scene_from_numpy(jproc.make_sphere_scene(**SMALL))
    coords = tcam.cpu_subpixel_coords_traced(8, 8, torch.arange(8 * 8 * 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_pixels(scene, RenderConfig(quantize="smooth"), 2, coords)
