"""PyTorch port against the JAX package: the matmul-form backend
("cuda_matmul", the JAX package's "mxu"): feature packing, the live-ray
recentring, the plain versions of K5/K6, `collide` and the render.

The four determinants are dot products of 16 features. The port sums them in
one fixed left-to-right order over the rows that are not zero by
construction; XLA's matmul promises no order, and the centroid's sum over
rays is reduced in another order too. So, as the JAX package holds its own
"mxu" backend (tests/test_pallas.py):
- `ray_features` / `pack_tri_features`: allclose rtol 1e-6 against
  `ray_features_mxu` / `pack_tri_features`, with an atol of 1e-6 times the
  largest product in the cross products (they cancel, and jitted XLA
  contracts them into FMAs); the rows that are zero by construction exactly
  zero and the ones row exactly one.
- plain K5/K6 against the Pallas kernels in interpret mode on the same
  features and mask: identical hit masks and winner slots; the raw sweep
  distances (a quotient of two cancelling 6-term sums) rtol 1e-4.
- `collide` on "cuda_matmul" against JAX "mxu" and against the port's
  "torch" backend: identical masks and objects on seeded random rays against
  jittered spheres, distances rtol 1e-5 (the winner's distance is recomputed
  in scalar form); `collide_dist` the same hit booleans, its raw sweep
  distances rtol 1e-4 (shadows read only `!= 0`).
- CPU-mode render against JAX "mxu" and the port's "torch":
  `assert_images_close(tol=1)`.
- parked rays do not move the centroid: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import intersect as jint
from raytracing_gpu_tpu.ops import pallas_intersect as pk
from raytracing_gpu_tpu.render import render_scene as jrender
from raytracing_gpu_tpu.utils.compare import assert_images_close

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as tint

from test_torch_kernels import _jittered

EPS = (1e-7, 0.01)
SPHERES = dict(width=12, height=12, n_lat=8, n_lon=12)


@pytest.fixture(scope="module")
def scenes():
    jscene = _jittered(jproc.make_sphere_scene(**SPHERES))
    dev = scene_to_device(jscene)
    g = dev.geometry
    jpack = pk.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj, dev.materials)
    tscene = scene_from_numpy(jscene)
    tg = tscene.geometry
    tpack = ck.pack_geometry(tg.vertices, tg.valid, tg.normals, tg.tri_obj,
                             tscene.materials)
    return dev, jpack, tscene, tpack


def _rays(seed, R=600, parked=40):
    rng = np.random.RandomState(seed)
    o = (rng.rand(R, 3) * 6.0 - 3.0).astype(np.float32)
    d = (rng.rand(R, 3) * 2.0 - 1.0).astype(np.float32)
    if parked:
        o[-parked:] = 3e29  # as the render parks dead rays
        d[-parked:] = 0.0
    return o, d


def test_ray_features_match_jax():
    o, d = _rays(1)
    jop, jdp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    top, tdp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    want = np.asarray(pk.ray_features_mxu(jop, jdp))
    got = ck.ray_features(top, tdp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 768)
    assert got.is_contiguous()
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[9] == 1.0).all() and (got[14:] == 0.0).all()
    # parked rays: direction 0 gives m = 0, |d| = 1, nd = 0 -- nothing NaN
    assert np.isfinite(got).all()
    assert (got[3:6, 560:600] == 0.0).all() and (got[10, 560:600] == 1.0).all()


def test_tri_features_match_jax(scenes):
    _, jpack, _, tpack = scenes
    want = np.asarray(pk.pack_tri_features(jpack.v0, jpack.e1, jpack.e2))
    got = ck.pack_tri_features(tpack.v0, tpack.e1, tpack.e2)
    Tp = tpack.v0.shape[0]
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16, Tp)
    assert got.is_contiguous()
    got = got.numpy()
    scale = float((tpack.v0.abs().max() * torch.maximum(tpack.e1.abs().max(),
                                                        tpack.e2.abs().max())))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(scale, 1.0))
    # the rows the kernels never read are zero by construction, in both
    for plane, rows in ((0, range(3, 16)), (1, range(6, 16)), (2, range(6, 16)),
                        (3, list(range(0, 6)) + list(range(10, 16)))):
        for r in rows:
            assert (got[plane, r] == 0.0).all() and (want[plane, r] == 0.0).all()
    assert np.abs(got[0, :3]).max() > 0.0
    # padding triangles are degenerate: a = 0 for every ray
    T = int(np.asarray(scenes[0].geometry.valid).sum())
    assert T < Tp and (got[0, :, T:] == 0.0).all()


def test_parked_rays_do_not_move_the_centroid():
    o, _ = _rays(2, parked=0)
    c = ck.live_centroid(torch.from_numpy(o))
    np.testing.assert_allclose(c.numpy(), o.astype(np.float64).mean(0), rtol=1e-5)
    with_tail = np.concatenate([o, np.full((300, 3), 3e29, np.float32)])
    assert torch.equal(ck.live_centroid(torch.from_numpy(with_tail)), c)
    np.random.RandomState(5).shuffle(with_tail)  # scattered: the sum reorders
    np.testing.assert_allclose(ck.live_centroid(torch.from_numpy(with_tail)).numpy(),
                               c.numpy(), rtol=1e-5)
    none_live = ck.live_centroid(torch.full((8, 3), 3e29))
    assert torch.equal(none_live, torch.zeros(3))


def test_plain_matmul_kernels_match_pallas(scenes):
    """Same recentred features, same mask, through the Pallas kernels in
    interpret mode and through the plain versions of K5 and K6."""
    _, jpack, _, tpack = scenes
    o, d = _rays(3)
    c = ck.live_centroid(torch.from_numpy(o))
    top, tdp, R = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    oc = top - c[:, None]
    tm = ck.tile_cull_mask_hierarchical(
        oc, tdp, tpack._replace(tile_aabb=tpack.tile_aabb - c), "octree")
    rayf = ck.ray_features(oc, tdp)
    g = ck.pack_tri_features(tpack.v0 - c, tpack.e1, tpack.e2)
    jf, jg, jm = (jnp.asarray(x.numpy()) for x in (rayf, g, tm))
    jd, ji = (np.asarray(x) for x in pk.nearest_hit_mxu(jf, jg, jm, *EPS))
    before = dict(ck.LAUNCHES)
    td, ti = ck.nearest_hit_matmul(rayf, g, tm, *EPS)
    assert ck.LAUNCHES == before  # CPU tensors: the plain version, uncounted
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    hit = np.isfinite(jd)
    assert 50 < hit[:R].sum() < R - 50
    np.testing.assert_array_equal(np.isfinite(td.numpy()), hit)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy()[hit], jd[hit], rtol=1e-4)
    assert (ti.numpy()[~hit] == 0).all()  # a miss reports slot 0

    jdd = np.asarray(pk.nearest_dist_mxu(jf, jg, jm, *EPS))
    tdd = ck.nearest_dist_matmul(rayf, g, tm, *EPS).numpy()
    np.testing.assert_array_equal(np.isfinite(tdd), np.isfinite(jdd))
    np.testing.assert_allclose(tdd[np.isfinite(jdd)], jdd[np.isfinite(jdd)], rtol=1e-4)
    # K5's winners are K1's on these rays (no ray sits on an edge)
    op = top
    m1 = ck.tile_cull_mask_hierarchical(op, tdp, tpack, "octree")
    d1, i1 = ck.nearest_hit(op, tdp, tpack.v0, tpack.e1, tpack.e2, m1, *EPS)
    np.testing.assert_array_equal(ti.numpy(), i1.numpy())
    np.testing.assert_allclose(td.numpy()[hit], d1.numpy()[hit], rtol=1e-4)


def test_matmul_wrappers_refuse_other_devices():
    f = torch.empty((16, 256), device="meta")
    g = torch.empty((4, 16, 256), device="meta")
    m = torch.ones((1, 1), dtype=torch.int32, device="meta")
    for fn in (ck.nearest_hit_matmul, ck.nearest_dist_matmul):
        with pytest.raises(ValueError):
            fn(f, g, m, *EPS)
        with pytest.raises(ValueError):  # mixed devices
            fn(torch.zeros((16, 256)), g, m, *EPS)
    tri = torch.empty((256, 3), device="meta")
    with pytest.raises(ValueError):
        ck.any_hit(f[:3], f[:3], tri, tri, tri, m, *EPS)
    with pytest.raises(ValueError):  # the work count exists on the card only
        ck.any_hit_walked(torch.zeros((3, 256)), torch.zeros((3, 256)),
                          torch.zeros((256, 3)), torch.zeros((256, 3)),
                          torch.zeros((256, 3)),
                          torch.ones((1, 1), dtype=torch.int32), *EPS)


def test_collide_matches_jax_mxu_and_port_torch(scenes):
    dev, _, tscene, tpack = scenes
    o, d = _rays(1)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jhit = jint.collide(jnp.asarray(o), jnp.asarray(d), dev.geometry, backend="mxu")
    mhit = tint.collide(to, td, tscene.geometry, backend="cuda_matmul")
    thit = tint.collide(to, td, tscene.geometry, backend="torch")
    m = np.asarray(jhit.mask)
    assert 20 < m.sum() < len(m) - 40
    for name, ref_mask, ref_obj, ref_dist in (
            ("jax mxu", m, np.asarray(jhit.obj), np.asarray(jhit.dist)),
            ("port torch", thit.mask.numpy(), thit.obj.numpy(), thit.dist.numpy())):
        np.testing.assert_array_equal(mhit.mask.numpy(), ref_mask, err_msg=name)
        np.testing.assert_array_equal(mhit.obj.numpy()[m], ref_obj[m], err_msg=name)
        np.testing.assert_allclose(mhit.dist.numpy()[m], ref_dist[m], rtol=1e-5,
                                   err_msg=name)
    assert not np.isfinite(mhit.dist.numpy()[~m]).any()
    # a prebuilt pack gives the same hits, and its materials ride along
    again = tint.collide(to, td, tscene.geometry, backend="cuda_matmul", pack=tpack)
    assert torch.equal(again.mask, mhit.mask) and torch.equal(again.dist, mhit.dist)
    assert mhit.mat is None and again.mat is not None


def test_collide_dist_matches_jax_mxu(scenes):
    dev, _, tscene, _ = scenes
    o, d = _rays(2)
    jfd = np.asarray(jint.collide_dist(jnp.asarray(o), jnp.asarray(d), dev.geometry,
                                       backend="mxu"))
    args = (torch.from_numpy(o), torch.from_numpy(d), tscene.geometry)
    tfd = tint.collide_dist(*args, backend="cuda_matmul").numpy()
    np.testing.assert_array_equal(tfd != 0.0, jfd != 0.0)
    np.testing.assert_allclose(tfd, jfd, rtol=1e-4)
    assert (tfd[-40:] == 0.0).all() and (tfd != 0.0).any()
    ref = tint.collide_dist(*args, backend="torch").numpy()
    np.testing.assert_array_equal(tfd != 0.0, ref != 0.0)


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_render_matches_jax_mxu_and_port_torch(mode):
    jscene = _jittered(jproc.make_sphere_scene(**SPHERES))
    tscene = scene_from_numpy(jscene)
    u8 = lambda img: np.trunc(img).astype(np.uint8)  # noqa: E731
    got = u8(render_scene(tscene, RenderConfig(mode=mode, backend="cuda_matmul"),
                          device="cpu"))
    assert got.max() > 0
    want = u8(jrender(jscene, JConfig(mode=mode, quantize="match", backend="mxu")))
    assert_images_close(got, want, tol=1, context=f"{mode}: cuda_matmul vs jax mxu")
    ref = u8(render_scene(tscene, RenderConfig(mode=mode, backend="torch"),
                          device="cpu"))
    assert_images_close(got, ref, tol=1, context=f"{mode}: cuda_matmul vs torch")


def _comparator_cases():
    """Seeded image pairs on both sides of each of the comparator's limits."""
    rng = np.random.RandomState(42)
    base = np.zeros((64, 64, 3), np.uint8)
    base[:, 32:] = 200  # one vertical edge
    base[16:48, 8:24] = 90  # and a box
    jitter = np.clip(base.astype(int) + rng.randint(-1, 2, base.shape), 0, 255)
    on_edge = base.copy()
    on_edge[5:15, 32] = 0  # flips along the edge
    stripe = base.copy()
    stripe[2:14, 50] = 120  # a 12-pixel off-edge column stripe
    isolated = base.copy()
    isolated[3, 40] = 150  # within the 80 magnitude budget, but over the count
    bright = base.copy()
    bright[60, 2] = 255  # one off-edge pixel of magnitude 255
    big = np.zeros((256, 256, 3), np.uint8)
    one = big.copy()
    one[100, 100] = 40  # 1 of 65,536 off-edge: inside the 5e-5 budget
    return {"identical": (base, base), "jitter": (jitter, base),
            "on_edge": (on_edge, base), "stripe": (stripe, base),
            "isolated": (isolated, base), "bright": (bright, base),
            "budgeted": (one, big)}


@pytest.mark.parametrize("case", sorted(_comparator_cases()))
def test_port_comparator_gives_the_jax_verdict(case):
    """The port's copy of the edge-aware comparator (chip_smoke.py holds the
    matmul backend's frame with it, where nothing of the JAX package may be
    imported) passes and fails the same pairs with the same statistics."""
    from raytracing_gpu_tpu_torch.utils.compare import assert_images_close as port_close

    a, b = _comparator_cases()[case]
    verdicts = []
    for fn in (assert_images_close, port_close):
        try:
            d = fn(a, b, tol=1, context=case)
            verdicts.append((True, d.max_abs, d.n_diff, d.n_bad, d.total,
                             round(d.mean_abs, 9)))
        except AssertionError:
            verdicts.append((False,))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == (case in ("identical", "jitter", "on_edge", "budgeted"))
