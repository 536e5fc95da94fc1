"""PyTorch port against the JAX package: the kernel path's packing, tile
culling and worklists, and the plain versions of the three CUDA kernels.

- Packing, masks and worklists are integer (or min/max) results: exactly
  equal to `raytracing_gpu_tpu.ops.pallas_intersect`'s.
- Plain K1/K2 against the Pallas kernels run as the JAX tests run them
  (interpret mode on the CPU): identical winner slots and hit masks. The
  distances agree to rtol 2e-6: XLA:CPU contracts the jitted kernel body's
  multiply-adds into FMAs, which moves a distance by up to ~16 ulp under the
  determinants' cancellation (measured up to 12 on these rays). Against the
  JAX package's eager `_mt_core` (one op at a time, no contraction) on the
  same clustered triangles the plain K1 is bit-exact.
- Plain K3 against `fetch_winner_rows`: exact.
The CUDA kernels themselves (these three and K4-K6, whose plain versions
tests/test_torch_anyhit_f2b.py and tests/test_torch_matmul.py hold against
the JAX package) are compared with the plain versions on the card
(test_cuda_kernels_match_plain, marked `cuda`, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import pallas_intersect as pk
from raytracing_gpu_tpu.ops.intersect import _mt_core

from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core (several
    processes' spinning thread pools on the same cores slow every one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPS = (1e-7, 0.01)
SCENES = {
    "spheres": (jproc.make_sphere_scene, dict(width=16, height=16, n_lat=8, n_lon=12)),
    # > 64 triangle tiles: the interval levels of the octree hierarchy engage
    "grid": (jproc.make_sphere_grid_scene,
             dict(width=16, height=16, nx=4, ny=4, nz=2, n_lat=16, n_lon=20)),
}


def _jittered(jscene, seed=20260820):
    """Vertices moved by up to 2e-3: the procedural scenes are mirror
    symmetric, and their tessellation seams give nearest-hit candidates 0-1
    ulp apart, which FMA contraction in the jitted Pallas kernel resolves
    either way (see tests/test_seam_tie.py)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(jscene.geometry.vertices)
    jv = (v + rng.uniform(-2e-3, 2e-3, v.shape)).astype(np.float32)
    return dataclasses.replace(
        jscene, geometry=dataclasses.replace(jscene.geometry, vertices=jv))


@pytest.fixture(scope="module", params=sorted(SCENES))
def packs(request):
    make, kw = SCENES[request.param]
    jscene = _jittered(make(**kw))
    dev = scene_to_device(jscene)
    g = dev.geometry
    jpack = pk.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj, dev.materials)
    tscene = scene_from_numpy(jscene)
    tg = tscene.geometry
    tpack = ck.pack_geometry(tg.vertices, tg.valid, tg.normals, tg.tri_obj,
                             tscene.materials)
    return request.param, dev, jpack, tpack


def _rays(dev, R=1024, seed=0):
    """A coherent bundle from the camera at the first triangle, scattered
    rays, and a parked tail (the three kinds the render sends), as float32
    numpy."""
    rng = np.random.RandomState(seed)
    cam = np.asarray(dev.camera.position)
    target = np.asarray(dev.geometry.vertices)[0, 0]
    o = np.concatenate([np.broadcast_to(cam, (R // 2, 3)),
                        rng.rand(R // 2, 3) * 10 - 5]).astype(np.float32)
    d = np.concatenate([target + rng.rand(R // 2, 3) * 0.6 - 0.3 - cam,
                        rng.rand(R // 2, 3) * 2 - 1]).astype(np.float32)
    o[-100:] = 3e29
    d[-100:] = 0.0
    return o, d


def _packed(o, d):
    jop, jdp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    top, tdp, R = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jop))
    np.testing.assert_array_equal(tdp.numpy(), np.asarray(jdp))
    return jop, jdp, top, tdp


def test_pack_geometry_matches_jax(packs):
    name, dev, jpack, tpack = packs
    for f in ("perm", "tile_aabb", "tile_nonempty", "v0", "e1", "e2", "table"):
        a, t = np.asarray(getattr(jpack, f)), getattr(tpack, f)
        assert t.numpy().dtype == a.dtype, f
        np.testing.assert_array_equal(t.numpy(), a, err_msg=f"{name}: {f}")
    assert tpack.table.shape[1] == ck.TABLE_WIDTH_MAT
    # the 24-wide table (no materials) and the dist-only pack
    g = dev.geometry
    j24 = pk.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj)
    tg = scene_from_numpy(dev).geometry
    t24 = ck.pack_geometry(tg.vertices, tg.valid, tg.normals, tg.tri_obj)
    np.testing.assert_array_equal(t24.table.numpy(), np.asarray(j24.table))
    assert ck.pack_geometry(tg.vertices, tg.valid).table is None


def test_centroids_round_like_jnp_mean():
    """`vertices.mean(axis=1)` under XLA is a sum times f32(1/3), not a
    division by 3; they differ on about a third of random triangles."""
    rng = np.random.RandomState(9)
    v = (rng.randn(20000, 3, 3) * 10.0).astype(np.float32)
    want = np.asarray(jnp.asarray(v).mean(axis=1))
    np.testing.assert_array_equal(ck.centroids(torch.from_numpy(v)).numpy(), want)


def test_octree_levels_cull_beyond_the_leaf_test():
    """Non-vacuity of the hierarchy on the >64-tile scene: narrow bundles
    from several viewpoints make the per-ray tests down the levels remove
    pair tiles that the leaf interval test alone keeps. The port's octree
    mask is the JAX package's "aabb" mask (exact per-ray tests of the
    leaves) and lies inside its "octree" mask, whose levels below the top
    test whole ray tiles by intervals."""
    make, kw = SCENES["grid"]
    dev = scene_to_device(make(**kw))
    g = dev.geometry
    jpack = pk.pack_geometry(g.vertices, g.valid)
    tg = scene_from_numpy(dev).geometry
    tpack = ck.pack_geometry(tg.vertices, tg.valid)
    rng = np.random.RandomState(12)
    o, d = [], []
    for _ in range(16):  # one 256-ray tile per bundle
        src = rng.uniform(-12, 12, 3) + np.array([0, 0, -15.0])
        dst = rng.uniform(-5, 5, 3)
        o.append(np.broadcast_to(src, (ck.TILE_R, 3)))
        d.append(dst - src + rng.uniform(-0.4, 0.4, (ck.TILE_R, 3)))
    o, d = (np.concatenate(x).astype(np.float32) for x in (o, d))
    jop, jdp, top, tdp = _packed(o, d)
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, "octree")
    np.testing.assert_array_equal(
        tm.numpy(), np.asarray(pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "aabb")))
    assert (tm.numpy() <= np.asarray(
        pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "octree"))).all()
    leaf_only = ck._interval_slab(top, tdp, tpack.tile_aabb, tpack.tile_nonempty)[0]
    assert (tm.bool() <= leaf_only).all()
    assert (leaf_only & ~tm.bool()).any()


@pytest.mark.parametrize("partitioning", ["none", "aabb", "octree"])
def test_tile_masks_and_worklists_match_jax(packs, partitioning):
    """Each mode's mask equals the JAX package's, but "octree" on more than
    64 tiles: the port tests each ray down the levels, where the JAX package
    tests whole ray tiles by intervals, so the port's mask is the JAX
    package's "aabb" mask and lies inside its "octree" mask."""
    name, dev, jpack, tpack = packs
    o, d = _rays(dev)
    jop, jdp, top, tdp = _packed(o, d)
    jm = np.asarray(pk.tile_cull_mask_hierarchical(
        jop, jdp, jpack, "aabb" if partitioning == "octree" else partitioning))
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, partitioning)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), jm)
    if partitioning == "octree":
        assert (tm.numpy() <= np.asarray(
            pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "octree"))).all()
    if partitioning != "none":
        assert 0 < jm.sum() < jm.size, "the mask must cull some pair tiles"
    for mask in (jm, jm.T):  # per triangle tile (Pallas) and per ray tile (CUDA)
        jo, jc = pk.tile_worklist(jnp.asarray(mask))
        to, tc = ck.tile_worklist(torch.tensor(mask))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_hierarchy_levels_match_jax(packs):
    name, dev, jpack, tpack = packs
    jl = pk.build_tile_levels(jpack.tile_aabb, jpack.tile_nonempty)
    tl = ck.build_tile_levels(tpack.tile_aabb, tpack.tile_nonempty)
    assert len(tl) == len(jl) and (len(tl) > 0) == (name == "grid")
    for (jb, jn), (tb, tn) in zip(jl, tl):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_plain_kernels_match_pallas(packs):
    name, dev, jpack, tpack = packs
    o, d = _rays(dev, seed=3)
    jop, jdp, top, tdp = _packed(o, d)
    jm = pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "octree")
    tm = torch.tensor(np.asarray(jm))
    jd, ji = pk.nearest_hit_pallas(jop, jdp, jpack.v0, jpack.e1, jpack.e2, jm, *EPS)
    td, ti = ck.nearest_hit_plain(top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    jd, ji = np.asarray(jd), np.asarray(ji)
    hit = np.isfinite(jd)
    assert 50 < hit.sum() < len(hit) - 100, hit.sum()  # hits and misses both
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), hit)
    np.testing.assert_allclose(td.numpy()[hit], jd[hit], rtol=2e-6)

    jdd = np.asarray(pk.nearest_dist_pallas(jop, jdp, jpack.v0, jpack.e1,
                                            jpack.e2, jm, *EPS))
    tdd = ck.nearest_dist_plain(top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    np.testing.assert_array_equal(np.isfinite(tdd.numpy()), np.isfinite(jdd))
    np.testing.assert_allclose(tdd.numpy()[np.isfinite(jdd)],
                               jdd[np.isfinite(jdd)], rtol=2e-6)

    rows_j = np.asarray(pk.fetch_winner_rows(jpack.table, jnp.asarray(ji).reshape(-1, pk.TILE_R)))
    rows_t = ck.fetch_rows_plain(tpack.table, ti)
    np.testing.assert_array_equal(rows_t.numpy(), rows_j)


def test_plain_nearest_hit_bit_exact_vs_eager_mt_core(packs):
    """Eager JAX evaluates the same unfused operations as the port: the
    masked all-pairs minimum over the clustered triangles is bit-equal, with
    the same first-occurrence winners."""
    name, dev, jpack, tpack = packs
    o, d = _rays(dev, seed=5)
    jop, jdp, top, tdp = _packed(o, d)
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, "octree")
    td, ti = ck.nearest_hit_plain(top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    perm = np.asarray(jpack.perm)
    g = dev.geometry
    dist, *_ = _mt_core(jnp.asarray(o), jnp.asarray(d), g.vertices[perm],
                        g.normals[perm], g.valid[perm], *EPS)
    dist = np.asarray(dist)
    keep = np.repeat(np.repeat(tm.numpy(), ck.TILE_T, 0), ck.TILE_R, 1)
    dist = np.where(keep[: dist.shape[1], : dist.shape[0]].T > 0, dist, np.inf)
    R = len(o)
    np.testing.assert_array_equal(td.numpy()[:R], dist.min(1))
    hit = np.isfinite(dist.min(1))
    assert hit.any()
    np.testing.assert_array_equal(ti.numpy()[:R][hit], dist.argmin(1)[hit])
    assert (ti.numpy()[:R][~hit] == 0).all()  # a miss reports slot 0


def test_wrappers_take_plain_versions_on_cpu_without_counting(packs):
    name, dev, jpack, tpack = packs
    o, d = _rays(dev, R=512, seed=7)
    _, _, top, tdp = _packed(o, d)
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, "octree")
    before = dict(ck.LAUNCHES)
    args = (top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    for got, want in ((ck.nearest_hit(*args), ck.nearest_hit_plain(*args)),
                      ((ck.nearest_dist(*args),), (ck.nearest_dist_plain(*args),))):
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    idx = ck.nearest_hit(*args)[1]
    assert torch.equal(ck.fetch_rows(tpack.table, idx), tpack.table[idx.long()])
    assert ck.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors: any other
    device launches the kernel or raises, never a silent fallback."""
    meta = torch.empty((3, 256), device="meta")
    tri = torch.empty((256, 3), device="meta")
    mask = torch.ones((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ck.nearest_hit(meta, meta, tri, tri, tri, mask, *EPS)
    with pytest.raises(ValueError):
        ck.nearest_dist(meta, meta, tri, tri, tri, mask, *EPS)
    with pytest.raises(ValueError):
        ck.fetch_rows(torch.empty((256, 24), device="meta"),
                      torch.empty((4,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):  # mixed devices
        ck.fetch_rows(torch.zeros((256, 24)), mask.new_empty((4,)))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """Every kernel on the card equals its plain version bit for bit."""
    jscene = _jittered(jproc.make_sphere_grid_scene(
        width=16, height=16, nx=4, ny=4, nz=2, n_lat=16, n_lon=20))
    s = scene_from_numpy(jscene).to(cuda_device)
    g = s.geometry
    pack = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj, s.materials)
    o, d = _rays(scene_to_device(jscene), R=4096, seed=11)
    op, dp, R = ck.pack_rays(torch.from_numpy(o).to(cuda_device),
                             torch.from_numpy(d).to(cuda_device))
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, *EPS)
    before = dict(ck.LAUNCHES)
    kd, ki = ck.nearest_hit(*args)
    pd, pi = ck.nearest_hit_plain(*args)
    assert torch.equal(ki, pi)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    kd2, ki2 = ck.nearest_hit(*args)  # the cross-block combine has no order
    assert torch.equal(ki2, ki) and torch.equal(kd2.view(torch.int32),
                                                kd.view(torch.int32))
    assert torch.equal(ck.nearest_dist(*args).view(torch.int32),
                       ck.nearest_dist_plain(*args).view(torch.int32))
    assert not ki.is_contiguous()  # the slot half of K1's keys, read in place
    assert torch.equal(ck.fetch_rows(pack.table, ki[:R]),
                       ck.fetch_rows_plain(pack.table, ki[:R]))
    g24 = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj).table
    assert g24.shape[1] == ck.TABLE_WIDTH_NOMAT
    assert torch.equal(ck.fetch_rows(g24, ki[:R]), ck.fetch_rows_plain(g24, ki[:R]))
    outside = torch.tensor([-1, g24.shape[0]], dtype=torch.int32, device=cuda_device)
    assert bool(torch.isnan(ck.fetch_rows(g24, outside)).all())
    assert torch.equal(ck.any_hit(*args), ck.any_hit_plain(*args))
    c = ck.live_centroid(op.t()[:R])
    margs = (op - c[:, None], dp, pack.v0 - c, pack.e1, pack.e2, mask, *EPS)
    md, mi = ck.nearest_hit_matmul(*margs)
    qd, qi = ck.nearest_hit_matmul_plain(*margs)
    assert torch.equal(mi, qi)
    assert torch.equal(md.view(torch.int32), qd.view(torch.int32))
    assert torch.equal(ck.nearest_dist_matmul(*margs).view(torch.int32),
                       ck.nearest_dist_matmul_plain(*margs).view(torch.int32))
    assert {k: ck.LAUNCHES[k] - before[k] for k in before} == dict(
        dict.fromkeys(before, 1), nearest_hit=2, fetch_rows=3, tile_cull=0,
        tile_cull_levels=0)
