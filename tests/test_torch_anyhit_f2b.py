"""PyTorch port against the JAX package: the any-hit shadow sweep (K4's plain
version) and the two-round front-to-back sweep.

Both are exact by construction, so nothing here has a tolerance except the
distances compared with the jitted Pallas kernels:
- `collide_any` with `any_hit_min_tris=0` equals `collide_dist != 0` exactly,
  for partitioning "none" and "octree", with a scattered third of the rays
  parked (they report False) and on a fully saturated 256-ray tile; and it
  equals the JAX package's `collide_any` with its any-hit kernel forced on
  (`ANY_HIT_MIN_TRIS` patched to 0, Pallas in interpret mode).
- `tile_entry_lower` against the JAX package's: same culled pairs (+inf),
  bounds within rtol 1e-6 (XLA fuses the slab arithmetic under jit).
- `nearest_hit_front_to_back` equals one `nearest_hit` sweep exactly
  (distances bit for bit, slots) for k_near 2 and 4 with a parked tail, and
  its slots and hit mask equal the JAX package's front-to-back sweep; the
  distances agree with the jitted Pallas kernel's to rtol 2e-6 (FMA
  contraction, see tests/test_torch_kernels.py).
- renders with `any_hit_min_tris=0` and with `f2b_tiles=2` equal the default
  render exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import intersect as jint
from raytracing_gpu_tpu.ops import pallas_intersect as pk

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as tint

from test_torch_kernels import _jittered
from test_torch_render import GRID


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


@pytest.fixture(scope="module")
def spheres():
    jscene = _jittered(jproc.make_sphere_scene(width=12, height=12, n_lat=8,
                                               n_lon=12))
    return scene_to_device(jscene), scene_from_numpy(jscene)


def _parked_third(seed=7, R=512):
    rng = np.random.RandomState(seed)
    o = rng.rand(R, 3).astype(np.float32) * 6.0 - 3.0
    d = rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0
    parked = rng.rand(R) < 0.33  # scattered, as the shading path parks them
    o[parked] = 3e29
    d[parked] = 0.0
    return o, d, parked


@pytest.mark.parametrize("partitioning", ["none", "octree"])
def test_any_hit_matches_dist_and_jax(spheres, partitioning, monkeypatch):
    dev, tscene = spheres
    o, d, parked = _parked_third()
    args = (torch.from_numpy(o), torch.from_numpy(d), tscene.geometry)
    kw = dict(backend="cuda", partitioning=partitioning)
    calls = []
    real = ck.any_hit
    monkeypatch.setattr(ck, "any_hit", lambda *a: calls.append(1) or real(*a))
    occ = tint.collide_any(*args, **kw, any_hit_min_tris=0).numpy()
    assert calls == [1]  # through the any-hit sweep, not collide_dist
    fd = tint.collide_dist(*args, **kw).numpy()
    np.testing.assert_array_equal(occ, fd != 0.0)
    assert occ.dtype == np.bool_ and occ.shape == (len(o),)
    assert not occ[parked].any()
    live = ~parked
    assert occ[live].any() and (~occ[live]).any()  # both answers occur
    # below the threshold (and on the other backends) it is collide_dist != 0
    np.testing.assert_array_equal(tint.collide_any(*args, **kw).numpy(), occ)
    for backend in ("torch", "cuda_matmul"):
        got = tint.collide_any(*args, backend=backend, any_hit_min_tris=0)
        want = tint.collide_dist(*args, backend=backend) != 0.0
        assert torch.equal(got, want), backend
    T = tscene.geometry.vertices.shape[0]  # the threshold counts padded triangles
    tint.collide_any(*args, **kw, any_hit_min_tris=T + 1)
    assert calls == [1]  # only backend "cuda" at or above the threshold
    tint.collide_any(*args, **kw, any_hit_min_tris=T)
    assert calls == [1, 1]
    # the JAX package's any-hit kernel, forced on as its own test does
    monkeypatch.setattr(jint, "ANY_HIT_MIN_TRIS", 0)
    jocc = np.asarray(jint.collide_any(jnp.asarray(o), jnp.asarray(d), dev.geometry,
                                       backend="pallas", partitioning=partitioning))
    np.testing.assert_array_equal(occ, jocc)


def test_any_hit_plain_equals_pallas_kernel_on_packed_rays(spheres):
    """The wrapper level: same packed rays, same mask, the Pallas kernel in
    interpret mode; padded rays (origin 1e30) count as dead."""
    dev, tscene = spheres
    o, d, parked = _parked_third(seed=11, R=700)  # 700 -> 768: 68 padded rays
    g = dev.geometry
    jpack = pk.pack_geometry(g.vertices, g.valid)
    tg = tscene.geometry
    tpack = ck.pack_geometry(tg.vertices, tg.valid)
    jop, jdp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    top, tdp, R = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, "octree")
    jocc = np.asarray(pk.any_hit_pallas(jop, jdp, jpack.v0, jpack.e1, jpack.e2,
                                        jnp.asarray(tm.numpy()), *EPS))
    before = dict(ck.LAUNCHES)
    tocc = ck.any_hit(top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    assert ck.LAUNCHES == before  # CPU tensors: the plain version, uncounted
    assert tocc.dtype == torch.bool and tuple(tocc.shape) == (768,)
    np.testing.assert_array_equal(tocc.numpy(), jocc)
    assert not tocc.numpy()[R:].any() and tocc.numpy()[:R].any()
    assert torch.equal(ck.live_rays(top)[:R], torch.from_numpy(~parked))
    assert not ck.live_rays(top)[R:].any()


def test_any_hit_saturated_tile(spheres):
    """A full ray tile aimed straight down at the ground quad: every lane
    is occluded, and the answer is still exactly collide_dist != 0. (Off the
    quad's diagonal: the jitter moves each triangle's copy of a shared vertex
    on its own and opens a crack there.)"""
    _, tscene = spheres
    R = ck.TILE_R
    o = torch.tensor([[0.3, 5.0, 0.2]]).repeat(R, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(R, 1)
    occ = tint.collide_any(o, d, tscene.geometry, backend="cuda", any_hit_min_tris=0)
    fd = tint.collide_dist(o, d, tscene.geometry, backend="cuda")
    assert torch.equal(occ, fd != 0.0) and bool(occ.all())


@pytest.fixture(scope="module")
def f2b_case():
    """The JAX test's case -- a 2x2x2 sphere grid, coherent front-hitters,
    wild rays and a parked tail (tests/test_pallas.py) -- behind one ray tile
    whose 256 rays all hit the front sphere of a column, so that its cutoff
    is finite and the second round can skip what lies behind."""
    jscene = jproc.make_sphere_grid_scene(width=8, height=8, nx=2, ny=2, nz=2,
                                          n_lat=8, n_lon=16)
    dev = scene_to_device(jscene)
    g = dev.geometry
    jpack = pk.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj)
    tg = scene_from_numpy(jscene).geometry
    tpack = ck.pack_geometry(tg.vertices, tg.valid, tg.normals, tg.tri_obj)
    rng = np.random.RandomState(3)
    R = 512
    o = np.full((R, 3), [0.0, 0.0, -12.0], np.float32)
    o += rng.rand(R, 3).astype(np.float32) * 0.5
    d = rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0
    d[:, 2] = np.abs(d[:, 2]) + 0.5  # mostly toward the grid
    o[-128:] = 3e29
    d[-128:] = 0.0
    fo = np.concatenate([1.25 + rng.rand(256, 2) * 0.8 - 0.4,
                         np.full((256, 1), -12.0)], 1).astype(np.float32)
    fd = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (256, 1))
    o, d = np.concatenate([fo, o]), np.concatenate([fd, d])
    jop, jdp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    top, tdp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    tm = ck.tile_cull_mask_hierarchical(top, tdp, tpack, "octree")
    jm = pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "octree")
    # the port tests each ray down the levels: the JAX package's exact
    # per-ray ("aabb") mask, inside its own "octree" mask
    np.testing.assert_array_equal(
        tm.numpy(), np.asarray(pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "aabb")))
    assert (tm.numpy() <= np.asarray(jm)).all()
    assert tm.shape[0] >= 6
    return jpack, tpack, (jop, jdp, jm), (top, tdp, tm)


def test_tile_entry_lower_matches_jax(f2b_case):
    jpack, tpack, (jop, jdp, _), (top, tdp, _) = f2b_case
    want = np.asarray(pk.tile_entry_lower(jop, jdp, jpack.tile_aabb,
                                          jpack.tile_nonempty))
    got = ck.tile_entry_lower(top, tdp, tpack.tile_aabb, tpack.tile_nonempty).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.any() and (got[fin] > 0.0).any() and (got[fin] >= 0.0).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


@pytest.mark.parametrize("k_near", [1, 2, 4])
def test_front_to_back_equals_one_sweep_and_jax(f2b_case, k_near):
    jpack, tpack, (jop, jdp, jm), (top, tdp, tm) = f2b_case
    bd, bi = ck.nearest_hit(top, tdp, tpack.v0, tpack.e1, tpack.e2, tm, *EPS)
    fd, fi = ck.nearest_hit_front_to_back(top, tdp, tpack, tm, *EPS, k_near=k_near)
    assert torch.equal(fd.view(torch.int32), bd.view(torch.int32))
    assert torch.equal(fi, bi) and fi.dtype == torch.int32
    hit = torch.isfinite(bd).numpy()
    assert hit.any() and (~hit).any() and hit[:256].all()  # both cutoff regimes
    jd, ji = pk.nearest_hit_front_to_back(
        jop, jdp, jpack.v0, jpack.e1, jpack.e2, jpack.tile_aabb,
        jpack.tile_nonempty, jm, *EPS, k_near=k_near)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(hit, np.isfinite(np.asarray(jd)))
    np.testing.assert_allclose(fd.numpy()[hit], np.asarray(jd)[hit], rtol=2e-6)


def test_front_to_back_second_round_is_not_vacuous(f2b_case, monkeypatch):
    """With k_near = 2 the second round must skip some tiles where a ray
    tile's cutoff is finite and none where it is not."""
    _, tpack, _, (top, tdp, tm) = f2b_case
    rounds = []
    real = ck.nearest_hit

    def spy(op, dp, v0, e1, e2, m, *a):
        rounds.append((m.bool(), real(op, dp, v0, e1, e2, m, *a)))
        return rounds[-1][1]

    monkeypatch.setattr(ck, "nearest_hit", spy)
    ck.nearest_hit_front_to_back(top, tdp, tpack, tm, *EPS, k_near=2)
    assert len(rounds) == 2
    a, b = rounds[0][0], rounds[1][0]
    assert not (a & b).any() and ((a | b) <= tm.bool()).all()
    skipped = tm.bool() & ~(a | b)
    assert skipped[:, 0].any()  # behind the one front sphere
    assert b[:, 1:].any() and not skipped[:, 1:].any()  # a missing ray keeps all


def _wall(z, skip_corner=False):
    """256 triangles tiling [-1,1]^2 at depth z (16 x 8 cells, two each); with
    skip_corner the last one is a sliver at depth 0.5 far off to the side."""
    xs, ys = np.linspace(-1, 1, 17), np.linspace(-1, 1, 9)
    tris = []
    for i in range(16):
        for j in range(8):
            a, b = (xs[i], ys[j], z), (xs[i + 1], ys[j], z)
            c, d = (xs[i + 1], ys[j + 1], z), (xs[i], ys[j + 1], z)
            tris += [(a, b, c), (a, c, d)]
    if skip_corner:
        tris[-1] = ((5.0, 5.0, 0.5), (5.1, 5.0, 0.5), (5.0, 5.1, 0.5))
    return np.asarray(tris, np.float32)


def test_front_to_back_round_two_wins_and_skips_on_stacked_walls():
    """Three walls, one triangle tile each, seen head-on by one ray tile. The
    far wall's tile also holds a sliver in front of everything, so its entry
    bound is the smallest and round one (k_near = 1) sweeps it alone: every
    ray hits at depth 2. Round two must take the wall at 1.5 (its bound lies
    between half the cutoff and the cutoff, and it beats every round-one hit)
    and skip the wall at 3."""
    v = torch.from_numpy(np.concatenate([_wall(2.0, skip_corner=True),
                                         _wall(1.5), _wall(3.0)]))
    v0, e1, e2 = v[:, 0].contiguous(), v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    boxes = torch.stack([v.reshape(3, -1, 3).amin(1), v.reshape(3, -1, 3).amax(1)], 1)
    e1, e2 = e1.contiguous(), e2.contiguous()
    pack = ck.KernelPack(None, boxes, torch.ones(3, dtype=torch.bool),
                         v0, e1, e2, None, *ck.sweep_boxes(v0, e1, e2))
    rng = np.random.RandomState(4)
    o = np.concatenate([rng.rand(256, 2) - 0.5, np.zeros((256, 1))], 1)
    d = np.tile([[0.0, 0.0, 1.0]], (256, 1))
    op, dp, _ = ck.pack_rays(torch.from_numpy(o.astype(np.float32)),
                             torch.from_numpy(d.astype(np.float32)))
    tm = torch.ones((3, 1), dtype=torch.int32)
    tent = ck.tile_entry_lower(op, dp, boxes, pack.tile_nonempty)[:, 0]
    np.testing.assert_allclose(tent.numpy(), [0.4995, 1.4985, 2.997], rtol=1e-6)
    base = ck.nearest_hit(op, dp, v0, pack.e1, pack.e2, tm, *EPS)
    assert torch.equal(base[0], torch.full((256,), 1.5)) and (base[1] >= 256).all()
    rounds = []
    real = ck.nearest_hit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "nearest_hit", lambda *a: rounds.append(a[5][:, 0].tolist())
                   or real(*a))
        got = ck.nearest_hit_front_to_back(op, dp, pack, tm, *EPS, k_near=1)
    assert rounds == [[1, 0, 0], [0, 1, 0]]
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


def test_collide_takes_front_to_back_only_under_its_condition(f2b_case, monkeypatch):
    """collide routes through the composite when f2b_tiles > 0, partitioning
    is not "none" and the scene has more than 2*f2b_tiles tiles, as the JAX
    package does; the hits are the same either way."""
    jscene = jproc.make_sphere_grid_scene(width=8, height=8, nx=2, ny=2, nz=2,
                                          n_lat=8, n_lon=16)
    tg = scene_from_numpy(jscene).geometry
    _, _, _, (top, tdp, tm) = f2b_case
    o, d = top.t().contiguous(), tdp.t().contiguous()
    calls = []
    real = ck.nearest_hit_front_to_back
    monkeypatch.setattr(ck, "nearest_hit_front_to_back",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = tint.collide(o, d, tg, backend="cuda")
    nT = tm.shape[0]
    for kw, taken in ((dict(f2b_tiles=2), True),
                      (dict(f2b_tiles=2, partitioning="none"), False),
                      (dict(f2b_tiles=(nT + 1) // 2), False),
                      (dict(f2b_tiles=2, backend="cuda_matmul"), False)):
        calls.clear()
        hit = tint.collide(o, d, tg, **{"backend": "cuda", **kw})
        assert bool(calls) == taken, kw
        if kw.get("backend", "cuda") == "cuda":
            assert torch.equal(hit.mask, base.mask) and torch.equal(hit.dist, base.dist)
            assert torch.equal(hit.obj[base.mask], base.obj[base.mask])


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_renders_with_any_hit_and_front_to_back_equal_the_default(mode, monkeypatch):
    """The config fields reach the sweeps through both trace loops, and the
    image does not change. The grid at 8x8: its 75 triangle tiles keep the
    front-to-back condition (more than 2 * f2b_tiles) true."""
    tscene = scene_from_numpy(jproc.make_sphere_grid_scene(**dict(GRID, width=8,
                                                                  height=8)))
    calls = {"any_hit": 0, "nearest_hit_front_to_back": 0}
    for name in calls:
        def spy(*a, _name=name, _real=getattr(ck, name), **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ck, name, spy)
    cfg = dict(backend="cuda", mode=mode, aliasing=2)
    base = render_scene(tscene, RenderConfig(**cfg), device="cpu")
    assert base.max() > 0.0 and not any(calls.values())
    for extra in (dict(any_hit_min_tris=0), dict(f2b_tiles=2),
                  dict(any_hit_min_tris=0, f2b_tiles=2)):
        calls.update(any_hit=0, nearest_hit_front_to_back=0)
        got = render_scene(tscene, RenderConfig(**cfg, **extra), device="cpu")
        np.testing.assert_array_equal(got, base, err_msg=str(extra))
        assert (calls["any_hit"] > 0) == ("any_hit_min_tris" in extra)
        assert (calls["nearest_hit_front_to_back"] > 0) == ("f2b_tiles" in extra)
