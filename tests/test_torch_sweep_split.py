"""The cross-block combine of the redesigned K1/K2 sweeps, and K3's checks.

On the card K1's blocks each take (pair tile, 64 triangles) units from a
queue and fold their results with an atomic minimum of the 64-bit key
`(bits(dist) << 32) | slot` (K2: of the distance's bits). No kernel runs on
the CPU, so these tests hold the combine through its torch statement,
`sweep_key` / `split_key`:

- the key's minimum is exactly `first_argmin` (minimum distance, lowest slot
  on a tie, slot 0 on a miss);
- the plain sweep taken one triangle tile at a time and folded by key
  minimum in a shuffled order equals the plain sweep of the whole mask bit
  for bit, on the jittered and on the unjittered (symmetric, seam) sphere
  scene and on coincident quads that tie exactly across tiles; on the
  jittered scene it also equals the JAX package's `nearest_hit_pallas`
  (interpret mode on the CPU): winners identical, distances to rtol 2e-6, the
  tolerance `tests/test_torch_kernels.py` states for the jitted kernel's FMA
  contraction;
- `fetch_rows` takes winner tables 24 or 32 floats wide and raises on
  another width; the sweeps raise on a negative `self_hit_eps`, where the
  bits of an accepted distance would not order as integers;
- K1 hands its results over as the two strided halves of its keys
  (`key_halves`): `collide` gives the same hits from them as from the plain
  version's contiguous pair, front-to-back rounds included.
The kernels themselves are held on the card (`test_cuda_kernels_match_plain`
in tests/test_torch_kernels.py, and chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.ops import pallas_intersect as pk

from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as ti


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
SPHERES = dict(width=12, height=12, n_lat=16, n_lon=20)  # 1,202 triangles, 5 tiles


def _scene(jittered: bool, seed=20261016):
    jscene = jproc.make_sphere_scene(**SPHERES)
    if jittered:  # as tests/test_torch_kernels.py: breaks the 0-1 ulp seam ties
        rng = np.random.default_rng(seed)
        v = np.asarray(jscene.geometry.vertices)
        jv = (v + rng.uniform(-2e-3, 2e-3, v.shape)).astype(np.float32)
        jscene = dataclasses.replace(
            jscene, geometry=dataclasses.replace(jscene.geometry, vertices=jv))
    return jscene


def _rays(jscene, R=1024, seed=4):
    """A bundle from the camera over the spheres, a column of it in the
    camera's own vertical plane (where the tessellation's seams lie), and
    scattered rays."""
    rng = np.random.RandomState(seed)
    cam = np.asarray(jscene.camera.position, np.float32)
    n = R // 4
    aim = np.stack([rng.uniform(-3.0, 3.0, 2 * n), rng.uniform(0.0, 2.5, 2 * n),
                    rng.uniform(-0.5, 1.5, 2 * n)], 1)
    col = np.stack([np.full(n, cam[0]), np.linspace(-0.5, 3.0, n), np.zeros(n)], 1)
    o = np.concatenate([np.broadcast_to(cam, (3 * n, 3)),
                        rng.rand(R - 3 * n, 3) * 10 - 5]).astype(np.float32)
    d = np.concatenate([aim - cam, col - cam,
                        rng.rand(R - 3 * n, 3) * 2 - 1]).astype(np.float32)
    return o, d


def _fold_by_key(args, mask, seed):
    """K1's result the way the card combines it: the plain sweep of one
    triangle tile at a time (every ray tile at once), the per-tile results
    folded by the minimum of `sweep_key` in a shuffled tile order."""
    key = ck.sweep_key(torch.full((args[0].shape[1],), ck.INF),
                       torch.zeros((args[0].shape[1],), dtype=torch.int32))
    tiles = np.random.RandomState(seed).permutation(mask.shape[0])
    n_live = 0
    for j in tiles:
        if not bool(mask[j].any()):
            continue
        n_live += 1
        one = torch.zeros_like(mask)
        one[j] = mask[j]
        dist, slot = ck.nearest_hit_plain(*args, one, *EPS)
        key = torch.minimum(key, ck.sweep_key(dist, slot))
    assert n_live >= 3, "the fold must cross several triangle tiles"
    return ck.split_key(key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_minimum_is_first_argmin(seed):
    rng = np.random.RandomState(seed)
    R, T = 300, 700
    dist = rng.uniform(0.011, 50.0, (R, T)).astype(np.float32)
    dist[rng.rand(R, T) < 0.7] = np.inf
    for r in range(0, R, 3):  # forced ties: the row's minimum at several slots
        dist[r, rng.choice(T, 5, replace=False)] = dist[r].min()
    dist[::7] = np.inf  # rays that miss everything
    dist[5, :] = np.float32(1e-45)  # the smallest positive float still orders
    dist = torch.from_numpy(dist)
    slots = torch.arange(T, dtype=torch.int32).expand(R, T)
    key = ck.sweep_key(dist, slots)
    assert key.dtype == torch.int64 and bool((key >= 0).all())
    # a missing pair must not beat the miss value by its slot
    key = torch.where(torch.isfinite(dist), key, ck.sweep_key(
        torch.tensor(ck.INF), torch.tensor(0, dtype=torch.int32)))
    got_d, got_i = ck.split_key(key.amin(1))
    want_d, want_i = ck.first_argmin(dist)
    assert got_d.dtype == torch.float32 and got_i.dtype == torch.int32
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(got_i, want_i)
    assert bool((got_i[::7] == 0).all()) and bool(torch.isinf(got_d[::7]).all())
    ties = (dist == want_d[:, None]).sum(1)
    assert int((ties[torch.isfinite(want_d)] > 1).sum()) >= R // 4


def test_key_round_trips():
    d = torch.tensor([0.010000001, 1.0, 3.4e38, ck.INF, 1e-45])
    s = torch.tensor([0, 5, 2**31 - 1, 0, 95999], dtype=torch.int32)
    bd, bs = ck.split_key(ck.sweep_key(d, s))
    assert torch.equal(bd.view(torch.int32), d.view(torch.int32))
    assert torch.equal(bs, s)
    assert int(ck.sweep_key(d, s)[3]) == 0x7F800000 << 32  # the kernel's miss value


@pytest.mark.parametrize("jittered", [True, False], ids=["jittered", "seam"])
@pytest.mark.parametrize("order", [0, 1])
def test_tilewise_fold_equals_whole_sweep(jittered, order):
    jscene = _scene(jittered)
    g = scene_from_numpy(jscene).geometry
    pack = ck.pack_geometry(g.vertices, g.valid)
    assert pack.v0.shape[0] // ck.TILE_T == 5
    o, d = _rays(jscene)
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    args = (op, dp, pack.v0, pack.e1, pack.e2)
    want_d, want_i = ck.nearest_hit_plain(*args, mask, *EPS)
    got_d, got_i = _fold_by_key(args, mask, seed=order)
    hit = torch.isfinite(want_d)
    assert 100 < int(hit.sum()) < len(hit) - 100
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    # K2's combine: the minimum of the distance's bits
    dd = ck.nearest_dist_plain(*args, mask, *EPS)
    bits = torch.full_like(dd, ck.INF).view(torch.int32)
    for j in np.random.RandomState(order).permutation(mask.shape[0]):
        one = torch.zeros_like(mask)
        one[j] = mask[j]
        bits = torch.minimum(bits, ck.nearest_dist_plain(*args, one, *EPS)
                             .view(torch.int32))
    assert torch.equal(bits, dd.view(torch.int32))


def test_tilewise_fold_matches_pallas():
    jscene = _scene(True)
    jg = jscene.geometry
    jpack = pk.pack_geometry(jnp.asarray(jg.vertices), jnp.asarray(jg.valid))
    g = scene_from_numpy(jscene).geometry
    pack = ck.pack_geometry(g.vertices, g.valid)
    o, d = _rays(jscene, seed=9)
    jop, jdp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    jm = pk.tile_cull_mask_hierarchical(jop, jdp, jpack, "octree")
    mask = torch.tensor(np.asarray(jm))
    jd, ji = pk.nearest_hit_pallas(jop, jdp, jpack.v0, jpack.e1, jpack.e2, jm, *EPS)
    jd, ji = np.asarray(jd), np.asarray(ji)
    got_d, got_i = _fold_by_key((op, dp, pack.v0, pack.e1, pack.e2), mask, seed=3)
    hit = np.isfinite(jd)
    assert 100 < hit.sum() < len(hit) - 100
    np.testing.assert_array_equal(got_i.numpy(), ji)
    np.testing.assert_array_equal(np.isfinite(got_d.numpy()), hit)
    np.testing.assert_allclose(got_d.numpy()[hit], jd[hit], rtol=2e-6)


def _coincident_quads(n_tiles=8):
    """Four coincident copies of one quad (y = 0) in four triangle tiles, a
    fifth copy below them in the lowest slots; every other slot degenerate."""
    Tp = n_tiles * ck.TILE_T
    v0, e1, e2 = (torch.zeros((Tp, 3)) for _ in range(3))

    def put_quad(slot, y):
        v0[slot:slot + 2] = torch.tensor([-1.0, y, -1.0])
        e1[slot], e2[slot] = torch.tensor([2.0, 0, 0]), torch.tensor([2.0, 0, 2.0])
        e1[slot + 1], e2[slot + 1] = torch.tensor([2.0, 0, 2.0]), torch.tensor([0, 0, 2.0])

    first = 2 * ck.TILE_T + 17
    for slot in (first, 3 * ck.TILE_T + 200, 5 * ck.TILE_T, 7 * ck.TILE_T + 254):
        put_quad(slot, 0.0)
    put_quad(5, -0.5)
    return v0, e1, e2, first


def test_exact_ties_across_tiles_go_to_the_lowest_slot():
    v0, e1, e2, first = _coincident_quads()
    rng = np.random.RandomState(2)
    n = 512
    o = np.stack([rng.uniform(-1.3, 1.3, n), rng.uniform(2.0, 4.0, n),
                  rng.uniform(-1.3, 1.3, n)], 1).astype(np.float32)
    d = np.broadcast_to(np.float32([0.0, -1.0, 0.0]), (n, 3)).copy()
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    mask = torch.ones((v0.shape[0] // ck.TILE_T, op.shape[1] // ck.TILE_R),
                      dtype=torch.int32)
    args = (op, dp, v0, e1, e2)
    want_d, want_i = ck.nearest_hit_plain(*args, mask, *EPS)
    for order in range(3):
        got_d, got_i = _fold_by_key(args, mask, seed=order)
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    hit = torch.isfinite(want_d)
    assert 50 < int(hit.sum()) < n - 50
    assert bool(((want_i[hit] == first) | (want_i[hit] == first + 1)).all())
    # the ties are real: a later copy alone gives the same distance
    later = torch.zeros_like(mask)
    later[7] = 1
    assert torch.equal(ck.nearest_hit_plain(*args, later, *EPS)[0].view(torch.int32),
                       want_d.view(torch.int32))


def test_key_halves_are_views_of_the_key():
    rng = np.random.RandomState(11)
    d = torch.from_numpy(rng.uniform(0.011, 50.0, 777).astype(np.float32))
    d[::5] = ck.INF
    s = torch.from_numpy(rng.randint(0, 96000, 777).astype(np.int32))
    key = ck.sweep_key(d, s)
    hd, hs = ck.key_halves(key)
    assert hd.stride() == (2,) and hs.stride() == (2,)
    assert hd.data_ptr() == key.data_ptr() + 4 and hs.data_ptr() == key.data_ptr()
    sd, ss = ck.split_key(key)
    assert hd.dtype == torch.float32 and hs.dtype == torch.int32
    assert torch.equal(hd.view(torch.int32), sd.view(torch.int32))
    assert torch.equal(hs, ss)


@pytest.mark.parametrize("f2b_tiles", [0, 2], ids=["one_sweep", "front_to_back"])
def test_collide_takes_the_cards_strided_layout(monkeypatch, f2b_tiles):
    """`collide` on the CPU gets K1's plain, contiguous results; on the card
    the strided halves of the keys. Both must give the same hits."""
    jscene = _scene(True)
    g = scene_from_numpy(jscene).geometry
    o, d = (torch.from_numpy(a) for a in _rays(jscene, R=1000, seed=6))
    call = dict(backend="cuda", f2b_tiles=f2b_tiles)
    want = ti.collide(o, d, g, *EPS, **call)
    layouts = []

    def strided_nearest_hit(*args):
        # the sweep's arguments and, last, the pack's unit and group boxes
        Tp = args[2].shape[0]
        assert len(args) == 10 and args[8].shape == (Tp // ck.UNIT_T, 2, 3)
        assert args[9].shape == (Tp // ck.GROUP_T, 2, 3)
        dist, slot = ck.nearest_hit_plain(*args[:8])
        dist, slot = ck.key_halves(ck.sweep_key(dist, slot))
        layouts.append((dist.stride(), slot.stride()))
        return dist, slot

    monkeypatch.setattr(ck, "nearest_hit", strided_nearest_hit)
    got = ti.collide(o, d, g, *EPS, **call)
    assert layouts == [((2,), (2,))] * (2 if f2b_tiles else 1)
    assert 100 < int(want.mask.sum()) < 900
    assert torch.equal(got.mask, want.mask) and torch.equal(got.obj, want.obj)
    for a, b in ((got.dist, want.dist), (got.point, want.point),
                 (got.normal, want.normal)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("width", [ck.TABLE_WIDTH_NOMAT, ck.TABLE_WIDTH_MAT])
def test_fetch_rows_widths(width):
    rng = np.random.RandomState(width)
    table = torch.from_numpy(rng.rand(768, width).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 768, 1001).astype(np.int32))
    assert torch.equal(ck.fetch_rows(table, idx), table[idx.long()])
    # the strided slot column K1 hands over: every second int32 of its keys
    pairs = torch.stack([idx, torch.zeros_like(idx)], 1)
    assert not pairs[:, 0].is_contiguous()
    assert torch.equal(ck.fetch_rows(table, pairs[:, 0]), table[idx.long()])


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="24 or 32"):
        ck.fetch_rows(torch.zeros((256, 20)), idx)
    with pytest.raises(ValueError):
        ck.fetch_rows(torch.zeros((256, 24)), idx[None])
    rays = torch.zeros((3, 256))
    tris = torch.zeros((256, 3))
    mask = torch.ones((1, 1), dtype=torch.int32)
    for sweep in (ck.nearest_hit, ck.nearest_dist):
        with pytest.raises(ValueError, match="self_hit_eps"):
            sweep(rays, rays, tris, tris, tris, mask, 1e-7, -0.01)
        sweep(rays, rays, tris, tris, tris, mask, 1e-7, 0.0)  # zero is allowed


@pytest.mark.cuda
def test_cuda_ties_across_blocks_match_plain():
    """On the card the coincident quads sit in different blocks of K1: the
    atomic minimum of the keys must pick the plain version's winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    v0, e1, e2, first = _coincident_quads()
    rng = np.random.RandomState(2)
    o = np.stack([rng.uniform(-1.3, 1.3, 512), rng.uniform(2.0, 4.0, 512),
                  rng.uniform(-1.3, 1.3, 512)], 1).astype(np.float32)
    d = np.broadcast_to(np.float32([0.0, -1.0, 0.0]), (512, 3)).copy()
    op, dp, _ = ck.pack_rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    mask = torch.ones((v0.shape[0] // ck.TILE_T, op.shape[1] // ck.TILE_R),
                      dtype=torch.int32, device=dev)
    args = (op, dp, v0.to(dev), e1.to(dev), e2.to(dev), mask, *EPS)
    (gd, gi), (pd, pi) = ck.nearest_hit(*args), ck.nearest_hit_plain(*args)
    assert torch.equal(gi, pi) and torch.equal(gd.view(torch.int32), pd.view(torch.int32))
    hit = torch.isfinite(pd)
    assert bool(((gi[hit] == first) | (gi[hit] == first + 1)).all())
