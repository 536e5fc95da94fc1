"""K4 and K5/K6 as the card runs them: in units of (kept pair tile, 64
triangles) drawn from a queue in no fixed order.

No kernel runs on the CPU, so these tests state the kernels' combine in torch
and hold it against the plain versions and the JAX package:

- K4: the OR over units in a shuffled order equals `any_hit_plain` exactly,
  with and without the early exit (a unit is dropped when its ray tile has no
  live, unoccluded lane left); a ray's flag flips once, so a ray tile's count
  ends at its live rays that stayed free and never goes below 0; dead lanes
  (parked or padded rays) never pin a tile and report False. The saturated
  tile is the one of `tests/test_torch_anyhit_f2b.py`.
- K5/K6: the matmul-form pair distances of one unit at a time, folded by the
  minimum of `sweep_key` (K6: of the distance's bits) in a shuffled order,
  equal `nearest_hit_matmul_plain` / `nearest_dist_matmul_plain` bit for bit,
  and the JAX package's `nearest_hit_mxu` / `nearest_dist_mxu` (interpret
  mode) on the same features at the tolerance `tests/test_torch_matmul.py`
  states: identical hit masks and slots, distances to rtol 1e-4.
- The kernel builds its features itself. Its arithmetic, transcribed here in
  numpy float32 one operation at a time (`csrc/intersect.cu`:
  `load_ray_features`, `stage_features`), gives the rows of `ray_features` /
  `pack_tri_features` of the recentred inputs bit for bit, and the rows it
  leaves out are the ones that are zero (or one) by construction.
- `collide` on "cuda_matmul" gives the same hits from K5's strided
  `key_halves` as from the plain version's contiguous pair.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.ops import pallas_intersect as pk

from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as ti

from test_torch_sweep_split import _rays, _scene

EPS = (1e-7, 0.01)
SUB = 64  # triangles of a unit (SWEEP_SUB in csrc/intersect.cu)


def _units(mask, seed):
    """The kept (triangle tile, ray tile, part) units in a shuffled order."""
    kept = [(int(j), int(rt), part) for j, rt in torch.nonzero(mask > 0).tolist()
            for part in range(ck.TILE_T // SUB)]
    order = np.random.RandomState(seed).permutation(len(kept))
    return [kept[k] for k in order]


def _any_hit_by_units(op, dp, v0, e1, e2, units, drop: bool):
    """K4's combine in torch: (occluded (Rp,), units scanned, final live
    count per ray tile)."""
    Rp = op.shape[1]
    live = ck.live_rays(op)
    count = live.reshape(-1, ck.TILE_R).sum(1)
    occ = torch.zeros((Rp,), dtype=torch.bool)
    scanned = 0
    for j, rt, part in units:
        if drop and int(count[rt]) == 0:
            continue
        scanned += 1
        rays = slice(rt * ck.TILE_R, (rt + 1) * ck.TILE_R)
        tris = slice(j * ck.TILE_T + part * SUB, j * ck.TILE_T + (part + 1) * SUB)
        dist = ck.mt_pairs(op[:, rays].t(), dp[:, rays].t(), v0[tris], e1[tris],
                           e2[tris], *EPS, ref_dist=False)[0]
        # a lane that is dead or already flagged skips its scan
        flips = (dist < ck.INF).any(1) & live[rays] & ~occ[rays]
        occ[rays] |= flips
        count[rt] -= flips.sum()
        assert int(count[rt]) >= 0
    return occ, scanned, count


def _packed_case(R=1024, seed=4, parked_share=0.3):
    jscene = _scene(True)
    g = scene_from_numpy(jscene).geometry
    pack = ck.pack_geometry(g.vertices, g.valid)
    o, d = _rays(jscene, R=R, seed=seed)
    parked = np.random.RandomState(seed + 1).rand(R) < parked_share
    o[parked] = 3e29  # scattered, as the shading path parks them
    d[parked] = 0.0
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    return pack, op, dp


@pytest.mark.parametrize("drop", [False, True], ids=["all_units", "early_exit"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_any_hit_is_an_or_over_units_in_any_order(order, drop):
    pack, op, dp = _packed_case(R=1000)  # 1000 -> 1024: 24 padded rays too
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    tris = (pack.v0, pack.e1, pack.e2)
    want = ck.any_hit_plain(op, dp, *tris, mask, *EPS)
    units = _units(mask, order)
    assert len(units) >= 16
    got, scanned, count = _any_hit_by_units(op, dp, *tris, units, drop)
    assert torch.equal(got, want)
    live = ck.live_rays(op)
    assert bool((want & live).any()) and bool((~want & live).any())
    assert not bool(got[~live].any())  # parked and padded rays report False
    # each flip was counted once: what is left are the live rays still free
    assert torch.equal(count, (live & ~want).reshape(-1, ck.TILE_R).sum(1))
    both = ((want & live).reshape(-1, ck.TILE_R).any(1)
            & (~want & live).reshape(-1, ck.TILE_R).any(1))
    assert bool(both.any())  # occluded and free live rays within one ray tile
    assert scanned <= len(units)


def test_saturated_ray_tile_drops_its_remaining_units():
    """The ray tile of `test_any_hit_saturated_tile`, 56 of its lanes parked:
    once the ground's unit has run, every other unit of the tile is dropped,
    the dead lanes pin nothing, and the answer does not change."""
    pack, _, _ = _packed_case()
    o = torch.tensor([[0.3, 5.0, 0.2]]).repeat(ck.TILE_R, 1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(ck.TILE_R, 1)
    o[200:] = 3e29
    d[200:] = 0.0
    op, dp, _ = ck.pack_rays(o, d)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "none")
    tris = (pack.v0, pack.e1, pack.e2)
    want = ck.any_hit_plain(op, dp, *tris, mask, *EPS)
    assert bool(want[:200].all()) and not bool(want[200:].any())
    assert torch.equal(want, ck.nearest_dist(op, dp, *tris, mask, *EPS) < ck.INF)
    n_scanned = []
    for order in range(4):
        units = _units(mask, order)
        for drop in (False, True):
            got, scanned, count = _any_hit_by_units(op, dp, *tris, units, drop)
            assert torch.equal(got, want) and int(count[0]) == 0
            if drop:
                n_scanned.append(scanned)
            else:
                assert scanned == len(units) == 4 * int(mask.sum())
    assert all(n <= len(units) for n in n_scanned) and min(n_scanned) < len(units)
    # the unit that holds the ground first: nothing else is scanned
    hits = [u for u in units if bool(_any_hit_by_units(op, dp, *tris, [u], False)[0].any())]
    first = hits[:1] + [u for u in units if u != hits[0]]
    assert _any_hit_by_units(op, dp, *tris, first, True)[1] <= len(hits)
    # a ray tile of dead lanes alone starts at 0 and scans nothing
    dead = torch.full((3, ck.TILE_R), 3e29)
    got, scanned, _ = _any_hit_by_units(dead, torch.zeros_like(dead), *tris, units, True)
    assert scanned == 0 and not bool(got.any())


def _recentred(pack, op, dp):
    c = ck.live_centroid(op.t())
    oc = op - c[:, None]
    mask = ck.tile_cull_mask_hierarchical(
        oc, dp, pack._replace(tile_aabb=pack.tile_aabb - c), "octree")
    return oc, pack.v0 - c, mask


def _matmul_fold_by_units(oc, dp, v0c, e1, e2, units, want_idx: bool):
    """K5's (K6's) combine in torch: the unit's (256, 64) matmul-form pair
    distances, their first minimum per ray, and the key minimum across units."""
    Rp = oc.shape[1]
    rayf = ck.ray_features(oc, dp)
    g = ck.pack_tri_features(v0c, e1, e2)
    key = ck.sweep_key(torch.full((Rp,), ck.INF), torch.zeros((Rp,), dtype=torch.int32))
    bits = torch.full((Rp,), ck.INF).view(torch.int32)
    for j, rt, part in units:
        rays = slice(rt * ck.TILE_R, (rt + 1) * ck.TILE_R)
        first = j * ck.TILE_T + part * SUB
        dist = ck._matmul_pairs(rayf[:, rays], g[:, :, first:first + SUB], *EPS,
                                ref_dist=want_idx)
        dmin, slot = ck.first_argmin(dist)
        hit = dmin < ck.INF  # a unit that accepted nothing leaves the ray alone
        if want_idx:
            key[rays] = torch.where(hit, torch.minimum(
                key[rays], ck.sweep_key(dmin, slot + first)), key[rays])
        else:
            bits[rays] = torch.minimum(bits[rays], dmin.view(torch.int32))
    return ck.split_key(key) if want_idx else bits.view(torch.float32)


@pytest.mark.parametrize("order", [0, 1])
def test_matmul_fold_over_units_equals_plain_and_jax(order):
    pack, op, dp = _packed_case(seed=9, parked_share=0.1)
    oc, v0c, mask = _recentred(pack, op, dp)
    tris = (v0c, pack.e1, pack.e2)
    units = _units(mask, order)
    assert len({(j, rt) for j, rt, _ in units}) >= 6
    want_d, want_i = ck.nearest_hit_matmul_plain(oc, dp, *tris, mask, *EPS)
    got_d, got_i = _matmul_fold_by_units(oc, dp, *tris, units, True)
    hit = torch.isfinite(want_d)
    assert 100 < int(hit.sum()) < len(hit) - 100
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert bool((got_i[~hit] == 0).all())
    want_dd = ck.nearest_dist_matmul_plain(oc, dp, *tris, mask, *EPS)
    got_dd = _matmul_fold_by_units(oc, dp, *tris, units, False)
    assert torch.equal(got_dd.view(torch.int32), want_dd.view(torch.int32))
    # the wrappers on CPU tensors are the plain versions
    wd, wi = ck.nearest_hit_matmul(oc, dp, *tris, mask, *EPS)
    assert torch.equal(wi, want_i) and torch.equal(wd, want_d)
    assert torch.equal(ck.nearest_dist_matmul(oc, dp, *tris, mask, *EPS), want_dd)
    # the JAX package's kernels on the same features and mask
    jf = jnp.asarray(ck.ray_features(oc, dp).numpy())
    jg = jnp.asarray(ck.pack_tri_features(*tris).numpy())
    jm = jnp.asarray(mask.numpy())
    jd, ji = (np.asarray(x) for x in pk.nearest_hit_mxu(jf, jg, jm, *EPS))
    np.testing.assert_array_equal(np.isfinite(jd), hit.numpy())
    np.testing.assert_array_equal(got_i.numpy(), ji)
    np.testing.assert_allclose(got_d.numpy()[hit], jd[hit], rtol=1e-4)
    jdd = np.asarray(pk.nearest_dist_mxu(jf, jg, jm, *EPS))
    np.testing.assert_array_equal(np.isfinite(jdd), np.isfinite(got_dd.numpy()))
    fin = np.isfinite(jdd)
    np.testing.assert_allclose(got_dd.numpy()[fin], jdd[fin], rtol=1e-4)


def _kernel_ray_features(oc, dp):
    """`load_ray` + `load_ray_features` of csrc/intersect.cu, one float32
    operation at a time: the 13 features a thread keeps (no constant 1)."""
    f = np.float32
    ox, oy, oz = (oc[k].numpy() for k in range(3))
    dx, dy, dz = (dp[k].numpy() for k in range(3))
    dlen2 = f(f(f(dx * dx) + f(dy * dy)) + f(dz * dz))
    dlen = np.sqrt(np.where(dlen2 > 0, dlen2, f(1.0)).astype(np.float64)).astype(f)
    mx = f(f(oy * dz) - f(oz * dy))
    my = f(f(oz * dx) - f(ox * dz))
    mz = f(f(ox * dy) - f(oy * dx))
    return {0: dx, 1: dy, 2: dz, 3: mx, 4: my, 5: mz, 6: ox, 7: oy, 8: oz,
            10: dlen, 11: f(dx / dlen), 12: f(dy / dlen), 13: f(dz / dlen)}


def _kernel_tri_rows(v0c, e1, e2):
    """`stage_features` of csrc/intersect.cu: the 19 staged rows as
    {(plane, row): values}."""
    f = np.float32
    v0x, v0y, v0z = (v0c[:, k].numpy() for k in range(3))
    e1x, e1y, e1z = (e1[:, k].numpy() for k in range(3))
    e2x, e2y, e2z = (e2[:, k].numpy() for k in range(3))
    nx = f(f(e1y * e2z) - f(e1z * e2y))
    ny = f(f(e1z * e2x) - f(e1x * e2z))
    nz = f(f(e1x * e2y) - f(e1y * e2x))
    ax = f(f(e2y * v0z) - f(e2z * v0y))  # e2 x v0
    ay = f(f(e2z * v0x) - f(e2x * v0z))
    az = f(f(e2x * v0y) - f(e2y * v0x))
    bx = f(f(v0y * e1z) - f(v0z * e1y))  # v0 x e1
    by = f(f(v0z * e1x) - f(v0x * e1z))
    bz = f(f(v0x * e1y) - f(v0y * e1x))
    g9 = -f(f(f(v0x * nx) + f(v0y * ny)) + f(v0z * nz))
    return {(0, 0): -nx, (0, 1): -ny, (0, 2): -nz,
            (1, 0): -ax, (1, 1): -ay, (1, 2): -az, (1, 3): e2x, (1, 4): e2y, (1, 5): e2z,
            (2, 0): -bx, (2, 1): -by, (2, 2): -bz, (2, 3): -e1x, (2, 4): -e1y, (2, 5): -e1z,
            (3, 6): nx, (3, 7): ny, (3, 8): nz, (3, 9): g9}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_in_kernel_features_are_the_packed_features():
    pack, op, dp = _packed_case(seed=13)
    oc, v0c, _ = _recentred(pack, op, dp)
    rayf = ck.ray_features(oc, dp).numpy()
    mine = _kernel_ray_features(oc, dp)
    assert sorted(mine) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13]
    for row, values in mine.items():
        np.testing.assert_array_equal(_bits(values), _bits(rayf[row]), err_msg=str(row))
    # what the kernel does not keep: the constant 1 (it adds gt9 as it is) and
    # the two zero rows
    assert (rayf[9] == 1.0).all() and (rayf[14:] == 0.0).all()
    assert np.abs(rayf[3:6]).max() > 0.0  # m = o x d is not vacuous

    g = ck.pack_tri_features(v0c, pack.e1, pack.e2).numpy()
    staged = _kernel_tri_rows(v0c, pack.e1, pack.e2)
    assert len(staged) == 19
    for (plane, row), values in staged.items():
        np.testing.assert_array_equal(_bits(values), _bits(g[plane, row]),
                                      err_msg=str((plane, row)))
    for plane in range(4):  # every row that is not staged is zero
        for row in range(ck.N_FEATURES):
            if (plane, row) not in staged:
                assert (g[plane, row] == 0.0).all(), (plane, row)
    assert np.abs(g[3, 9]).max() > 0.0 and np.abs(g[1, :3]).max() > 0.0
    # x * 1 is x: leaving the multiply by feature 9 out changes no bit
    ones = np.ones_like(g[3, 9])
    np.testing.assert_array_equal(_bits(g[3, 9] * ones), _bits(g[3, 9]))


def test_collide_matmul_takes_the_cards_strided_layout(monkeypatch):
    """`collide` on "cuda_matmul" gets K5's plain, contiguous pair on the CPU
    and the strided halves of its keys on the card: the same hits."""
    jscene = _scene(True)
    g = scene_from_numpy(jscene).geometry
    o, d = (torch.from_numpy(a) for a in _rays(jscene, R=1000, seed=6))
    want = ti.collide(o, d, g, *EPS, backend="cuda_matmul")
    layouts = []

    def strided(*args):
        dist, slot = ck.nearest_hit_matmul_plain(*args)
        dist, slot = ck.key_halves(ck.sweep_key(dist, slot))
        layouts.append((dist.stride(), slot.stride()))
        return dist, slot

    monkeypatch.setattr(ck, "nearest_hit_matmul", strided)
    got = ti.collide(o, d, g, *EPS, backend="cuda_matmul")
    assert layouts == [((2,), (2,))]
    assert 100 < int(want.mask.sum()) < 900
    assert torch.equal(got.mask, want.mask) and torch.equal(got.obj, want.obj)
    for a, b in ((got.dist, want.dist), (got.point, want.point),
                 (got.normal, want.normal)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fetch_rows_checks_a_table_once_where_it_is_made():
    """`pack_geometry` checks and marks its winner table; `fetch_rows` checks
    only a table it has not seen, and still raises on what the kernel does
    not take."""
    jscene = _scene(True)
    g = scene_from_numpy(jscene).geometry
    pack = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj)
    assert pack.table.winner_table_checked
    idx = torch.tensor([0, 5, 1201], dtype=torch.int32)
    assert torch.equal(ck.fetch_rows(pack.table, idx), pack.table[idx.long()])
    fresh = pack.table.clone()
    assert not getattr(fresh, "winner_table_checked", False)
    assert torch.equal(ck.fetch_rows(fresh, idx), pack.table[idx.long()])
    assert fresh.winner_table_checked
    for bad in (torch.zeros((256, 20)), torch.zeros((256,)), torch.zeros((2, 256, 24))):
        with pytest.raises(ValueError, match="24 or 32"):
            ck.check_winner_table(bad)
        with pytest.raises(ValueError, match="24 or 32"):
            ck.fetch_rows(bad, idx)
        assert not getattr(bad, "winner_table_checked", False)
    with pytest.raises(ValueError, match="1-D"):
        ck.fetch_rows(pack.table, idx[None])


def test_sweeps_share_one_wrapper_and_no_worklist():
    """Every sweep launches through `_launch_sweep` on the pair-tile mask
    itself; the ordered worklist is on no launch path."""
    assert set(ck._SWEEP_OUT) == set(ck.LAUNCHES) - {"fetch_rows"}
    assert not hasattr(ck, "_ray_worklist")
    assert ck._SWEEP_OUT["any_hit"] == (torch.bool, 2)  # + live and walked counts
    import inspect
    for fn in (ck._launch_sweep, ck.any_hit, ck.any_hit_walked,
               ck.nearest_hit_matmul, ck.nearest_dist_matmul):
        assert "tile_worklist" not in inspect.getsource(fn)
    for fn in (ck.any_hit, ck.nearest_hit_matmul, ck.nearest_dist_matmul,
               ck.nearest_hit, ck.nearest_dist):
        assert "_launch_sweep" in inspect.getsource(fn)
