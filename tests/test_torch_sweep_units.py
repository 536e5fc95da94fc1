"""The sweeps' 64-triangle units and their boxes (`ops/cuda_intersect.py`:
`unit_boxes`, `KernelPack.unit_aabb`, `sweep_units_plain`), which let a warp
of K1, K2 or K4 skip a unit that none of its 32 rays enters.

On the CPU:
- `unit_aabb`'s shape, and its equality with a numpy statement of the
  union of the corners and the pad; every vertex of every unit inside its
  box; units of padding and invalid triangles NaN, entered by no ray;
- every (ray, triangle) pair that Möller–Trumbore accepts has its ray
  entering the triangle's unit box (the bound the kernels rely on), with
  rays through vertices and edges, grazing the spheres and lying along the
  boxes' faces;
- `sweep_units_plain` against a brute-force count in numpy on a sphere
  grid, and on a hand-built tile with known answers: one warp entering one
  unit, parked and padding rays entering none, a ray lying along a box face;
- the counts through the recorder where the plain twins run.

On the card (`cuda` marker; `RGT_TEST_TPU=1 python -m pytest
tests/test_torch_sweep_units.py -m cuda` keeps the conftest from importing
jax): K1, K2 and K4 bit-equal to their plain twins on those rays and on a
slice of the benchmark's sphereflake (camera and mirror rays), K1's and
K2's two counts equal to `sweep_units_plain`, fewer scans than offered on
the sphereflake slice.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch.models.procedural import (make_sphere_grid_scene,
                                                        make_sphere_scene)
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
EPS = (1e-7, 0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread keeps pace under several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(scene):
    g = scene.geometry
    return ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj)


def _grid():
    """A 2x2x1 grid of 1,200-triangle spheres: 19 triangle tiles, the last
    part padding."""
    return make_sphere_grid_scene(8, 8, nx=2, ny=2, nz=1, n_lat=16, n_lon=40)


def _numpy_unit_boxes(v0, e1, e2):
    """The union of each unit's corners, padded, in numpy float32."""
    v0, e1, e2 = (np.asarray(a, np.float32) for a in (v0, e1, e2))
    live = (e1 != 0).any(1) & (e2 != 0).any(1)
    corners = np.stack([v0, v0 + e1, v0 + e2], 1)
    lo = np.where(live[:, None], corners.min(1), np.inf).reshape(-1, 64, 3).min(1)
    hi = np.where(live[:, None], corners.max(1), -np.inf).reshape(-1, 64, 3).max(1)
    filled = live.reshape(-1, 64).any(1)
    lo = np.where(filled[:, None], lo, np.float32(0))
    hi = np.where(filled[:, None], hi, np.float32(0))
    side = (hi - lo).max(1, keepdims=True)
    mag = np.maximum(np.abs(lo), np.abs(hi)).max(1, keepdims=True)
    pad = side * np.float32(2.0 ** -8) + mag * np.float32(2.0 ** -16)
    box = np.stack([lo - pad, hi + pad], 1).astype(np.float32)
    box[~filled] = np.nan
    return box


def _numpy_enter(op, dp, boxes):
    """(units, rays) bool: the slab test in numpy float32 (NaN-propagating
    min / max, a zero direction component as 1e-30)."""
    o, d = np.asarray(op, np.float32), np.asarray(dp, np.float32)
    tmin = tmax = None
    with np.errstate(over="ignore", invalid="ignore"):  # inf and NaN are meant
        inv = np.float32(1) / np.where(d == 0, np.float32(1e-30), d)
        for k in range(3):
            t1 = (boxes[:, 0, k][:, None] - o[k][None]) * inv[k][None]
            t2 = (boxes[:, 1, k][:, None] - o[k][None]) * inv[k][None]
            lo_k, hi_k = np.minimum(t1, t2), np.maximum(t1, t2)
            tmin = lo_k if tmin is None else np.maximum(tmin, lo_k)
            tmax = hi_k if tmax is None else np.minimum(tmax, hi_k)
        return (tmax >= tmin) & (tmax >= 0)


def _brute_count(op, dp, mask, boxes):
    """K1's two counts, one (kept pair tile, unit, warp) at a time."""
    enter = _numpy_enter(op, dp, boxes)
    mask = np.asarray(mask)
    offered = scanned = 0
    for j, rt in zip(*np.nonzero(mask > 0)):
        for u in range(4):
            for w in range(8):
                offered += 1
                lanes = slice(rt * 256 + 32 * w, rt * 256 + 32 * (w + 1))
                scanned += bool(enter[4 * j + u, lanes].any())
    return offered, scanned


def _edge_rays(pack, n, seed):
    """(origins, directions) float32: rays from outside through vertices and
    edge midpoints of random triangles, rays grazing their triangles' planes
    (a direction along an edge, from a point just off the plane), and rays
    lying along a face of a random unit's padded box (origin on the face,
    direction in it)."""
    g = torch.Generator().manual_seed(seed)
    live = ((pack.e1 != 0).any(1) & (pack.e2 != 0).any(1)).nonzero()[:, 0]
    tri = live[torch.randint(len(live), (n,), generator=g)]
    v0, e1, e2 = pack.v0[tri], pack.e1[tri], pack.e2[tri]
    k = n // 4
    far = torch.randn((n, 3), generator=g) * 6.0
    # through a vertex and through an edge's midpoint
    through = torch.cat([v0[:k] + e1[:k], v0[k:2 * k] + 0.5 * e2[k:2 * k]])
    o1, d1 = far[:2 * k], through - far[:2 * k]
    # grazing: along an edge, from half a side away, just off the plane
    n_hat = torch.linalg.cross(e1[2 * k:3 * k], e2[2 * k:3 * k])
    n_hat = n_hat / n_hat.norm(dim=1, keepdim=True)
    side = e1[2 * k:3 * k]
    o2 = v0[2 * k:3 * k] - 0.5 * side + 1e-6 * n_hat
    d2 = side + 1e-4 * torch.randn((k, 3), generator=g) * side.norm(dim=1, keepdim=True)
    # along a face of a padded unit box: x = lo.x, moving in y and z across it
    unit = tri[3 * k:] // ck.UNIT_T
    lo, hi = pack.unit_aabb[unit, 0], pack.unit_aabb[unit, 1]
    m = n - 3 * k
    o3 = torch.stack([lo[:, 0], lo[:, 1] - 1.0, 0.5 * (lo[:, 2] + hi[:, 2])], 1)
    d3 = torch.stack([torch.zeros(m), torch.ones(m), torch.rand(m, generator=g) - 0.5], 1)
    o = torch.cat([o1, o2, o3]).to(torch.float32)
    d = torch.cat([d1, d2, d3]).to(torch.float32)
    return o, d


# ---- the boxes ----------------------------------------------------------------

def test_unit_boxes_are_the_padded_union_of_their_corners():
    pack = _pack(_grid())
    Tp = pack.v0.shape[0]
    assert pack.unit_aabb.shape == (Tp // 64, 2, 3)
    assert pack.unit_aabb.dtype == torch.float32 and pack.unit_aabb.is_contiguous()
    want = _numpy_unit_boxes(pack.v0, pack.e1, pack.e2)
    np.testing.assert_array_equal(pack.unit_aabb.numpy(), want)
    assert torch.equal(ck.unit_boxes(pack.v0, pack.e1, pack.e2).nan_to_num(7.0),
                       pack.unit_aabb.nan_to_num(7.0))
    # the last tile is partly padding: its trailing units hold no triangle
    assert torch.isnan(pack.unit_aabb[-1]).all() and not torch.isnan(pack.unit_aabb[0]).any()


def test_every_vertex_lies_inside_its_unit_box():
    scene = _grid()
    pack = _pack(scene)
    v = scene.geometry.vertices[pack.perm.long()]  # (T, 3, 3) in clustered order
    box = pack.unit_aabb[torch.arange(v.shape[0]) // ck.UNIT_T]
    # the triangles Möller–Trumbore can accept: both edges nonzero
    live = ((pack.e1 != 0).any(1) & (pack.e2 != 0).any(1))[:v.shape[0]]
    assert int(live.sum()) > 4000
    v, box = v[live], box[live]
    lo, hi = box[:, None, 0], box[:, None, 1]
    assert bool(((v >= lo) & (v <= hi)).all())
    # strictly inside: the pad is more than the corners' rounding
    assert bool(((v > lo) & (v < hi)).all())


def test_units_without_a_live_triangle_are_entered_by_no_ray():
    scene = make_sphere_scene(8, 8, n_lat=8, n_lon=12)
    g = scene.geometry
    valid = g.valid.clone()
    valid[:64] = False  # one whole unit of invalid triangles, where it lands
    pack = ck.pack_geometry(g.vertices, valid)
    empty = torch.isnan(pack.unit_aabb).any(2).any(1)
    live = ((pack.e1 != 0).any(1) & (pack.e2 != 0).any(1)).reshape(-1, ck.UNIT_T).any(1)
    assert torch.equal(empty, ~live) and int(empty.sum()) >= 2
    gen = torch.Generator().manual_seed(3)
    o = torch.randn((1024, 3), generator=gen) * 3.0
    d = torch.randn((1024, 3), generator=gen)
    d[::7, 0] = 0.0  # zero components: the 1e-30 stand-in
    d[::11] = 0.0
    o[::5] = pack.unit_aabb[0, 0]  # on a box's corner
    op, dp, _ = ck.pack_rays(o, d)
    enter = ck._slab_hits_packed(op, dp, pack.unit_aabb)
    assert not bool(enter[empty].any()) and bool(enter[~empty].any())
    np.testing.assert_array_equal(enter.numpy(), _numpy_enter(op, dp, pack.unit_aabb.numpy()))


def test_every_accepted_pair_enters_its_unit_box():
    """The kernels skip a unit for a warp none of whose rays enters its box;
    that leaves the answer as it was only if every pair Möller–Trumbore
    accepts has its ray entering the triangle's unit box. Rays from a
    camera, through vertices and edges, grazing, and along the boxes' faces."""
    scene = _grid()
    pack = _pack(scene)
    o, d = _edge_rays(pack, 2048, seed=5)
    cam = scene.camera.position.expand(512, 3)
    gen = torch.Generator().manual_seed(6)
    aim = pack.v0[torch.randint(pack.v0.shape[0] - 300, (512,), generator=gen)]
    o, d = torch.cat([o, cam]), torch.cat([d, aim - cam + 0.05 * torch.randn((512, 3),
                                                                           generator=gen)])
    dist = ck.mt_pairs(o, d, pack.v0, pack.e1, pack.e2, *EPS, ref_dist=False)[0]
    dist_ref = ck.mt_pairs(o, d, pack.v0, pack.e1, pack.e2, *EPS)[0]
    accepted = torch.isfinite(dist) | torch.isfinite(dist_ref)
    assert int(accepted.any(1).sum()) > 1000  # most kinds of ray hit something
    op, dp, R = ck.pack_rays(o, d)
    ray, tri = accepted.nonzero(as_tuple=True)
    enter = ck._slab_hits_packed(op, dp, pack.unit_aabb)[:, :R]  # (units, rays)
    assert bool(enter[tri // ck.UNIT_T, ray].all())
    # not vacuous: without the pad some of these rays miss their unit's box
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "UNIT_PAD_SIDE", 0.0)
        mp.setattr(ck, "UNIT_PAD_MAG", 0.0)
        bare = ck.unit_boxes(pack.v0, pack.e1, pack.e2)
    enter = ck._slab_hits_packed(op, dp, bare)[:, :R]
    assert not bool(enter[tri // ck.UNIT_T, ray].all())


# ---- the counts ---------------------------------------------------------------

def test_sweep_units_plain_against_a_brute_force_count():
    scene = _grid()
    pack = _pack(scene)
    o, d = _edge_rays(pack, 1024, seed=8)
    op, dp, _ = ck.pack_rays(o, d)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    offered, scanned = ck.sweep_units_plain(op, dp, mask, pack.unit_aabb)
    assert (int(offered), int(scanned)) == _brute_count(op, dp, mask,
                                                        pack.unit_aabb.numpy())
    assert 0 < int(scanned) < int(offered) == int(mask.sum()) * 32
    # in ray blocks as in one piece
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "_PLAIN_PAIRS", 1)
        assert [int(x) for x in ck.sweep_units_plain(op, dp, mask, pack.unit_aabb)] == \
            [int(offered), int(scanned)]


def _hand_case():
    """One triangle tile and one ray tile, known answers: unit 0 a small
    triangle at z = 5; unit 1 one at x = 100; unit 2 padding only; unit 3 a
    triangle at y = 50. Warp 0: lane 0 aims at unit 0's triangle, its other
    lanes look away; warp 1: one ray lying along the low-x face of unit 3's
    padded box, the rest parked; warps 2-7 parked or padding rays."""
    v0, e1, e2 = (torch.zeros((256, 3)) for _ in range(3))
    v0[0], e1[0], e2[0] = torch.tensor([0.0, 0.0, 5.0]), torch.tensor([1.0, 0, 0]), \
        torch.tensor([0.0, 1.0, 0])
    v0[64], e1[64], e2[64] = torch.tensor([100.0, 0, 0]), torch.tensor([0.0, 1.0, 0]), \
        torch.tensor([0.0, 0, 1.0])
    v0[192], e1[192], e2[192] = torch.tensor([0.0, 50.0, 0]), torch.tensor([1.0, 0, 0]), \
        torch.tensor([0.0, 0, 1.0])
    units = ck.unit_boxes(v0, e1, e2)
    o = torch.full((256, 3), 3e29)
    d = torch.zeros((256, 3))
    o[:32], d[:32] = 0.0, torch.tensor([0.0, 0.0, -1.0])
    d[0] = torch.tensor([0.05, 0.05, 1.0])  # through (0.25, 0.25, 5)
    lo, hi = units[3]
    o[32] = torch.stack([lo[0], 0.5 * (lo[1] + hi[1]), lo[2] - 1.0])
    d[32] = torch.tensor([0.0, 0.0, 1.0])
    o[64:96], d[64:96] = 1e30, torch.tensor([0.0, 0.0, 1.0])
    op, dp = o.t().contiguous(), d.t().contiguous()
    return op, dp, v0, e1, e2, torch.ones((1, 1), dtype=torch.int32), units


def test_hand_built_tile_counts_one_scan_a_warp_that_enters():
    op, dp, v0, e1, e2, mask, units = _hand_case()
    assert torch.isnan(units[2]).all()
    enter = ck._slab_hits_packed(op, dp, units)
    assert enter[0, 0] and not enter[0, 1:].any()  # lane 0 of warp 0 alone
    assert enter[3, 32] and int(enter[3].sum()) == 1  # the ray along the face
    assert not enter[1].any() and not enter[2].any()
    offered, scanned = ck.sweep_units_plain(op, dp, mask, units)
    assert (int(offered), int(scanned)) == (32, 2)
    assert (int(offered), int(scanned)) == _brute_count(op, dp, mask, units.numpy())
    dist, slot = ck.nearest_hit(op, dp, v0, e1, e2, mask, *EPS, units)
    assert torch.isfinite(dist).nonzero().flatten().tolist() == [0] and slot[0] == 0


def test_the_plain_path_counts_k1_and_k2_into_the_recorder():
    op, dp, v0, e1, e2, mask, units = _hand_case()
    with profiling.recording("cpu") as rec:
        ck.nearest_hit(op, dp, v0, e1, e2, mask, *EPS, units)
        ck.nearest_dist(op, dp, v0, e1, e2, mask, *EPS)  # boxes made from the planes
        ck.any_hit(op, dp, v0, e1, e2, mask, *EPS, units)  # K4 counts nothing
    c = rec.export()["counters"]
    assert (c["sweep_units"], c["sweep_units_scanned"]) == (64, 4)
    ck.nearest_hit(op, dp, v0, e1, e2, mask, *EPS, units)  # recorder off: nothing


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _require_sweeps_equal(op, dp, pack, mask, what):
    """K1, K2 and K4 against their plain twins; K1's and K2's counts against
    `sweep_units_plain`. Returns the counts."""
    args = (op, dp, pack.v0, pack.e1, pack.e2, mask, *EPS)
    units = pack.unit_aabb
    kd, ki = ck.nearest_hit(*args, units)
    pd, pi = ck.nearest_hit_plain(*args)
    assert torch.equal(ki, pi), what
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32)), what
    assert torch.equal(ck.nearest_dist(*args, units).view(torch.int32),
                       ck.nearest_dist_plain(*args).view(torch.int32)), what
    assert torch.equal(ck.any_hit(*args, units), ck.any_hit_plain(*args)), what
    want = [int(x) for x in ck.sweep_units_plain(op, dp, mask, units)]
    for name in ("nearest_hit", "nearest_dist"):
        work = ck._launch_sweep(name, *args, units)[1]
        got = work[2:ck._SWEEP_HEAD].view(torch.int64).tolist()
        assert got == want, (what, name, got, want)
    return want, int(torch.isfinite(pd).sum())


@pytest.mark.cuda
def test_sweeps_that_skip_units_equal_their_plain_twins(cuda_device):
    o, d = _edge_rays(_pack(_grid()), 4096, seed=12)
    pack = _pack(_grid().to(cuda_device))
    op, dp, _ = ck.pack_rays(o.to(cuda_device), d.to(cuda_device))
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    (offered, scanned), hits = _require_sweeps_equal(op, dp, pack, mask, "edge rays")
    assert 0 < scanned < offered and hits > 0
    op, dp, v0, e1, e2, mask, units = (t.to(cuda_device) for t in _hand_case())
    args = (op, dp, v0, e1, e2, mask, *EPS)
    for name in ("nearest_hit", "nearest_dist"):
        work = ck._launch_sweep(name, *args, units)[1]
        assert work[2:ck._SWEEP_HEAD].view(torch.int64).tolist() == [32, 2]
    assert torch.equal(ck.nearest_hit(*args, units)[1], ck.nearest_hit_plain(*args)[1])


def _flake_slice(dev, groups=(0, 5, 40, 91 + 100, 91 + 101, 91 + 300, 820)):
    """A few groups of the benchmark's sphereflake (the root sphere, level-1
    and level-2 spheres, level-3 spheres with their level-4 children, the
    floor) as one pack, and the configuration's camera position."""
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    config = json.loads((ROOT / "portbench" / "configs" / "sphereflake.json").read_text())
    parts = []
    for gi in groups:
        spec = config["objects"][gi]
        v, _ = harness.plugin("scenes", spec["shape"]).build(spec)
        parts.append(np.asarray(v, np.float32))
    v = torch.from_numpy(np.concatenate(parts)).to(dev)
    pack = ck.pack_geometry(v, torch.ones(v.shape[0], dtype=torch.bool, device=dev))
    return pack, torch.tensor(config["camera"]["position"], device=dev)


@pytest.mark.cuda
def test_sweeps_on_a_sphereflake_slice_skip_and_stay_equal(cuda_device):
    """Camera rays at the slice's spheres and the mirror rays of their hits:
    bit-equal to the plain twins, counts equal, and fewer scans than
    offered."""
    pack, cam = _flake_slice(cuda_device)
    gen = torch.Generator().manual_seed(21)
    n = 8192
    live = ((pack.e1 != 0).any(1) & (pack.e2 != 0).any(1)).nonzero()[:, 0].cpu()
    aim = pack.v0[live[torch.randint(len(live), (n,), generator=gen)].to(cuda_device)]
    jitter = (torch.rand((n, 3), generator=gen).to(cuda_device) - 0.5) * 0.02
    o, d = cam.expand(n, 3).contiguous(), aim + jitter - cam
    op, dp, R = ck.pack_rays(o, d)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    (offered, scanned), hits = _require_sweeps_equal(op, dp, pack, mask, "camera rays")
    assert 0 < scanned < offered and hits > n // 4
    # mirror rays from the hits: reflected about the winner's normal
    dist, slot = ck.nearest_hit_plain(op, dp, pack.v0, pack.e1, pack.e2, mask, *EPS)
    hit = torch.isfinite(dist[:R])
    s = slot[:R][hit].long()
    nrm = torch.linalg.cross(pack.e1[s], pack.e2[s])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    dh = d[hit] / d[hit].norm(dim=1, keepdim=True)
    mo = o[hit] + dh * dist[:R][hit, None]
    md = dh - 2.0 * (dh * nrm).sum(1, keepdim=True) * nrm
    op, dp, _ = ck.pack_rays(mo, md)
    mask = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    (offered, scanned), hits = _require_sweeps_equal(op, dp, pack, mask, "mirror rays")
    assert 0 < scanned < offered and hits > 0
