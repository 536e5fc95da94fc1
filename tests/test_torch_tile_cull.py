"""The tile cull's per-ray slab test, `ops.cuda_intersect.tile_cull_mask_packed`:
its plain twin on CPU tensors against the JAX package's mask, and on the card
`tile_cull_kernel` against the twin, bit for bit. The same test down the
union-box levels beyond 64 tiles, `tile_cull_mask_levels`: its twin equal to
the flat per-ray mask of the leaves, and on the card
`tile_cull_levels_kernel` against that twin.

Each edge case sits alone in a ray tile whose other 255 rays are parked, so
the tile's mask entry is that one ray's verdict. The cases: rays along the
axes (zero direction components, -0.0 among them), rays starting on a
box's face or inside it, rays pointing away, parked rays (origin 3e29,
direction 0), the padding `pack_rays` adds (origin 1e30, direction
(0, 0, 1)), an empty tile (a point box with `nonempty` False), more than 64
boxes (`partitioning="aabb"` on a lattice of spheres) and more than one
chunk of boxes staged by the kernel (700 random boxes).

A direction component below ~3e-39 (subnormal) is the one place where the
JAX package differs: XLA:CPU treats a subnormal as zero and uses the 1e-30
stand-in, the port divides by it (inv = inf), and where lo - o is 0 the
slab test meets 0 * inf = NaN, which `torch.maximum` carries into the
verdict: the pair is culled. That case is held to a numpy float32 reference
with the same NaN rule, and to the JAX package on its other pairs.

The module imports no JAX: the tests marked `cuda` run on the card, and the
CPU tests import the JAX package where they use it.
"""

import functools

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer
from raytracing_gpu_tpu_torch.models.procedural import (
    make_sphere_grid_scene,
    make_sphere_scene,
)
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.intersect import collide
from raytracing_gpu_tpu_torch.ops.shading import shadow_rays


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The cases are small: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARKED = np.float32(3e29)
SUBNORMAL = np.float32(1e-39)

# (lo, hi) boxes and their nonempty flags: a unit box, a box beside it, a
# thin slab, an empty tile's point box, a flat ground box, a far box
HAND_BOXES = np.array([
    [[-1, -1, -1], [1, 1, 1]],
    [[2, 0, 0], [3, 1, 1]],
    [[-5, -5, 4], [5, 5, 4.5]],
    [[0, 0, 0], [0, 0, 0]],
    [[-1, 0, -1], [1, 0, 1]],
    [[10, 10, 10], [11, 11, 11]],
], np.float32)
HAND_NONEMPTY = np.array([True, True, True, False, True, True])

# (origin, direction) of the edge rays, one ray tile each
EDGE_RAYS = [
    ((0, 0, -5), (0, 0, 1)),          # two zero components, into the unit box
    ((0, 0, -5), (-0.0, 0, 1)),       # -0.0 takes the stand-in too
    ((1, 0, -5), (0, 0, 1)),          # along the unit box's x = hi face
    ((-1, 0.5, -5), (0, 0, 1)),       # along its x = lo face
    ((0, 0, -5), (0, 0, -1)),         # pointing away
    ((0, 0, 0), (0.3, -0.2, 0.9)),    # starting inside
    ((-5, 0, 0), (1, 0, 0)),          # in the ground box's plane y = 0
    ((2.5, 0.5, 0.5), (0, 1, 0)),     # inside the second box, along y
    ((0, 8, 0), (0, -1, 0)),          # straight down through the ground
    ((-20, 10.5, 10.5), (1, 0, 0)),   # toward the far box only
    ((0, 0, 4.25), (1, 0, 0)),        # inside the thin slab, along it
    ((3, 1, 1), (1, 1, 1)),           # from the second box's corner, away
    ((1e19, 0, 0), (-1, 0, 0)),       # far but live, back toward the boxes
    (tuple([PARKED] * 3), (0, 0, 0)),  # parked
]

# rays with a subnormal direction component (see the module's docstring)
SUBNORMAL_RAYS = [
    ((1, 1, 1), (-SUBNORMAL, -SUBNORMAL, -SUBNORMAL)),  # unit box's corner:
    #                                                     NaN on every axis
    ((-1, 0.5, -5), (SUBNORMAL, 0, 1)),  # x = lo face: NaN on x
    ((0, 0.5, -5), (SUBNORMAL, 0, 1)),   # inside the x slab: inv = inf, no NaN
    ((2.5, 0, 0.5), (0, SUBNORMAL, 1)),  # second box's y = lo face: NaN on y
]


def _tiles(rays, tail=0, seed=0):
    """One ray tile per (origin, direction), the rest of each tile parked,
    then `tail` random rays (so `pack_rays` pads the last tile): (R, 3)
    float32 origins and directions."""
    o = np.full((len(rays) * ck.TILE_R + tail, 3), PARKED, np.float32)
    d = np.zeros_like(o)
    for i, (oi, di) in enumerate(rays):
        o[i * ck.TILE_R], d[i * ck.TILE_R] = oi, di
    rng = np.random.RandomState(seed)
    if tail:
        o[-tail:] = rng.uniform(-6, 6, (tail, 3))
        d[-tail:] = rng.uniform(-1, 1, (tail, 3))
    return o, d


def _scene_rays(pack, R, seed):
    """Narrow bundles, one a ray tile, each from a point outside the tiles'
    union toward a point inside it, and a parked tail: (R, 3) float32
    origins and directions."""
    rng = np.random.RandomState(seed)
    lo = pack.tile_aabb[:, 0].amin(0).numpy()
    hi = pack.tile_aabb[:, 1].amax(0).numpy()
    mid, span = (lo + hi) / 2, hi - lo
    n = -(-R // ck.TILE_R)
    eye = rng.randn(n, 3)
    eye = mid + eye / np.linalg.norm(eye, axis=1, keepdims=True) * span.max() * 1.5
    aim = lo + rng.rand(n, 3) * span
    o = np.repeat(eye, ck.TILE_R, 0)[:R]
    d = (np.repeat(aim - eye, ck.TILE_R, 0)[:R]
         + (rng.rand(R, 3) - 0.5) * span * 0.05)
    o, d = o.astype(np.float32), d.astype(np.float32)
    o[-100:], d[-100:] = PARKED, 0.0
    return o, d


def _pack_of(scene):
    g = scene.geometry
    return ck.pack_geometry(g.vertices, g.valid)


def _random_boxes(n, seed):
    """n boxes scattered over [-8, 8]^3, every seventh one an empty tile."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-8, 7, (n, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0, 2, (n, 3))).astype(np.float32)
    nonempty = np.arange(n) % 7 != 3
    boxes = np.where(nonempty[:, None, None], np.stack([lo, hi], 1), 0.0)
    return boxes.astype(np.float32), nonempty


def _case(name):
    """(origins, directions, boxes, nonempty) of one case, as numpy."""
    if name == "edges":
        return (*_tiles(EDGE_RAYS, tail=37), HAND_BOXES, HAND_NONEMPTY)
    if name == "subnormal":
        return (*_tiles(SUBNORMAL_RAYS), HAND_BOXES, HAND_NONEMPTY)
    if name == "many_boxes":  # three chunks of the kernel's 256 boxes
        return (*_tiles(EDGE_RAYS, tail=1000, seed=3), *_random_boxes(700, 5))
    if name == "spheres":
        pack = _pack_of(make_sphere_scene(16, 16, n_lat=8, n_lon=12))
    else:  # "grid": 80 tiles, the flat cull of partitioning="aabb"
        pack = _pack_of(make_sphere_grid_scene(16, 16, nx=4, ny=4, nz=2,
                                               n_lat=16, n_lon=20))
    return (*_scene_rays(pack, 4000, seed=7), pack.tile_aabb.numpy(),
            pack.tile_nonempty.numpy())


CASES = ("edges", "subnormal", "many_boxes", "spheres", "grid")


def _packed(name, device="cpu"):
    o, d, boxes, nonempty = _case(name)
    op, dp, _ = ck.pack_rays(torch.from_numpy(o).to(device),
                             torch.from_numpy(d).to(device))
    return (op, dp, torch.from_numpy(boxes).to(device),
            torch.from_numpy(nonempty).to(device))


def _jax_mask(op, dp, boxes, nonempty):
    import jax
    import jax.numpy as jnp

    from raytracing_gpu_tpu.ops import pallas_intersect as pk

    with jax.disable_jit():
        return np.asarray(pk.tile_cull_mask_packed(
            *(jnp.asarray(t.numpy()) for t in (op, dp, boxes, nonempty))))


def _numpy_mask(op, dp, boxes, nonempty, nan_max=np.maximum, nan_min=np.minimum):
    """The slab test in numpy float32, which keeps subnormals: with
    np.maximum / np.minimum NaN propagates as in torch, with np.fmax /
    np.fmin it is dropped."""
    op, dp, boxes = op.numpy(), dp.numpy(), boxes.numpy()
    with np.errstate(all="ignore"):
        inv = np.float32(1) / np.where(dp == 0, np.float32(1e-30), dp)
        tmin = np.full((boxes.shape[0], op.shape[1]), -np.inf, np.float32)
        tmax = np.full_like(tmin, np.inf)
        for k in range(3):
            t1 = (boxes[:, 0, k][:, None] - op[k][None]) * inv[k][None]
            t2 = (boxes[:, 1, k][:, None] - op[k][None]) * inv[k][None]
            tmin = nan_max(tmin, nan_min(t1, t2))
            tmax = nan_min(tmax, nan_max(t1, t2))
    hit = (tmax >= tmin) & (tmax >= 0) & nonempty.numpy()[:, None]
    return hit.reshape(boxes.shape[0], -1, ck.TILE_R).any(2).astype(np.int32)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_takes_the_plain_twin_on_cpu(name):
    """On CPU tensors the wrapper is the plain twin and counts no launch."""
    args = _packed(name)
    before = dict(ck.LAUNCHES)
    got = ck.tile_cull_mask_packed(*args)
    assert ck.LAUNCHES == before
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (args[2].shape[0], args[0].shape[1] // ck.TILE_R)
    assert torch.equal(got, ck.tile_cull_mask_packed_plain(*args))


@pytest.mark.parametrize("name", ("edges", "many_boxes", "spheres", "grid"))
def test_cull_matches_jax(name):
    """The port's mask equals the JAX package's, and is not all of one kind."""
    args = _packed(name)
    got = ck.tile_cull_mask_packed(*args).numpy()
    np.testing.assert_array_equal(got, _jax_mask(*args))
    assert 0 < got.sum() < got.size
    if name == "edges":  # every edge ray's own verdict, box by box
        n = len(EDGE_RAYS)
        np.testing.assert_array_equal(got[:, :n], _numpy_mask(*args)[:, :n])
        assert not got[~HAND_NONEMPTY].any()  # the empty tile
        assert not got[:, n - 1].any()  # the parked ray's tile
        assert got[:, n].any()  # the random tail with the padding


def test_grid_has_more_than_64_boxes_and_aabb_takes_the_flat_cull(monkeypatch):
    """`partitioning="aabb"` culls every leaf tile through the flat wrapper,
    also beyond 64 tiles; "octree" sends nothing through it, and the levels
    wrapper gets the union-box levels (at most 64 boxes on top) and the
    leaves once. Both masks are the flat per-ray mask of the leaves."""
    pack = _pack_of(make_sphere_grid_scene(16, 16, nx=4, ny=4, nz=2,
                                           n_lat=16, n_lon=20))
    nT = pack.tile_aabb.shape[0]
    assert nT > 64
    o, d = _scene_rays(pack, 4000, seed=7)
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    seen, seen_levels = [], []

    def spy(op, dp, boxes, nonempty):
        seen.append(boxes.shape[0])
        return ck.tile_cull_mask_packed_plain(op, dp, boxes, nonempty)

    def spy_levels(op, dp, levels):
        seen_levels.append([boxes.shape[0] for boxes, _ in levels])
        return ck.tile_cull_mask_levels_plain(op, dp, levels)

    monkeypatch.setattr(ck, "tile_cull_mask_packed", spy)
    monkeypatch.setattr(ck, "tile_cull_mask_levels", spy_levels)
    flat = ck.tile_cull_mask_hierarchical(op, dp, pack, "aabb")
    octree = ck.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    assert seen == [nT]
    assert len(seen_levels) == 1 and seen_levels[0][-1] == nT
    assert 0 < seen_levels[0][0] <= 64 and len(seen_levels[0]) >= 2
    want = ck.tile_cull_mask_packed_plain(op, dp, pack.tile_aabb, pack.tile_nonempty)
    assert torch.equal(flat, want) and torch.equal(octree, want)


def test_subnormal_direction_culls_like_torch_maximum():
    """A subnormal direction component gives inv = inf, and 0 * inf = NaN
    where the ray starts on a face: the NaN-propagating max / min cull the
    pair, as numpy's np.maximum does; np.fmax, which drops the NaN, keeps
    the corner ray's pair (the rule matters). The JAX package, which reads
    subnormals as zero, agrees off the NaN pairs where its positive 1e-30
    stand-in has the component's sign (not the corner ray's)."""
    args = _packed("subnormal")
    got = ck.tile_cull_mask_packed(*args).numpy()
    n = len(SUBNORMAL_RAYS)
    np.testing.assert_array_equal(got[:, :n], _numpy_mask(*args)[:, :n])
    dropped = _numpy_mask(*args, nan_max=np.fmax, nan_min=np.fmin)
    assert got[0, 0] == 0 and dropped[0, 0] == 1  # corner: NaN on every axis
    assert got[0, 1] == 0  # on the x = lo face: NaN on x
    assert got[0, 2] == 1  # inside the x slab: inv = inf, no NaN
    assert got[1, 3] == 0  # on the second box's y = lo face
    apart = np.zeros_like(got, bool)
    apart[:, 0] = True  # negative subnormals: the stand-in turns them around
    apart[0, 1] = apart[1, 3] = True  # the NaN pairs
    np.testing.assert_array_equal(got[~apart], _jax_mask(*args)[~apart])


# ---- the levels: the per-ray test down the union-box hierarchy ----------------


@functools.cache
def _level_pack(name):
    """"grid75": the 75-tile lattice of the cases above, one level over the
    leaves; "grid375": the 96,000-triangle sphere grid, 375 tiles (47 + 375);
    "boxes5000": 5,000 random leaf boxes, three levels over them (the
    pack's boxes only)."""
    if name == "boxes5000":
        boxes, nonempty = _random_boxes(5000, 9)
        return ck.KernelPack(None, torch.from_numpy(boxes), torch.from_numpy(nonempty),
                             None, None, None, None, None, None)
    if name == "grid75":
        scene = make_sphere_grid_scene(16, 16, nx=4, ny=4, nz=2, n_lat=16, n_lon=20)
    else:
        scene = make_sphere_grid_scene(16, 16)
    return _pack_of(scene)


def _mixed_rays(pack, seed):
    """Narrow bundles from outside (`_scene_rays`, 12 ray tiles, the last
    with a parked tail), then incoherent rays from points inside the tiles'
    union in every direction, as mirror and shadow rays spread, every fifth
    one parked, ending in a partial tile that `pack_rays` pads: (R, 3)
    float32 origins and directions."""
    o1, d1 = _scene_rays(pack, 12 * ck.TILE_R, seed)
    rng = np.random.RandomState(seed + 1)
    lo = pack.tile_aabb[:, 0].amin(0).numpy()
    hi = pack.tile_aabb[:, 1].amax(0).numpy()
    n = 4 * ck.TILE_R + 77
    o2 = (lo + rng.rand(n, 3) * (hi - lo)).astype(np.float32)
    d2 = rng.randn(n, 3).astype(np.float32)
    o2[::5], d2[::5] = PARKED, 0.0
    return np.concatenate([o1, o2]), np.concatenate([d1, d2])


def _levels_case(name, device="cpu"):
    """(op, dp, levels, pack) of a levels case on `device`."""
    pack = _level_pack(name)
    o, d = _mixed_rays(pack, seed=11)
    op, dp, _ = ck.pack_rays(torch.from_numpy(o).to(device),
                             torch.from_numpy(d).to(device))
    leaves = (pack.tile_aabb.to(device), pack.tile_nonempty.to(device))
    return op, dp, ck.build_tile_levels(*leaves) + [leaves], pack


LEVEL_CASES = ("grid75", "grid375", "boxes5000")
LEVEL_SIZES = {"grid75": [10, 75], "grid375": [47, 375], "boxes5000": [10, 79, 625, 5000]}


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_levels_twin_is_the_flat_per_ray_cull_of_the_leaves(name):
    """Down the levels each ray enters only the children of the boxes it
    entered itself; a parent's box holds its children's, so the mask is the
    flat per-ray mask of the leaves, also on tiles that mix live, parked and
    padding rays. On the incoherent tiles the interval test of a whole ray
    tile keeps leaf tiles that no ray of the tile enters."""
    op, dp, levels, pack = _levels_case(name)
    assert [b.shape[0] for b, _ in levels] == LEVEL_SIZES[name]
    got = ck.tile_cull_mask_levels_plain(op, dp, levels)
    assert got.dtype == torch.int32 and got.shape == (levels[-1][0].shape[0],
                                                      op.shape[1] // ck.TILE_R)
    assert torch.equal(got, ck.tile_cull_mask_packed_plain(
        op, dp, pack.tile_aabb, pack.tile_nonempty))
    assert torch.equal(got, ck.tile_cull_mask_hierarchical(op, dp, pack, "octree"))
    assert 0 < int(got.sum()) < got.numel()
    interval = ck._interval_slab(op, dp, pack.tile_aabb, pack.tile_nonempty)[0]
    assert (got.bool() <= interval).all()
    assert (interval[:, 12:] & ~got.bool()[:, 12:]).any()


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_levels_wrapper_takes_the_plain_twin_on_cpu(name):
    """On CPU tensors the levels wrapper is its twin and counts no launch."""
    op, dp, levels, _ = _levels_case(name)
    before = dict(ck.LAUNCHES)
    got = ck.tile_cull_mask_levels(op, dp, levels)
    assert ck.LAUNCHES == before
    assert torch.equal(got, ck.tile_cull_mask_levels_plain(op, dp, levels))


def _subnormal_levels():
    """Two top boxes over 16 leaves, and one ray tile per ray of
    SUBNORMAL_LEVEL_RAYS: (op, dp, levels). Leaf 0 is [-1, 1]^3; leaf 1 has
    its lower x face at -2, so its parent, top box 0, does too."""
    rng = np.random.RandomState(4)
    lo = rng.uniform(3, 6, (16, 3)).astype(np.float32)
    hi = (lo + 1).astype(np.float32)
    lo[0], hi[0] = -1, 1
    lo[1], hi[1] = (-2, -0.5, -0.5), (-1.5, 0.5, 0.5)
    leaves = np.stack([lo, hi], 1)
    top = np.stack([leaves[:, 0].reshape(2, 8, 3).min(1),
                    leaves[:, 1].reshape(2, 8, 3).max(1)], 1)
    o, d = _tiles(SUBNORMAL_LEVEL_RAYS)
    op, dp, _ = ck.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    full = torch.ones
    return op, dp, [(torch.from_numpy(top), full(2, dtype=torch.bool)),
                    (torch.from_numpy(leaves), full(16, dtype=torch.bool))]


# all three direction components subnormal and positive: inv = inf on each
SUBNORMAL_LEVEL_RAYS = [
    ((-2, 0, 0), (SUBNORMAL,) * 3),  # on top box 0's x = lo face, outside leaf 0
    ((-3, 0, 0), (SUBNORMAL,) * 3),  # off every face: no NaN anywhere
]


def test_levels_follow_each_rays_own_chain_on_a_subnormal_direction():
    """Where a subnormal direction makes a NaN in one box of the chain and
    not in another, the per-ray chain and the flat test of the leaves part:
    the first ray passes leaf 0 (inv = inf puts every entry at +inf) and
    meets 0 * inf on top box 0's face, so the chain culls what the flat
    test keeps under that box; the second ray, with no NaN, and the leaves
    under top box 1 are alike. The twin follows
    the chain: the numpy mask of each level, ANDed with its parent's."""
    op, dp, levels = _subnormal_levels()
    got = ck.tile_cull_mask_levels_plain(op, dp, levels)
    (top, top_ne), (leaves, leaf_ne) = levels
    flat = ck.tile_cull_mask_packed_plain(op, dp, leaves, leaf_ne)
    chain = (_numpy_mask(op, dp, leaves, leaf_ne)
             & np.repeat(_numpy_mask(op, dp, top, top_ne), 8, 0))
    n = len(SUBNORMAL_LEVEL_RAYS)
    np.testing.assert_array_equal(got.numpy()[:, :n], chain[:, :n])
    assert flat[0, 0] == 1 and not got[:8, 0].any()  # top box 0's NaN
    assert torch.equal(got[:, 1], flat[:, 1])  # no NaN: alike
    assert torch.equal(got[8:], flat[8:])  # under top box 1 alike


def test_wrapper_refuses_other_devices():
    """The plain twin serves CPU tensors only: another device raises, and so
    do tensors on two devices."""
    meta = torch.empty((3, 256), device="meta")
    boxes = torch.empty((4, 2, 3), device="meta")
    nonempty = torch.ones((4,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.tile_cull_mask_packed(meta, meta, boxes, nonempty)
    with pytest.raises(ValueError, match="several devices"):
        ck.tile_cull_mask_packed(torch.zeros((3, 256)), torch.zeros((3, 256)),
                                 torch.zeros((4, 2, 3)), nonempty)


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _require_kernel_equals_twin(args):
    before = ck.LAUNCHES["tile_cull"]
    got, again = ck.tile_cull_mask_packed(*args), ck.tile_cull_mask_packed(*args)
    want = ck.tile_cull_mask_packed_plain(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["tile_cull"] == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(again, got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_the_plain_twin(cuda_device, name):
    got = _require_kernel_equals_twin(_packed(name, cuda_device))
    assert 0 < int(got.sum()) < got.numel()


def _require_levels_kernel_equals_twin(op, dp, levels):
    before = ck.LAUNCHES["tile_cull_levels"]
    got = ck.tile_cull_mask_levels(op, dp, levels)
    again = ck.tile_cull_mask_levels(op, dp, levels)
    want = ck.tile_cull_mask_levels_plain(op, dp, levels)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["tile_cull_levels"] == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(again, got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", LEVEL_CASES)
def test_levels_kernel_equals_the_plain_twin(cuda_device, name):
    op, dp, levels, _ = _levels_case(name, cuda_device)
    got = _require_levels_kernel_equals_twin(op, dp, levels)
    assert 0 < int(got.sum()) < got.numel()
    # the flat kernel over the leaves keeps the same pair tiles
    assert torch.equal(got, ck.tile_cull_mask_packed(op, dp, *levels[-1]))


@pytest.mark.cuda
def test_levels_kernel_follows_the_chain_on_a_subnormal_direction(cuda_device):
    """The kernel takes the twin's per-ray chain where a NaN parts it from
    the flat test."""
    op, dp, levels = (x.to(cuda_device) if torch.is_tensor(x)
                      else [tuple(t.to(cuda_device) for t in lv) for lv in x]
                      for x in _subnormal_levels())
    got = _require_levels_kernel_equals_twin(op, dp, levels)
    assert got[0, 1] == 1 and not got[:8, 0].any()
    flat = ck.tile_cull_mask_packed(op, dp, *levels[1])
    assert flat[0, 0] == 1 and torch.equal(got[8:], flat[8:])


@pytest.mark.cuda
def test_levels_wrapper_refuses_levels_the_kernel_cannot_walk(cuda_device):
    op, dp, levels, _ = _levels_case("grid75", cuda_device)
    with pytest.raises(ValueError, match="group the next by 8"):
        ck.tile_cull_mask_levels(op, dp, [levels[0], levels[0], levels[1]])
    with pytest.raises(ValueError, match="at most 64"):
        ck.tile_cull_mask_levels(op, dp, levels[1:])
    with pytest.raises(ValueError, match="8-byte aligned"):
        shifted = torch.ones(76, dtype=torch.bool, device=cuda_device)[1:]
        ck.tile_cull_mask_levels(op, dp, [levels[0], (levels[1][0], shifted)])
    with pytest.raises(ValueError, match="multiple of"):
        ck.tile_cull_mask_levels(op[:, :100].contiguous(), dp[:, :100].contiguous(),
                                 levels)


@pytest.mark.cuda
def test_kernel_equals_the_plain_twin_on_a_spheres_chunk(cuda_device):
    """A chunk of 65,536 CPU-mode primary rays of `make_sphere_scene` and
    its shadow batch (one block of rays per non-ambient light, missed
    primaries parked), culled against the scene's tiles."""
    scene = make_sphere_scene(256, 256).to(cuda_device)
    g = scene.geometry
    pack = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj,
                            scene.materials)
    r = torch.arange(65536, device=cuda_device)
    coords = camera_ops.cpu_subpixel_coords_traced(256, 256, r)
    u, v, C = camera_ops.camera_basis(scene.camera)
    o, d = camera_ops.make_rays(u, v, C, scene.camera.position, coords)
    hit = collide(o, d, g, backend="cuda", pack=pack)
    so, sd, _ = shadow_rays(scene.lights, hit)
    assert so.shape[0] > o.shape[0]
    for rays in ((o, d), (so, sd)):
        op, dp, _ = ck.pack_rays(*rays)
        got = _require_kernel_equals_twin((op, dp, pack.tile_aabb,
                                           pack.tile_nonempty))
        assert 0 < int(got.sum()) < got.numel()


@pytest.mark.cuda
def test_graph_frame_equals_the_plain_cull_frame(cuda_device, monkeypatch):
    """A `SceneRenderer` graph frame, culled by the kernel, is byte-equal to
    the eager frame culled by the plain twin; the frame graph's bounce step
    records 2 cull launches (nearest-hit and shadow rays), and a frame
    launches 2 a bounce step."""
    scene = make_sphere_scene(32, 32)
    cfg = RenderConfig(backend="cuda")
    graph = SceneRenderer(scene, cfg, device=cuda_device)
    assert graph.plan is not None
    assert graph.plan.graph_launches["step"]["tile_cull"] == 2
    before = ck.LAUNCHES["tile_cull"]
    img = graph.render_device()
    torch.cuda.synchronize()
    steps = sum(graph.plan.last_frame.steps)
    assert steps > 0 and ck.LAUNCHES["tile_cull"] - before == 2 * steps
    monkeypatch.setattr(ck, "tile_cull_mask_packed", ck.tile_cull_mask_packed_plain)
    eager = SceneRenderer(scene, RenderConfig(backend="cuda", unroll="static"),
                          device=cuda_device)
    assert eager.plan is None
    want = eager.render_device()
    u8 = [torch.trunc(x).to(torch.uint8).cpu() for x in (img, want)]
    assert torch.equal(u8[0], u8[1]) and torch.equal(img, want)
