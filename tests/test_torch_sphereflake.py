"""The benchmark's `sphereflake` configuration (Haines' SPD `balls`) and its
shape, `portbench/scenes/sphereflake.py`, on the CPU:

- the census: 1 / 9 / 81 / 729 / 6,561 spheres by level, 550,828 triangles
  with the floor, 821 objects whose groups hold every sphere once;
- every child touches its parent, no two spheres overlap (to depth 3), each
  sphere is `uv_sphere` at its centre and radius;
- the camera's centre ray runs from SPD's `from` to `at`, `up` upwards;
- the port against the benchmark's plain reference on a 2-level flake of
  16,864 triangles in 66 triangle tiles, so that the tile cull's octree
  levels run: every pixel of an 8 x 8 frame;
- every cull of a frame of that flake (camera, mirror and shadow rays) down
  the octree levels equal to the flat per-ray cull of the leaf tiles, and
  inside the interval cull that the levels ran before;
- on the card (`cuda`): the levels kernel against its twin on a chunk of the
  configuration's own primary rays and on their shadow rays, and a graph
  frame of the 2-level flake, one levels launch a cull, against the eager
  frame of the interval cull.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, reference, scenes  # noqa: E402

CONFIG = json.loads((ROOT / "portbench" / "configs" / "sphereflake.json").read_text())
FLAKE = harness.plugin("scenes", "sphereflake")


def _spec():
    return next(o for o in CONFIG["objects"] if o["shape"] == "sphereflake")


def _spheres(depth):
    s = _spec()
    return FLAKE.spheres(tuple(s["center"]), s["radius"], depth)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_census_of_the_configuration():
    spec = _spec()
    levels = _spheres(spec["depth"])
    assert [len(c) for c, _ in levels] == CONFIG["census"]["spheres_per_level"] == \
        [1, 9, 81, 729, 6561]
    flakes = [o for o in CONFIG["objects"] if o["shape"] == "sphereflake"]
    assert len(CONFIG["objects"]) == CONFIG["census"]["objects"] == 821
    assert [o["group"] for o in flakes] == list(range(820))
    # the groups hold every sphere once: by level, the spheres each group's
    # head stands for
    heads = FLAKE.groups(spec["depth"], spec["group_level"])
    seen = [np.zeros(9 ** L, int) for L in range(spec["depth"] + 1)]
    for level, j in (heads[o["group"]] for o in flakes):
        last = spec["depth"] if level == spec["group_level"] else level
        for L in range(level, last + 1):
            n = 9 ** (L - level)
            seen[L][j * n:(j + 1) * n] += 1
    assert all((s == 1).all() for s in seen)
    tris = {tuple(t) for t in spec["levels"]}
    assert tris == {(21, 40), (11, 20), (9, 16), (7, 12), (5, 8)}
    per_sphere = [2 * n_lon * (n_lat - 1) for n_lat, n_lon in spec["levels"]]
    assert per_sphere == [1600, 400, 256, 144, 64]
    s = scenes.build(CONFIG, 16, 16, seed=2**31 + 11)
    assert s.n_triangles == CONFIG["census"]["triangles"] == 550828
    assert sum(o.vertices.shape[0] for o in s.objects[:-1]) == \
        sum(n * t for n, t in zip(CONFIG["census"]["spheres_per_level"], per_sphere))
    assert [o.vertices.shape[0] for o in s.objects[88:93]] == [256, 256, 256, 720, 720]
    assert {o.nr for o in s.objects[:-1]} == {0.5} and s.objects[-1].nr == 0.0
    assert reference.depth_for(max(o.nr for o in s.objects), 64) == 7
    assert len(s.light_kind) == 4 and s.light_kind.count(scenes.POINT) == 3
    # the floor's top face is SPD's polygon at z = -0.5, +-12 on x and y
    floor = s.objects[-1].vertices.reshape(-1, 3)
    assert floor[:, 2].max() == np.float32(-0.5) and np.abs(floor[:, :2]).max() == 12


def test_children_touch_their_parent_and_no_spheres_overlap():
    levels = _spheres(4)
    for L in range(1, 5):
        (c, r), (parent_c, parent_r) = levels[L], levels[L - 1]
        d = np.linalg.norm(c - np.repeat(parent_c, 9, axis=0), axis=1)
        assert np.allclose(d, parent_r + r, rtol=1e-6, atol=0)
        assert r == pytest.approx(parent_r / 3)
    c = np.concatenate([c for c, _ in levels[:4]])
    r = np.concatenate([np.full(len(c), r) for c, r in levels[:4]])
    gap = np.linalg.norm(c[:, None] - c[None], axis=-1) - (r[:, None] + r[None])
    np.fill_diagonal(gap, np.inf)
    # touching pairs (parent and child) meet at a gap of rounding size
    assert gap.min() > -1e-12
    touching = (np.abs(gap) < 1e-9).sum() // 2
    assert touching == 9 + 81 + 729


def test_a_sphere_of_the_flake_is_uv_sphere_at_its_centre_and_radius():
    spec = _spec()
    uv = harness.plugin("scenes", "uv_sphere")
    (c, r) = _spheres(spec["depth"])[3]
    n_lat, n_lon = spec["levels"][3]
    v, n = FLAKE.level_triangles(tuple(spec["center"]), spec["radius"], spec["depth"], 3,
                                 n_lat, n_lon, 100, 1)
    want_v, want_n = uv.build({"center": c[100].tolist(), "radius": r, "n_lat": n_lat,
                               "n_lon": n_lon})
    assert np.array_equal(v, want_v) and np.array_equal(n, want_n)
    # group 91 + 100: that level-3 sphere first, then its 9 children
    gv, _ = FLAKE.build(dict(spec, group=91 + 100))
    assert gv.shape[0] == 144 + 9 * 64 and np.array_equal(gv[:144], want_v)


def test_the_centre_ray_runs_from_spd_from_to_at():
    view, cam = CONFIG["view"], CONFIG["camera"]
    s = scenes.build(CONFIG, 16, 16, seed=5)
    u, v, C, pos = (t.numpy().astype(np.float64) for t in
                    reference.camera_basis(reference.ref_scene(s, "cpu"), 16))
    assert np.array_equal(pos, np.float32(view["from"]))
    want = np.subtract(view["at"], view["from"])
    want /= np.linalg.norm(want)
    centre = pos - C  # the ray through the image plane's centre
    assert np.allclose(centre / np.linalg.norm(centre), want, atol=1e-6)
    assert v @ np.asarray(view["up"]) > 0 and abs(u @ np.asarray(view["up"])) < 1e-7
    assert abs(u @ v) < 1e-6 and cam["fov"] == view["angle"] == 45.0


def _two_level_flake():
    """The configuration at depth 2, tessellated 21x40 / 11x20 / 7x12, one
    object a sphere, no floor, nr 0.09: two bounces in the port and in the
    reference (at nr 0.1 the coefficient after two, 0.1f * 0.1f, is just
    over the 0.01 cutoff, and the port traces a third)."""
    config = copy.deepcopy(CONFIG)
    spec = dict(_spec(), depth=2, levels=[[21, 40], [11, 20], [7, 12]], group_level=2,
                nr=0.09)
    config["objects"] = [dict(spec, group=k) for k in range(91)]
    return config


def test_the_port_renders_a_two_level_flake_as_the_reference_does():
    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, parse_scene_text
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    size = 8
    arrays = scenes.build(_two_level_flake(), size, size, seed=2**31 + 5)
    assert arrays.n_triangles == 16864
    scene = parse_scene_text(scenes.svati_text(arrays))
    render = {"mode": "cpu", "quantize": "match", "backend": "cuda"}
    r = SceneRenderer(scene, RenderConfig(**render), "cpu")
    assert r.depth == 2 and r.pack.tile_aabb.shape[0] == 66
    assert ck.build_tile_levels(r.pack.tile_aabb, r.pack.tile_nonempty)  # octree levels run
    got = np.trunc(r.render_device().numpy()).astype(np.int64).reshape(-1, 3)
    want = reference.frame_pixels(reference.ref_scene(arrays, "cpu"), render,
                                  torch.arange(size * size)).numpy().astype(np.int64)
    assert (want > 0).any(axis=1).mean() > 0.3  # the flake fills 40% of the frame
    mismatch_pct = 100.0 * (got != want).any(axis=1).mean()
    # the spheres cells' `mismatch_pct` limit, 0.5% (it allows for winners
    # that differ on exact ties between the port's clustered order and the
    # file order), on whole pixels: here no pixel of 64 (each is 1.6%)
    assert mismatch_pct <= 0.5, (mismatch_pct, np.abs(got - want).max())


def _interval_octree(op, dp, pack, partitioning="octree"):
    """The hierarchical cull with interval levels: the exact per-ray test on
    the top boxes, below it one interval test of each whole ray tile (its
    box of origins times its box of directions), ANDed with the parent."""
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    levels = ck.build_tile_levels(pack.tile_aabb, pack.tile_nonempty)
    mask = ck.tile_cull_mask_packed(op, dp, *levels[0])
    for boxes, nonempty in levels[1:] + [(pack.tile_aabb, pack.tile_nonempty)]:
        child = ck._interval_slab(op, dp, boxes, nonempty)[0].to(torch.int32)
        mask = child * torch.repeat_interleave(mask, 8, dim=0)[:boxes.shape[0]]
    return mask


def _flake_renderer(size, device, **render):
    from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, parse_scene_text

    arrays = scenes.build(_two_level_flake(), size, size, seed=2**31 + 5)
    scene = parse_scene_text(scenes.svati_text(arrays))
    cfg = RenderConfig(**{"mode": "cpu", "quantize": "match", "backend": "cuda",
                          **render})
    return SceneRenderer(scene, cfg, device)


def test_every_octree_cull_of_a_flake_frame_is_the_flat_per_ray_cull(monkeypatch):
    """A 10 x 10 frame (400 camera rays: the last ray tile padded), its
    mirror rays and its shadow rays, parked where a ray is done: each cull
    down the levels keeps the pair tiles of the flat per-ray test of the 66
    leaf tiles, and none that the interval levels drop; over the frame the
    interval levels keep pair tiles that no ray enters."""
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    r = _flake_renderer(10, "cpu")
    seen = []
    hierarchical = ck.tile_cull_mask_hierarchical

    def spy(op, dp, pack, partitioning):
        got = hierarchical(op, dp, pack, partitioning)
        flat = ck.tile_cull_mask_packed_plain(op, dp, pack.tile_aabb, pack.tile_nonempty)
        interval = _interval_octree(op, dp, pack)
        seen.append((op.shape[1], bool(torch.equal(got, flat)),
                     bool((got <= interval).all()), int((interval - got).sum())))
        return got

    monkeypatch.setattr(ck, "tile_cull_mask_hierarchical", spy)
    r.render_device()
    assert r.pack.tile_aabb.shape[0] == 66
    assert len(seen) >= 4  # nearest and shadow rays, two bounces
    assert {rp for rp, *_ in seen} == {512, 1280}  # camera / mirror; 3 lights
    assert all(equal and inside for _, equal, inside, _ in seen), seen
    assert sum(extra for *_, extra in seen) > 0


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_levels_kernel_equals_its_twin_on_a_sphereflake_chunk(cuda_device):
    """The configuration at 512 x 512 (550,828 triangles, 2,152 tiles under
    levels of 34 and 269 union boxes): a 65,536-ray chunk of CPU-mode
    primary rays through the image's middle, and its shadow batch (one block
    of rays per point light, missed primaries parked)."""
    from raytracing_gpu_tpu_torch import parse_scene_text
    from raytracing_gpu_tpu_torch.ops import camera as camera_ops
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
    from raytracing_gpu_tpu_torch.ops.intersect import collide
    from raytracing_gpu_tpu_torch.ops.shading import shadow_rays

    arrays = scenes.build(CONFIG, 512, 512, seed=2**31 + 7)
    scene = parse_scene_text(scenes.svati_text(arrays)).to(cuda_device)
    g = scene.geometry
    pack = ck.pack_geometry(g.vertices, g.valid, g.normals, g.tri_obj, scene.materials)
    leaves = (pack.tile_aabb, pack.tile_nonempty)
    levels = ck.build_tile_levels(*leaves) + [leaves]
    assert [b.shape[0] for b, _ in levels] == [34, 269, 2152]
    r = torch.arange(8 * 65536, 9 * 65536, device=cuda_device)
    coords = camera_ops.cpu_subpixel_coords_traced(512, 512, r)
    u, v, C = camera_ops.camera_basis(scene.camera)
    o, d = camera_ops.make_rays(u, v, C, scene.camera.position, coords)
    hit = collide(o, d, g, backend="cuda", pack=pack)
    so, sd, _ = shadow_rays(scene.lights, hit)
    assert so.shape[0] == 3 * o.shape[0]
    for rays in ((o, d), (so, sd)):
        op, dp, _ = ck.pack_rays(*rays)
        before = ck.LAUNCHES["tile_cull_levels"]
        got = ck.tile_cull_mask_levels(op, dp, levels)
        want = ck.tile_cull_mask_levels_plain(op, dp, levels)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["tile_cull_levels"] == before + 1
        assert torch.equal(got, want)
        assert torch.equal(got, ck.tile_cull_mask_packed(op, dp, *leaves))
        assert 0 < int(got.sum()) < got.numel()
        assert (got <= _interval_octree(op, dp, pack)).all()


@pytest.mark.cuda
def test_graph_frame_of_a_flake_equals_the_interval_cull_frame(cuda_device, monkeypatch):
    """The 2-level flake at 32 x 32 (66 tiles): the graph frame, culled by
    the levels kernel, is byte-equal to the eager frame culled by the
    interval levels, since both keep every pair tile that holds a winner;
    the frame graph's bounce step records one levels launch a cull (nearest
    and shadow rays) and no flat one, and a frame launches 2 a bounce step."""
    from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck

    graph = _flake_renderer(32, cuda_device)
    assert graph.plan is not None and graph.pack.tile_aabb.shape[0] == 66
    assert graph.plan.graph_launches["step"]["tile_cull_levels"] == 2
    assert graph.plan.graph_launches["step"]["tile_cull"] == 0
    before = ck.LAUNCHES["tile_cull_levels"]
    img = graph.render_device()
    torch.cuda.synchronize()
    steps = sum(graph.plan.last_frame.steps)
    assert steps > 0 and ck.LAUNCHES["tile_cull_levels"] - before == 2 * steps
    monkeypatch.setattr(ck, "tile_cull_mask_hierarchical", _interval_octree)
    eager = _flake_renderer(32, cuda_device, unroll="static")
    assert eager.plan is None
    want = eager.render_device()
    assert torch.equal(img, want)
