"""The port's object-level acceleration layer (partition/) against the JAX
package's: the cases of tests/test_partition.py with the JAX package's
arrays as the expected values.

Integers and booleans (keys, levels, permutations, ranges, links, reach
masks) must be equal exactly, on every row, masked ones included. Boxes are
float32 results of the same operations in the same order and are held to
equality too. The JAX side is evaluated eagerly, op by op, as its own tests
call it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import camera as jcam
from raytracing_gpu_tpu.ops import intersect as jint
from raytracing_gpu_tpu.partition import aabb as jaabb
from raytracing_gpu_tpu.partition import octree as joct
from raytracing_gpu_tpu.partition.apply import with_accel as jwith_accel

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import intersect as tint
from raytracing_gpu_tpu_torch.partition import (
    build_octree,
    compute_object_aabbs,
    compute_scene_aabb,
    hit_aabb,
    position_keys,
)
from raytracing_gpu_tpu_torch.partition.aabb import hit_aabb_forward
from raytracing_gpu_tpu_torch.partition.apply import with_accel
from raytracing_gpu_tpu_torch.partition.octree import octree_object_reach

TREE_FIELDS = [f.name for f in dataclasses.fields(joct.Octree)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes_scene():
    """8 unit boxes at the corners of a [0,16]^3 region + 1 big object
    (tests/test_partition.py), as numpy."""
    rng = np.random.RandomState(0)
    objects = [np.array(c, np.float32) + rng.rand(4, 3, 3).astype(np.float32)
               for c in [(x, y, z) for x in (1, 13) for y in (1, 13) for z in (1, 13)]]
    objects.append(rng.rand(6, 3, 3).astype(np.float32) * 16.0)
    vertices = np.concatenate(objects)
    tri_obj = np.concatenate([np.full((o.shape[0],), i, np.int32)
                              for i, o in enumerate(objects)])
    return vertices, tri_obj, np.ones((vertices.shape[0],), bool), len(objects)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.int64) if want.dtype.kind in "iu"
                                  else got, want.astype(np.int64)
                                  if want.dtype.kind in "iu" else want, err_msg=what)


@pytest.mark.parametrize("pad", [0, 2])
def test_object_and_scene_aabbs(pad):
    v, to, valid, n_obj = _boxes_scene()
    want = jaabb.compute_object_aabbs(jnp.asarray(v), jnp.asarray(to),
                                      jnp.asarray(valid), n_obj + pad)
    got = compute_object_aabbs(_t(v), _t(to), _t(valid), n_obj + pad)
    _same(got, want, "object boxes")
    for o in range(n_obj):
        pts = v[to == o].reshape(-1, 3)
        np.testing.assert_array_equal(got[o, 0].numpy(), pts.min(0))
        np.testing.assert_array_equal(got[o, 1].numpy(), pts.max(0))
    assert np.isinf(got[n_obj:].numpy()).all()  # padding objects: empty boxes
    obj_valid = np.arange(n_obj + pad) < n_obj
    _same(compute_scene_aabb(got, _t(obj_valid)),
          jaabb.compute_scene_aabb(want, jnp.asarray(obj_valid)), "scene box")


def test_hit_aabb_basic_and_on_plane():
    boxes = np.array([[[0, 0, 0], [1, 1, 1]], [[5, 5, 5], [6, 6, 6]]], np.float32)
    o = np.array([[0.5, 0.5, -2.0], [0.5, 0.5, -2.0], [3.0, 0.5, -2.0],
                  [0.5, 0.5, 0.5], [0.0, 0.5, -2.0]], np.float32)
    d = np.array([[0, 0, 1], [0, 0, -1], [0, 0, 1], [1, 0, 0], [0, 0, 1]], np.float32)
    got = hit_aabb(_t(o), _t(d), _t(boxes)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jaabb.hit_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(boxes))))
    assert got[0, 0] and not got[0, 1]
    assert got[1, 0]  # behind-origin hits count
    assert not got[2].any()
    assert got[3, 0]
    assert got[4, 0]  # origin on a slab plane, zero direction component: no NaN cull
    fwd = hit_aabb_forward(_t(o), _t(d), _t(boxes)).numpy()
    np.testing.assert_array_equal(fwd, np.asarray(jaabb.hit_aabb_forward(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(boxes))))
    assert not fwd[1, 0]  # the forward test drops the box behind the ray


def test_hit_aabb_random_rays_equal():
    rng = np.random.RandomState(3)
    o = (rng.rand(300, 3) * 20 - 2).astype(np.float32)
    d = (rng.rand(300, 3) * 2 - 1).astype(np.float32)
    d[::7, 1] = 0.0
    v, to, valid, n_obj = _boxes_scene()
    boxes = compute_object_aabbs(_t(v), _t(to), _t(valid), n_obj + 1)
    want = jaabb.hit_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(boxes.numpy()))
    got = hit_aabb(_t(o), _t(d), boxes).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < got.size


def _trees(pad=0):
    v, to, valid, n_obj = _boxes_scene()
    O = n_obj + pad
    obj_valid = np.arange(O) < n_obj
    ja = jaabb.compute_object_aabbs(jnp.asarray(v), jnp.asarray(to),
                                    jnp.asarray(valid), O)
    jbox = jaabb.compute_scene_aabb(ja, jnp.asarray(obj_valid))
    ta = compute_object_aabbs(_t(v), _t(to), _t(valid), O)
    tbox = compute_scene_aabb(ta, _t(obj_valid))
    return (ja, jbox, jnp.asarray(obj_valid)), (ta, tbox, _t(obj_valid)), n_obj


@pytest.mark.parametrize("pad", [0, 7])
def test_position_keys_equal(pad):
    jargs, targs, _ = _trees(pad)
    for got, want, what in zip(position_keys(*targs), joct.position_keys(*jargs),
                               ("keys", "level", "morton")):
        _same(got, want, what)


@pytest.mark.parametrize("pad", [0, 7])
def test_octree_equals_jax(pad):
    jargs, targs, _ = _trees(pad)
    want, got = joct.build_octree(*jargs), build_octree(*targs)
    for name in TREE_FIELDS:
        _same(getattr(got, name), getattr(want, name), name)


def test_octree_structure():
    """The structural invariants tests/test_partition.py holds the JAX tree
    to, on the port's tree."""
    _, targs, n_obj = _trees()
    tree = build_octree(*targs)
    g = {name: getattr(tree, name).numpy() for name in TREE_FIELDS}
    nv, lvl, parent, box = g["node_valid"], g["node_level"], g["node_parent"], g["node_box"]
    rows = np.flatnonzero(nv)
    assert int(g["n_nodes"]) == len(rows) >= 2
    roots = [r for r in rows if lvl[r] == 0]
    assert len(roots) == 1
    root = roots[0]
    assert parent[root] == -1
    assert g["node_sub_start"][root] == 0 and g["node_sub_end"][root] == n_obj
    for o in range(n_obj):
        r = g["obj_node"][o]
        assert r >= 0 and nv[r]
        slot = int(np.flatnonzero(g["perm"] == o)[0])
        assert g["node_start"][r] <= slot < g["node_end"][r]
    assert sum(int(g["node_end"][r] - g["node_start"][r]) for r in rows) == n_obj
    a = targs[0].numpy()
    for r in rows:
        for c in g["node_children"][r]:
            if c >= 0:
                assert nv[c] and parent[c] == r and lvl[c] == lvl[r] + 1
                assert g["node_sub_start"][r] <= g["node_sub_start"][c]
                assert g["node_sub_end"][c] <= g["node_sub_end"][r]
                assert np.all(box[c, 0] >= box[r, 0] - 1e-5)
                assert np.all(box[c, 1] <= box[r, 1] + 1e-5)
        for slot in range(g["node_start"][r], g["node_end"][r]):
            o = g["perm"][slot]
            assert np.all(a[o, 0] >= box[r, 0] - 1e-4), (r, o)
            assert np.all(a[o, 1] <= box[r, 1] + 1e-4), (r, o)
    corner_nodes = {int(g["obj_node"][o]) for o in range(8)}
    assert len(corner_nodes) == 8 and all(lvl[r] >= 1 for r in corner_nodes)
    assert int(g["obj_node"][8]) == root


def _primary_rays(jscene, w, h):
    u, v, C = jcam.camera_basis(jscene.camera)
    coords = jnp.asarray(np.asarray(jcam.cpu_subpixel_coords(w, h)).reshape(-1, 2))
    o, d = jcam.make_rays(u, v, C, jnp.asarray(jscene.camera.position), coords)
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("partitioning", ["aabb", "octree"])
def test_with_accel_and_cull_mask_equal_jax(partitioning):
    jscene = scene_to_device(jproc.make_sphere_scene(width=8, height=8, n_lat=8, n_lon=12))
    jacc, jtree = jwith_accel(jscene, partitioning)
    tacc, ttree = with_accel(scene_from_numpy(jscene), partitioning)
    _same(tacc.geometry.obj_aabb, jacc.geometry.obj_aabb, "obj_aabb")
    o, d = _primary_rays(jscene, 8, 8)
    want = np.asarray(jint._cull_mask(jnp.asarray(o), jnp.asarray(d), jacc.geometry))
    got = tint._cull_mask(_t(o), _t(d), tacc.geometry).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size  # the mask culls, and not everything
    if partitioning == "aabb":
        assert jtree is None and ttree is None and tacc.geometry.octree is None
        return
    for name in TREE_FIELDS:
        _same(getattr(ttree, name), getattr(jtree, name), name)
    nc = tacc.geometry.octree
    a = tacc.geometry.obj_aabb.numpy()
    obj_node = ttree.obj_node.numpy()
    valid_obj = obj_node >= 0
    assert valid_obj[:3].all()
    nb = nc.node_box.numpy()[np.clip(obj_node, 0, None)]
    assert np.all(nb[valid_obj, 0] <= a[valid_obj, 0] + 1e-4)
    assert np.all(nb[valid_obj, 1] >= a[valid_obj, 1] - 1e-4)
    # the walk equals the JAX package's, and the own-node-box test (cells nest)
    reach = octree_object_reach(_t(o), _t(d), nc).numpy()
    np.testing.assert_array_equal(reach, np.asarray(joct.octree_object_reach(
        jnp.asarray(o), jnp.asarray(d), jacc.geometry.octree)))
    own_hit = hit_aabb(_t(o), _t(d), _t(nb)).numpy()
    np.testing.assert_array_equal(reach[:, valid_obj], own_hit[:, valid_obj])
    assert reach[:, ~valid_obj].all()


def test_scene_from_numpy_carries_the_accel():
    jscene = scene_to_device(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    jacc, _ = jwith_accel(jscene, "octree")
    carried = scene_from_numpy(jacc).geometry
    built = with_accel(scene_from_numpy(jscene), "octree")[0].geometry
    assert torch.equal(carried.obj_aabb, built.obj_aabb)
    for f in dataclasses.fields(built.octree):
        assert torch.equal(getattr(carried.octree, f.name),
                           getattr(built.octree, f.name)), f.name
    assert scene_from_numpy(jscene).geometry.obj_aabb is None


@pytest.mark.parametrize("partitioning", ["aabb", "octree"])
def test_culled_render_identical(partitioning):
    """Backend "torch" with the object-level cull renders the brute-force
    image exactly, and it does apply the pair mask."""
    jscene = jproc.make_sphere_scene(width=24, height=24, n_lat=8, n_lon=12)
    tscene = scene_from_numpy(jscene)
    base = render_scene(tscene, RenderConfig(backend="torch", partitioning="none"),
                        device="cpu")
    accel = render_scene(tscene, RenderConfig(backend="torch",
                                              partitioning=partitioning), device="cpu")
    np.testing.assert_array_equal(base, accel)
    assert base.max() > 0.0


def test_pair_mask_is_applied_by_backend_torch():
    """A box that misses every triangle's rays culls every pair: collide on
    backend "torch" reports no hit, which brute force does not."""
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    o, d = (_t(x) for x in _primary_rays(scene_to_device(
        jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9)), 8, 8))
    assert bool(tint.collide(o, d, tscene.geometry).mask.any())
    far = torch.full((tscene.materials.ns.shape[0], 2, 3), 1e6)
    far[:, 1] += 1.0
    culled = dataclasses.replace(tscene.geometry, obj_aabb=far)
    assert not bool(tint.collide(o, d, culled).mask.any())
    assert not bool(tint.collide_any(o, d, culled).any())


def test_object_cull_drops_a_hit_on_its_box_edge_as_jax_does():
    """Known fault of the object-level cull, in both packages: the slab
    test rounds, so a hit that lies exactly on its object's box can be
    culled. This ray ends on the ground quad's edge x = 20 (in view at
    128x128): brute force hits, the slab test says no. Held so that the
    port's reference renders stay brute force (`partitioning="none"`)."""
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    o = np.array([[-55.0, 7.5, -72.0]], np.float32)
    d = np.array([[0.6503868103, -0.0650386810, 0.7568137050]], np.float32)
    acc, _ = with_accel(tscene, "aabb")
    brute = tint.collide(_t(o), _t(d), tscene.geometry)
    assert bool(brute.mask[0]) and int(brute.obj[0]) == 2
    assert abs(float(brute.point[0, 0]) - 20.0) < 1e-5
    got = hit_aabb(_t(o), _t(d), acc.geometry.obj_aabb).numpy()
    want = np.asarray(jaabb.hit_aabb(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(acc.geometry.obj_aabb.numpy())))
    np.testing.assert_array_equal(got, want)
    assert not got[0, 2]
    assert not bool(tint.collide(_t(o), _t(d), acc.geometry).mask[0])
