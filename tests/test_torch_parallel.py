"""The port's sharded render and training step in a 4-process gloo group on
the CPU (`tests/_torch_dist_worker.py`, suite "parallel", one group for the
whole file), held against the port's own single-process results and the
JAX package's.

- Sharded `match` renders on meshes (4,1), (2,2) and (1,4), backends
  "torch" and "cuda", are `np.trunc`-equal to the single-process render on
  every rank (the JAX package's own criterion for its sharded render).
  `cuda_matmul` recentres on each tile's rays, so its edge winners depend
  on the split: it and the GPU-mode case are held to `assert_images_close`.
- One cross-check against the JAX package's jitted `render_scene_sharded`
  on mesh (4,2), on a jittered scene, with `assert_images_close`.
- Gradients of all 13 groups on meshes (2,1), (1,2) and (2,2) against the
  port's single-process gradients: rtol 1e-5 and atol 1e-6 of each group's
  largest entry. Measured here: backend "torch" equal to the bit, "cuda" at
  most 5.7e-7 of a group's largest entry (vertices and normals on the
  meshes with two scene shards: the shard's own clustering sums the table's
  gradient in another order).
- Not against the JAX package's sharded gradients: those are wrong under
  scene sharding (`test_jax_scene_sharding_scales_vertex_gradients` records
  the factor).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import camera as jcam
from raytracing_gpu_tpu.parallel import make_mesh as jmake_mesh
from raytracing_gpu_tpu.parallel import render_scene_sharded as jrender_sharded
from raytracing_gpu_tpu.parallel.render import check_shardable as jcheck_shardable
from raytracing_gpu_tpu.parallel.train import _loss_and_grads_fn
from raytracing_gpu_tpu.parallel.train import extract_params as jextract

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.intersect import collide
from raytracing_gpu_tpu_torch.parallel import (
    collectives,
    default_mesh,
    extract_params,
    make_mesh,
    make_sharded_renderer,
    make_train_step,
    render_scene_sharded,
)
from raytracing_gpu_tpu_torch.parallel.mesh import SCENE, TILES, Mesh
from raytracing_gpu_tpu_torch.parallel.render import (
    frame_inputs,
    check_shardable,
    split_scene,
)
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS, PARAM_SPECS
from raytracing_gpu_tpu_torch.utils.compare import assert_images_close

import _torch_dist_worker as worker
from _multihost_worker import _train_on_mesh
from test_torch_kernels import _jittered


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core (several
    processes' spinning thread pools on the same cores slow every one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD = 4


@pytest.fixture(scope="module")
def jjittered():
    return _jittered(jproc.make_sphere_scene(width=worker.W, height=worker.W,
                                             n_lat=8, n_lon=12))


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory, jjittered):
    """The 4 ranks, started before the first test of the file and read by
    the tests that need them; the rest run meanwhile."""
    out = tmp_path_factory.mktemp("torch_parallel")
    torch.save(scene_from_numpy(jjittered), out / "jittered_scene.pt")
    run = worker.Launch("parallel", WORLD, out)
    yield run
    run.close()


@pytest.fixture(scope="module")
def scene():
    return worker.sphere_scene()


def _one_process(scene, **kw):
    return render_scene(scene, RenderConfig(**kw), device="cpu")


def _per_rank(group, case, key):
    return [group.load(case, r)[key] for r in range(WORLD)]


def test_jax_scene_sharding_scales_vertex_gradients():
    """A record of the reference's fault, which the port does not copy: the
    JAX package's `vertices` gradient on mesh (1,2) is exactly twice its
    gradient on one device (its combine's all_gather transposes to a sum of
    one identical cotangent per shard). The port's sharded gradients are held
    to its single-process ones instead
    (`test_sharded_gradients_match_one_process`)."""
    W = H = 8
    dev = scene_to_device(jproc.make_sphere_scene(width=W, height=H, n_lat=6, n_lon=9))
    cfg = JConfig(mode="cpu", quantize="smooth", ray_chunk=256, diff_max_depth=2,
                  backend="jnp", partitioning="none")
    coords = jnp.asarray(np.asarray(jcam.cpu_subpixel_coords(W, H)).reshape(-1, 2))
    target = jnp.zeros((W * H, 3), jnp.float32)
    geo = dataclasses.replace(dev.geometry, obj_aabb=None, octree=None)
    rest = dataclasses.replace(dev, geometry=None)
    grads = {}
    for shards in (1, 2):
        fn = jax.jit(_loss_and_grads_fn(jmake_mesh(1, shards), cfg, 2, W * H))
        _, g = fn(jextract(dev), geo, rest, coords, target)
        grads[shards] = np.asarray(g["vertices"])
    assert np.abs(grads[1]).max() > 0.0
    np.testing.assert_allclose(grads[2], 2.0 * grads[1], rtol=1e-5,
                               atol=1e-7 * np.abs(grads[1]).max())


def test_collectives_are_the_identity_without_a_group():
    t = torch.arange(6.0).reshape(3, 2).requires_grad_()
    assert collectives.group_size(None) == 1
    assert collectives.all_gather(t) is t
    for op in (collectives.SUM, collectives.MIN, collectives.MAX):
        assert collectives.all_reduce(t, op) is t
    collectives.barrier(None)


def test_make_sharded_renderer_on_one_rank(scene):
    """World size 1: the renderer bound to a (1,1) mesh gives the
    single-process frame."""
    cfg = RenderConfig(backend="cuda", **worker.MATCH)
    frame_scene, depth, coords = frame_inputs(scene, cfg)
    geo, rest = split_scene(frame_scene)
    render = make_sharded_renderer(make_mesh(1, 1), cfg, depth, worker.W, worker.W,
                                   device="cpu")
    with torch.no_grad():
        img = render(geo, rest, coords).numpy()
    np.testing.assert_array_equal(img, _one_process(scene, **dataclasses.asdict(cfg)))


def test_sharded_entry_points_default_to_the_card(scene):
    mesh = make_mesh(1, 1)
    cfg = RenderConfig(**worker.MATCH)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_scene_sharded(scene, cfg, mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sharded_renderer(mesh, cfg, 1, worker.W, worker.W)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(mesh, RenderConfig(**worker.SMOOTH), scene)


def test_train_step_blur_needs_one_tile(scene):
    two_tiles = Mesh(shape={TILES: 2, SCENE: 1}, ranks=((0,), (1,)), tile=0, shard=0,
                     scene_group=None, tiles_group=None)
    with pytest.raises(ValueError, match="loss_blur requires tiles=1"):
        make_train_step(two_tiles, RenderConfig(**worker.SMOOTH), scene,
                        loss_blur=1.0, device="cpu")
    # a (1,1) mesh steps like no mesh
    init, step = make_train_step(make_mesh(1, 1), RenderConfig(**worker.SMOOTH), scene,
                                 optimizer=worker.zero_step, device="cpu")
    _, step0 = make_train_step(None, RenderConfig(**worker.SMOOTH), scene,
                               optimizer=worker.zero_step, device="cpu")
    coords, target = worker.all_coords(), torch.full((worker.W ** 2, 3), 0.25)
    geo, rest = split_scene(scene)
    _, loss = step(init(extract_params(scene)), geo, rest, coords, target)
    _, loss0 = step0(init(extract_params(scene)), scene, coords, target)
    assert float(loss) == float(loss0)


def test_sharded_render_matches_jax_sharded(group, jjittered):
    """The JAX package's jitted sharded render (pallas backend, mesh (4,2)
    over its 8 virtual devices) against the port's (cuda backend, (2,2))."""
    want = jrender_sharded(jjittered, JConfig(backend="pallas", **worker.MATCH),
                           jmake_mesh(4, 2))
    want = np.trunc(np.asarray(want)).astype(np.uint8)
    for img in _per_rank(group, "renders", "jittered_cuda_2x2"):
        assert_images_close(np.trunc(img).astype(np.uint8), want,
                            context="port (2,2) against JAX (4,2)")


def test_sharded_sgd_matches_jax_tiles_mesh(group, jjittered):
    """Four masked-SGD steps on kd over mesh (4,1): the same losses and kd on
    every rank, and the JAX package's losses to rtol 2e-4."""
    want, _ = _train_on_mesh(jjittered, jmake_mesh(4, 1), backend="jnp")
    results = [group.load("sgd_kd", r) for r in range(WORLD)]
    for res in results[1:]:
        np.testing.assert_array_equal(res["losses"], results[0]["losses"])
        np.testing.assert_array_equal(res["kd"], results[0]["kd"])
    losses = results[0]["losses"]
    assert losses[-1] < losses[0] * 0.95, losses
    np.testing.assert_allclose(losses, want, rtol=2e-4)


@pytest.mark.parametrize("tiles,shards", worker.RENDER_MESHES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sharded_render_matches_one_process(group, scene, backend, tiles, shards):
    ref = _one_process(scene, backend=backend, **worker.MATCH)
    assert ref.max() > 0.0
    for r, img in enumerate(_per_rank(group, "renders", f"{backend}_{tiles}x{shards}")):
        np.testing.assert_array_equal(np.trunc(img), np.trunc(ref), err_msg=f"rank {r}")


@pytest.mark.parametrize("label,kw", [
    ("cuda_matmul_2x2", dict(backend="cuda_matmul", **worker.MATCH)),
    ("gpu_mode_2x2", worker.GPU_MODE),
])
def test_sharded_matmul_and_gpu_mode(group, scene, label, kw):
    ref = np.trunc(_one_process(scene, **kw)).astype(np.uint8)
    images = _per_rank(group, "renders", label)
    for img in images:
        assert_images_close(np.trunc(img).astype(np.uint8), ref, context=label)
        np.testing.assert_array_equal(img, images[0])


def test_check_shardable_and_mesh_size_raise(group, scene, jjittered):
    T = scene.geometry.vertices.shape[0]
    n_scene = 5
    assert T % n_scene
    one_tile = Mesh(shape={TILES: 1, SCENE: n_scene}, ranks=((0,) * n_scene,), tile=0,
                    shard=0, scene_group=None, tiles_group=None)
    with pytest.raises(ValueError) as got:
        check_shardable(scene, one_tile)
    with pytest.raises(ValueError) as want:
        jcheck_shardable(scene_to_device(jjittered), jmake_mesh(1, n_scene))
    assert str(got.value) == str(want.value)
    check_shardable(scene, dataclasses.replace(one_tile, shape={TILES: 1, SCENE: 4}))
    # no process group: only the (1, 1) mesh exists, and it has no groups
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, 1)
    mesh = default_mesh()
    assert mesh.shape == {TILES: 1, SCENE: 1} and mesh.scene_group is None
    assert (mesh.tile, mesh.shard) == (0, 0) and mesh.tiles_group is None
    # in the 4-rank group
    for r in range(WORLD):
        assert str(group.load("too_few_ranks", r)["message"]) == "need 8 devices, have 4"


def test_all_gather_backward_sums_nothing(group):
    """Every rank computes the same loss of the gathered tensor: each gets
    its own slice of the cotangent once (1x, where a summing transpose
    gives 4x)."""
    weight = np.arange(12.0, dtype=np.float32) + 1.0
    want = np.concatenate([np.arange(3.0, dtype=np.float32) + 10.0 * r
                           for r in range(WORLD)])
    for r in range(WORLD):
        res = group.load("gather_backward", r)
        np.testing.assert_array_equal(res["gathered"], want)
        np.testing.assert_array_equal(res["grad"], weight[3 * r:3 * r + 3])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_scene_group_collide_matches_one_process_without_mat(group, scene, backend):
    """Nearest hits with the triangles over 4 shards equal the
    single-process hits bit for bit, and `Hit.mat` is None under the scene
    group, where one process takes it from its 32-wide table."""
    from raytracing_gpu_tpu_torch.ops import camera as camera_ops

    geo = scene.geometry
    pack = ck.pack_geometry(geo.vertices, geo.valid, geo.normals, geo.tri_obj,
                            scene.materials)
    u, v, C = camera_ops.camera_basis(scene.camera)
    o, d = camera_ops.make_rays(u, v, C, scene.camera.position, worker.all_coords())
    hit = collide(o, d, geo, backend=backend, pack=pack)
    assert (hit.mat is not None) == (backend == "cuda")
    assert int(hit.mask.sum()) > 0
    for r in range(WORLD):
        res = group.load("collide_scene_group", r)
        assert bool(res[f"{backend}_mat_is_none"])
        for k in ("point", "normal", "obj", "dist", "mask"):
            got, ref = res[f"{backend}_{k}"], getattr(hit, k).numpy()
            m = hit.mask.numpy() if k in ("point", "normal") else slice(None)
            np.testing.assert_array_equal(got[m], ref[m], err_msg=f"{k} rank {r}")


@pytest.fixture(scope="module")
def one_process_gradients(scene):
    return {b: worker.gradients(None, b, scene) for b in ("torch", "cuda")}


@pytest.mark.parametrize("tiles,shards", worker.GRAD_MESHES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sharded_gradients_match_one_process(group, one_process_gradients, backend,
                                             tiles, shards):
    loss0, grads0 = one_process_gradients[backend]
    label = f"{backend}_{tiles}x{shards}"
    for r in range(tiles * shards):
        res = group.load("gradients", r)
        tile, shard = res[f"{label}_place"]
        np.testing.assert_allclose(res[f"{label}_loss"], loss0, rtol=1e-6)
        for k in PARAM_KEYS:
            want = grads0[k]
            if PARAM_SPECS[k] == SCENE:
                n = want.shape[0] // shards
                want = want[shard * n:(shard + 1) * n]
            scale = max(float(np.abs(grads0[k]).max()), 1e-30)
            np.testing.assert_allclose(res[f"{label}_{k}"], want, rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=f"{k} rank {r}")
        assert np.abs(res[f"{label}_vertices"]).max() > 0.0
