"""PyTorch port against the JAX package: intersection, shading and the
end-to-end CPU-mode render, plus the port's import and device contracts.

Tolerances:
- collide / collide_dist: the criteria of tests/test_pallas.py:29-55
  (identical masks and objects, dist rtol 5e-7, point and normal rtol 5e-6
  atol 1e-5) against JAX "jnp" (port "torch") and "pallas" (port "cuda").
- shade: colors within 1e-3 of 255 (pow differs by an ulp between the two
  libraries), with identical shadow decisions.
- render: bit-equal to the JAX "jnp" render evaluated op by op
  (jax.disable_jit) — the whole pipeline rounds identically; against the
  jitted JAX renders (XLA:CPU contracts multiply-adds into FMAs, which flips
  seam ties) `assert_images_close(tol=1)`, the comparator the JAX package
  uses between its own backends.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import intersect as jint
from raytracing_gpu_tpu.ops import shading as jshade
from raytracing_gpu_tpu.ops.colors import ColorOps as JColorOps
from raytracing_gpu_tpu.render import render_scene as jrender
from raytracing_gpu_tpu.utils.compare import assert_images_close

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops import intersect as tint
from raytracing_gpu_tpu_torch.ops import shading as tshade
from raytracing_gpu_tpu_torch.ops.colors import ColorOps

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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERES = dict(width=16, height=16, n_lat=8, n_lon=12)
GRID = dict(width=16, height=16, nx=4, ny=4, nz=2, n_lat=16, n_lon=20)
BACKENDS = [("torch", "jnp"), ("cuda", "pallas")]


@pytest.fixture(scope="module")
def scenes():
    jscene = _jittered(jproc.make_sphere_scene(**SPHERES))
    return jscene, scene_to_device(jscene), scene_from_numpy(jscene)


def _random_rays(seed, R=600):
    rng = np.random.RandomState(seed)
    o = (rng.rand(R, 3) * 6.0 - 3.0).astype(np.float32)
    d = (rng.rand(R, 3) * 2.0 - 1.0).astype(np.float32)
    o[-40:] = 3e29  # parked, as the render sends them
    d[-40:] = 0.0
    return o, d


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_collide_matches_jax(scenes, port_backend, jax_backend):
    _, dev, tscene = scenes
    o, d = _random_rays(1)
    jhit = jint.collide(jnp.asarray(o), jnp.asarray(d), dev.geometry,
                        backend=jax_backend)
    thit = tint.collide(torch.from_numpy(o), torch.from_numpy(d), tscene.geometry,
                        backend=port_backend)
    m = np.asarray(jhit.mask)
    assert 20 < m.sum() < len(m) - 40
    np.testing.assert_array_equal(thit.mask.numpy(), m)
    np.testing.assert_array_equal(thit.obj.numpy()[m], np.asarray(jhit.obj)[m])
    np.testing.assert_allclose(thit.dist.numpy()[m], np.asarray(jhit.dist)[m], rtol=5e-7)
    np.testing.assert_allclose(thit.point.numpy()[m], np.asarray(jhit.point)[m],
                               rtol=5e-6, atol=1e-5)
    np.testing.assert_allclose(thit.normal.numpy()[m], np.asarray(jhit.normal)[m],
                               rtol=5e-6, atol=1e-5)
    assert not np.isfinite(thit.dist.numpy()[~m]).any()


@pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
def test_collide_dist_and_any_match_jax(scenes, port_backend, jax_backend):
    _, dev, tscene = scenes
    o, d = _random_rays(2)
    jfd = np.asarray(jint.collide_dist(jnp.asarray(o), jnp.asarray(d), dev.geometry,
                                       backend=jax_backend))
    args = (torch.from_numpy(o), torch.from_numpy(d), tscene.geometry)
    tfd = tint.collide_dist(*args, backend=port_backend).numpy()
    np.testing.assert_array_equal(tfd != 0.0, jfd != 0.0)
    # "jnp" evaluates op by op like the port (rounding identical); the jitted
    # Pallas interpreter contracts multiply-adds into FMAs (see
    # tests/test_torch_kernels.py): a few ulp
    np.testing.assert_allclose(tfd, jfd, rtol=5e-7 if jax_backend == "jnp" else 2e-6)
    assert (tfd[-40:] == 0.0).all()  # parked rays report a miss
    np.testing.assert_array_equal(tint.collide_any(*args, backend=port_backend).numpy(),
                                  jfd != 0.0)


def test_backends_agree_exactly(scenes):
    """"torch" (all pairs, file order) and "cuda" (culled, clustered order,
    plain kernels here) make the same decisions on jittered geometry."""
    _, _, tscene = scenes
    o, d = (torch.from_numpy(x) for x in _random_rays(3))
    a = tint.collide(o, d, tscene.geometry, backend="torch")
    b = tint.collide(o, d, tscene.geometry, backend="cuda")
    m = a.mask
    assert torch.equal(m, b.mask) and bool(m.any())
    assert torch.equal(a.dist, b.dist)  # +inf on a miss
    for f in ("obj", "point", "normal"):  # garbage on a miss
        assert torch.equal(getattr(a, f)[m], getattr(b, f)[m]), f


def test_shade_matches_jax(scenes):
    _, dev, tscene = scenes
    rng = np.random.RandomState(4)
    R = 512
    cam = np.asarray(dev.camera.position)
    o = np.broadcast_to(cam, (R, 3)).astype(np.float32)
    d = (rng.rand(R, 3) * [1.6, 1.0, 0.6] - [0.8, 0.6, -0.7]).astype(np.float32)
    jhit = jint.collide(jnp.asarray(o), jnp.asarray(d), dev.geometry)
    thit = tint.collide(torch.from_numpy(o), torch.from_numpy(d), tscene.geometry)
    m = np.asarray(jhit.mask)
    assert m.sum() > R // 4
    want = np.asarray(jshade.shade(dev, jhit, JColorOps("match")))
    got = tshade.shade(tscene, thit, ColorOps("match")).numpy()
    np.testing.assert_allclose(got[m], want[m], atol=1e-3)
    # the shadow pass went through the kernel path too
    got_cuda = tshade.shade(tscene, thit, ColorOps("match"), backend="cuda").numpy()
    np.testing.assert_array_equal(got_cuda[m], got[m])


def test_render_bit_equal_to_eager_jax():
    """The whole CPU-mode pipeline (camera, recursion, shadows, fold) equals
    the JAX package's op-by-op evaluation to the last bit, on both backends."""
    jscene = jproc.make_sphere_scene(**SPHERES)
    with jax.disable_jit():
        want = np.asarray(jrender(jscene, JConfig(backend="jnp", partitioning="none")))
    tscene = scene_from_numpy(jscene)
    for backend in ("torch", "cuda"):
        got = render_scene(tscene, RenderConfig(backend=backend), device="cpu")
        assert got.dtype == np.float32 and got.shape == (16, 16, 3)
        np.testing.assert_array_equal(got, want, err_msg=backend)


@pytest.mark.parametrize("make,kw", [(jproc.make_sphere_scene, SPHERES),
                                     (jproc.make_sphere_grid_scene, GRID)],
                         ids=["spheres", "grid"])
def test_render_matches_jitted_jax(make, kw):
    jscene = make(**kw)
    tscene = scene_from_numpy(jscene)
    ref = {b: np.trunc(jrender(jscene, JConfig(backend=b))).astype(np.uint8)
           for b in ("jnp", "pallas")}
    for port_backend, jax_backend in BACKENDS:
        got = np.trunc(render_scene(tscene, RenderConfig(backend=port_backend),
                                    device="cpu")).astype(np.uint8)
        assert_images_close(got, ref[jax_backend], tol=1,
                            context=f"port {port_backend} vs jax {jax_backend}")


def test_block_swizzle_is_pure_reordering():
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=16, height=8,
                                                      n_lat=8, n_lon=12))
    imgs = [render_scene(tscene, RenderConfig(backend="cuda", block_rays=b,
                                              ray_chunk=96), device="cpu")
            for b in ("on", "off")]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    # a chunk not divisible by 4 takes the unfolded path: same image
    odd = render_scene(tscene, RenderConfig(backend="cuda", ray_chunk=90), device="cpu")
    np.testing.assert_array_equal(odd, imgs[0])


def test_smooth_quantize_renders():
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    img = render_scene(tscene, RenderConfig(quantize="smooth"), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 255.0 and img.max() > 0.0


def test_kernel_render_on_cpu_launches_nothing():
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    before = dict(ck.LAUNCHES)
    render_scene(tscene, RenderConfig(backend="cuda"), device="cpu")
    assert ck.LAUNCHES == before


def test_unported_options_raise():
    """The options that used to raise now render through every entry point
    (GPU mode, the front-to-back sweep, the any-hit sweep, the matmul
    backend); what the port does not have is still refused by name, and the
    differentiable path's `unroll` is validated and otherwise ignored."""
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    base = render_scene(tscene, RenderConfig(), device="cpu")
    gpu = SceneRenderer(tscene, RenderConfig(mode="gpu"), device="cpu").render()
    assert gpu.shape == base.shape == (8, 8, 3) and gpu.max() > 0.0
    assert not np.array_equal(gpu, base)  # another sampling grid
    for kw in (dict(f2b_tiles=4), dict(any_hit_min_tris=0), dict(unroll="static"),
               dict(unroll="while", remat=False)):
        np.testing.assert_array_equal(
            render_scene(tscene, RenderConfig(**kw), device="cpu"), base, err_msg=str(kw))
    img = render_scene(tscene, RenderConfig(backend="cuda_matmul"), device="cpu")
    assert_images_close(np.trunc(img).astype(np.uint8), np.trunc(base).astype(np.uint8),
                        tol=1, context="cuda_matmul vs cuda")
    for bad in (dict(backend="pallas"), dict(backend="mxu"), dict(backend="jnp"),
                dict(mode="tpu"), dict(f2b_tiles=-1), dict(any_hit_min_tris=-1),
                dict(unroll="scan")):
        with pytest.raises(ValueError):
            RenderConfig(**bad)


def test_cuda_device_raises_without_cuda():
    """No hidden CPU path: asking for the GPU on a host without CUDA fails."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=8, n_lat=6, n_lon=9))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SceneRenderer(tscene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_scene(tscene, device="cuda")


MINI_SVATI = """camera 4 4 0.0 0.0 -4.0 1.0 0.0 0.0 0.0 -1.0 0.0 90.0
a_light 0.6 0.6 0.6
d_light 1.0 1.0 1.0 0.5 -1.0 1.0
object 3
Kd 0.8 0.2 0.1
Ka 0.5 0.5 0.5
v 1.0 2.0 0.0
v -1.0 -1.0 0.0
v 1.0 -1.0 0.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
"""


def _run(args, cwd, timeout=300):
    # one intra-op thread, as in this process (see _one_torch_thread)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_never_imports_jax(tmp_path):
    (tmp_path / "mini.svati").write_text(MINI_SVATI)
    code = (
        "import sys\n"
        "import raytracing_gpu_tpu_torch as p\n"
        "from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene\n"
        "from raytracing_gpu_tpu_torch.__main__ import main\n"
        "import raytracing_gpu_tpu_torch.csrc.build, raytracing_gpu_tpu_torch.utils.image\n"
        "import raytracing_gpu_tpu_torch.native.svati, raytracing_gpu_tpu_torch.utils.inspect\n"
        "import raytracing_gpu_tpu_torch.utils.profiling\n"
        "parsed = p.parse_scene('mini.svati', native='auto')\n"
        "assert parsed.n_triangles == 1, parsed.n_triangles\n"
        "scene = make_sphere_scene(4, 4, n_lat=6, n_lon=9)\n"
        "for kw in ({}, {'mode': 'gpu', 'any_hit_min_tris': 0, 'f2b_tiles': 1},\n"
        "           {'backend': 'cuda_matmul'}):\n"
        "    img = p.render_scene(scene, p.RenderConfig(**kw), device='cpu')\n"
        "    assert img.shape == (4, 4, 3) and img.max() > 0.0, kw\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.startswith('raytracing_gpu_tpu.') or m == 'raytracing_gpu_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cli_writes_ppm(tmp_path):
    scene = tmp_path / "mini.svati"
    scene.write_text(MINI_SVATI)
    out = tmp_path / "out.ppm"
    res = _run(["-m", "raytracing_gpu_tpu_torch", str(scene), str(out),
                "--device", "cpu"], tmp_path)
    assert res.returncode == 0, res.stderr
    toks = out.read_text().split()
    assert toks[:4] == ["P3", "4", "4", "255"] and len(toks) == 4 + 4 * 4 * 3
    # the same pixels as the JAX package's CLI writer on the same scene
    from raytracing_gpu_tpu.models.parser import parse_scene_text
    from raytracing_gpu_tpu_torch.utils.image import ppm_bytes

    want = jrender(parse_scene_text(MINI_SVATI), JConfig())
    assert out.read_bytes() == ppm_bytes(want)


def test_cli_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    scene = tmp_path / "mini.svati"
    scene.write_text(MINI_SVATI)
    res = _run(["-m", "raytracing_gpu_tpu_torch", str(scene),
                str(tmp_path / "out.ppm")], tmp_path)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not (tmp_path / "out.ppm").exists()
