"""PyTorch port against the JAX package: the GPU-mode render path (one ray
per hi-res pixel, the do/while bounce loop, the uint8 box downscale).

Tolerances:
- `gpu_pixel_coords_traced`: small integers as float32, exactly equal.
- `assemble_gpu_image`: the box sums are integers <= 255*9 = 2295, exact in
  float32 in any order, and the two divisions and the multiply are single
  correctly rounded operations: exactly equal for aliasing 1, 2 and 3.
- whole render against the JAX package evaluated op by op
  (`jax.disable_jit()`, backend "jnp", partitioning "none"): bit-equal on the
  port's "torch" and "cuda" backends, on the reflective sphere scene (several
  bounces), with the default cutoff and with a cutoff equal to a mirror's
  coefficient (the loop's test is a strict `>`).
- against the jitted JAX renders ("jnp" and "pallas"):
  `assert_images_close(tol=1)`, the comparator the JAX package uses between
  its own backends, on a scene whose vertices are jittered by 2e-3. XLA:CPU
  contracts multiply-adds into FMAs, which decides the 0-1 ulp ties on the
  tessellation seams of the mirror-symmetric procedural scene either way;
  GPU mode's integer pixel offsets put a whole ray column on the seam, so
  on the unjittered scene even the JAX package's own "jnp" and "pallas"
  renders differ on 8 of 144 pixels.
- the CLI with `--mode gpu --device cpu` writes the bytes the JAX package's
  writer gives its own GPU-mode render of the same file.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig as JConfig
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.ops import camera as jcam
from raytracing_gpu_tpu.render import assemble_gpu_image as j_assemble
from raytracing_gpu_tpu.render import render_scene as jrender
from raytracing_gpu_tpu.utils.compare import assert_images_close

from raytracing_gpu_tpu_torch import RenderConfig, SceneRenderer, render_scene
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.ops import camera as tcam
from raytracing_gpu_tpu_torch.render import assemble_gpu_image

from test_torch_kernels import _jittered
from test_torch_render import MINI_SVATI, _run

SPHERES = dict(width=12, height=12, n_lat=8, n_lon=12)


@pytest.mark.parametrize("width,height", [(12, 12), (10, 6), (7, 9)])
def test_gpu_pixel_coords_match_jax(width, height):
    r = np.arange(width * height, dtype=np.int32)
    want = np.asarray(jcam.gpu_pixel_coords_traced(width, height, jnp.asarray(r)))
    got = tcam.gpu_pixel_coords_traced(width, height, torch.from_numpy(r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (width * height, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quantize", ["match", "smooth"])
@pytest.mark.parametrize("aliasing", [1, 2, 3])
def test_assemble_gpu_image_matches_jax(aliasing, quantize):
    width, height = 7, 5
    rng = np.random.RandomState(100 + aliasing)
    # beyond [0, 255] on both sides: the smooth domain clamps only here
    colors = (rng.rand(height * aliasing * width * aliasing, 3) * 300.0
              - 20.0).astype(np.float32)
    if quantize == "match":
        colors = np.clip(colors, 0.0, 255.0)
    want = np.asarray(j_assemble(
        jnp.asarray(colors), JConfig(aliasing=aliasing, quantize=quantize),
        width, height))
    got = assemble_gpu_image(
        torch.from_numpy(colors), RenderConfig(aliasing=aliasing, quantize=quantize),
        width, height)
    assert tuple(got.shape) == (height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want)


# 0.45 is one mirror's nr: after its bounce nr_acc equals the cutoff exactly,
# and `nr_acc > cutoff` ends the ray where `>=` would go on
@pytest.mark.parametrize("extra", [{}, {"reflect_cutoff": 0.45, "max_bounce": 3}],
                         ids=["default", "cutoff_at_nr"])
def test_gpu_render_bit_equal_to_eager_jax(extra):
    """The whole GPU-mode pipeline (hi-res camera, bounce loop, shadows,
    downscale, flips) equals the JAX package's op-by-op evaluation to the
    last bit, on both backends, with mirrors in the scene."""
    jscene = jproc.make_sphere_scene(**SPHERES)
    assert np.float32(0.45) in jscene.materials.nr
    kw = dict(mode="gpu", aliasing=2, **extra)
    with jax.disable_jit():
        want = np.asarray(jrender(jscene, JConfig(backend="jnp",
                                                  partitioning="none", **kw)))
    assert want.max() > 0.0
    tscene = scene_from_numpy(jscene)
    for backend in ("torch", "cuda"):
        got = render_scene(tscene, RenderConfig(backend=backend, **kw), device="cpu")
        assert got.dtype == np.float32 and got.shape == (12, 12, 3)
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_gpu_render_matches_jitted_jax():
    jscene = _jittered(jproc.make_sphere_scene(**SPHERES))
    tscene = scene_from_numpy(jscene)
    for port_backend, jax_backend in (("torch", "jnp"), ("cuda", "pallas")):
        ref = np.trunc(jrender(jscene, JConfig(mode="gpu", backend=jax_backend))
                       ).astype(np.uint8)
        got = np.trunc(render_scene(tscene, RenderConfig(mode="gpu",
                                                         backend=port_backend),
                                    device="cpu")).astype(np.uint8)
        assert_images_close(got, ref, tol=1,
                            context=f"gpu mode: port {port_backend} vs jax {jax_backend}")


def test_gpu_mode_tail_chunk_and_renderer_fields():
    """A chunk size that does not divide the ray count clamps the tail
    chunk's ids: same image. GPU mode has no recursion depth."""
    tscene = scene_from_numpy(jproc.make_sphere_scene(width=8, height=6,
                                                      n_lat=6, n_lon=9))
    cfg = RenderConfig(mode="gpu", aliasing=2)
    r = SceneRenderer(tscene, cfg, device="cpu")
    assert r.depth is None and (r.width, r.height) == (8, 6)
    whole = r.render()
    odd = render_scene(tscene, dataclasses.replace(cfg, ray_chunk=50), device="cpu")
    np.testing.assert_array_equal(odd, whole)
    # the scene handed in keeps its own camera size
    assert (tscene.camera.width, tscene.camera.height) == (8, 6)


def test_gpu_mode_bounce_cap_terminates():
    """nr = 1.0 mirrors never decay: the loop ends at max_bounce. More
    bounces add light until the deepest mirror path is exhausted."""
    jscene = _jittered(jproc.make_sphere_scene(width=16, height=16, n_lat=6,
                                               n_lon=9, reflective=True))
    nr = np.where(jscene.materials.nr > 0, 1.0, 0.0).astype(np.float32)
    jscene = dataclasses.replace(
        jscene, materials=dataclasses.replace(jscene.materials, nr=nr))
    tscene = scene_from_numpy(jscene)
    e = {}
    for mb in (0, 1, 10, 12):
        img = render_scene(tscene, RenderConfig(mode="gpu", aliasing=1,
                                                max_bounce=mb), device="cpu")
        e[mb] = float(img.sum())
        if mb < 12:  # the JAX package's image under the same cap
            want = jrender(jscene, JConfig(mode="gpu", aliasing=1, max_bounce=mb))
            assert_images_close(np.trunc(img).astype(np.uint8),
                                np.trunc(want).astype(np.uint8), tol=1,
                                context=f"nr=1 mirrors, max_bounce={mb}")
    assert 0.0 < e[0] < e[1] < e[10]  # max_bounce + 1 iterations: 0 is one
    assert abs(e[10] - e[12]) / e[10] < 0.02


def test_gpu_mode_downscale_identity_at_aliasing_1():
    """With aliasing 1 a box is one uint8-quantized texel: integer output."""
    tscene = scene_from_numpy(jproc.make_sphere_scene(
        width=24, height=24, n_lat=8, n_lon=12, reflective=False))
    img = render_scene(tscene, RenderConfig(mode="gpu", aliasing=1), device="cpu")
    assert np.all(img == np.trunc(img))
    assert img.min() >= 0.0 and img.max() <= 255.0 and img.max() > 0.0


def test_cli_gpu_mode_writes_the_jax_bytes(tmp_path):
    scene = tmp_path / "mini.svati"
    scene.write_text(MINI_SVATI)
    out = tmp_path / "out.ppm"
    res = _run(["-m", "raytracing_gpu_tpu_torch", str(scene), str(out),
                "--mode", "gpu", "--aliasing", "2", "--max-bounce", "3",
                "--device", "cpu"], tmp_path)
    assert res.returncode == 0, res.stderr
    from raytracing_gpu_tpu.models.parser import parse_scene_text
    from raytracing_gpu_tpu.utils.image import ppm_bytes

    want = jrender(parse_scene_text(MINI_SVATI),
                   JConfig(mode="gpu", aliasing=2, max_bounce=3))
    assert want.max() > 0.0
    assert out.read_bytes() == ppm_bytes(want)
