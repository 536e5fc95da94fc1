"""PyTorch port against the JAX package: scene building, parser, procedural
scenes, camera rays and color ops.

Every comparison here is exact (bit for bit): these are host-side or
elementwise float32 computations that both packages evaluate in the same
order. The JAX side runs its functions eagerly (op by op), as the port does.
One exception is stated where it arises: the camera's w = u x v on
arbitrary poses (test_camera_basis_bit_exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_gpu_tpu.models import parser as jparser
from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.scene import Camera as JCamera
from raytracing_gpu_tpu.models.scene import build_scene as jbuild
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import camera as jcam
from raytracing_gpu_tpu.ops import colors as jcolors

from raytracing_gpu_tpu_torch.models import parser as tparser
from raytracing_gpu_tpu_torch.models import procedural as tproc
from raytracing_gpu_tpu_torch.models.scene import (
    build_scene,
    make_camera,
    scene_from_numpy,
)
from raytracing_gpu_tpu_torch.ops import camera as tcam
from raytracing_gpu_tpu_torch.ops import colors as tcolors


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core (several
    processes' spinning thread pools on the same cores slow every one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCENES = {
    "spheres": (jproc.make_sphere_scene, tproc.make_sphere_scene,
                dict(width=16, height=16, n_lat=8, n_lon=12)),
    "grid": (jproc.make_sphere_grid_scene, tproc.make_sphere_grid_scene,
             dict(width=16, height=16, nx=4, ny=4, nz=2, n_lat=16, n_lon=20)),
}

SVATI = """
# comment to end of line: object 99 v 1 2 3
camera 12 8 0.5 1.0 -4.0 1.0 0.1 0.0 0.0 -1.0 0.2 70.0
a_light 0.65 0.65 0.65
d_light 1.0 0.9 0.8 0.5 -1.0 1.0
p_light 0.5 0.5 0.5 1.0 2.0 3.0
object 6
Ns 96.078431
Kd 0.8 0.0 0.0
Ka 0.8 0.0 0.1
Nr 0.5
v 1.0 2.0 0.0
v -1.0 -1.0 0.0
v 1.0 -1.0 0.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -0.5
vn 0.0 0.0 -0.25
Ks 0.1 0.2 0.3
v 2.0 2.0 1.0
v -1.5 -1.0 1.0
v 1.0 -3.0 1.0
vn 0.0 1.0 -1.0
vn 0.0 0.5 -0.5
d 0.7
vn 1.0 0.0 -0.25
object 3
Ni 1.5
v 0.0 0.0 2.0
v 1.0 0.0 2.0
v 0.0 1.0 2.0
vn 0.0 0.0 1.0
vn 0.0 0.0 1.0
vn 0.0 0.0 1.0
"""


def assert_scenes_equal(jscene, tscene):
    """Leaf for leaf, values and dtypes (port dtypes are float32 / int32 /
    bool by construction)."""
    assert (tscene.n_triangles, tscene.n_objects) == (jscene.n_triangles,
                                                       jscene.n_objects)
    jc, tc = jscene.camera, tscene.camera
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for f in ("position", "u", "v", "fov"):
        t = getattr(tc, f)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jc, f), np.float32))
    assert tscene.lights.kind == tuple(jscene.lights.kind)
    groups = (("lights", ("rgb", "v")),
              ("geometry", ("vertices", "normals", "tri_obj", "valid")),
              ("materials", ("ka", "kd", "ks", "ns", "ni", "nr", "d")))
    for group, fields in groups:
        for f in fields:
            a = np.asarray(getattr(getattr(jscene, group), f))
            t = getattr(getattr(tscene, group), f)
            assert t.dtype in (torch.float32, torch.int32, torch.bool), (group, f)
            assert t.numpy().dtype == a.dtype, (group, f, a.dtype)
            np.testing.assert_array_equal(t.numpy(), a, err_msg=f"{group}.{f}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_procedural_scenes_match_jax(name):
    jmake, tmake, kw = SCENES[name]
    assert_scenes_equal(jmake(**kw), tmake(**kw))


def test_procedural_full_size_triangle_counts():
    """The chip-smoke scene sizes: 4,962 triangles (spheres at 32x40) and
    96,000 (the default grid)."""
    assert tproc.make_sphere_scene(8, 8, n_lat=32, n_lon=40).n_triangles == 4962
    assert tproc.make_sphere_grid_scene(8, 8).n_triangles == 96000


def test_parser_matches_jax():
    assert_scenes_equal(jparser.parse_scene_text(SVATI, pad_triangles=8),
                        tparser.parse_scene_text(SVATI, pad_triangles=8))


def test_parser_errors_match_jax():
    for bad in ("camera 1 2 3", "bogus 1", SVATI.replace("Ni 1.5", "Nx 1.5"),
                "a_light 1 1 1"):
        with pytest.raises(jparser.SvatiParseError):
            jparser.parse_scene_text(bad)
        with pytest.raises(tparser.SvatiParseError):
            tparser.parse_scene_text(bad)


def test_build_scene_without_lights_or_objects_matches_jax():
    pos, u, v = (np.array(x, np.float32) for x in ([0, 1, 2], [1, 0, 0], [0, 1, 0]))
    jscene = jbuild(JCamera(4, 4, pos, u, v, np.float32(60.0)), [], [],
                    pad_triangles=16, pad_objects=2)
    tscene = build_scene(make_camera(4, 4, pos, u, v, 60.0), [], [],
                         pad_triangles=16, pad_objects=2)
    assert_scenes_equal(jscene, tscene)


def test_scene_from_numpy_round_trip():
    jscene = jproc.make_sphere_scene(width=16, height=16, n_lat=8, n_lon=12)
    port = scene_from_numpy(jscene)
    assert_scenes_equal(jscene, port)
    # from device arrays too, and through .to()
    assert_scenes_equal(jscene, scene_from_numpy(scene_to_device(jscene)).to("cpu"))
    # a port scene reads back as itself
    assert_scenes_equal(jscene, scene_from_numpy(port))


def _jax_camera(tc):
    return JCamera(tc.width, tc.height, jnp.asarray(tc.position.numpy()),
                   jnp.asarray(tc.u.numpy()), jnp.asarray(tc.v.numpy()),
                   jnp.asarray(tc.fov.numpy()))


def _cameras():
    rng = np.random.RandomState(0)
    cams = [tproc.make_sphere_scene(16, 12).camera,
            tproc.make_sphere_grid_scene(20, 16).camera]
    for _ in range(6):  # random poses, fields of view and odd sizes
        cams.append(make_camera(int(rng.randint(3, 40)), int(rng.randint(3, 40)),
                                rng.randn(3) * 5, rng.randn(3), rng.randn(3),
                                rng.uniform(20.0, 150.0)))
    return cams


def test_camera_basis_bit_exact():
    """u, v and the image-plane centre C equal the JAX package's bit for bit
    on the procedural cameras. On arbitrary poses u and v stay exact but
    XLA:CPU compiles jnp.cross's `a*b - c*d` into an FMA, which the port (like
    the reference's vector3_cross in C) does not: C then agrees to 1e-6
    relative."""
    for i, tc in enumerate(_cameras()):
        ju, jv, jC = jcam.camera_basis(_jax_camera(tc))
        tu, tv, tC = tcam.camera_basis(tc)
        assert tu.dtype == tv.dtype == tC.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        if i < 2:
            np.testing.assert_array_equal(tC.numpy(), np.asarray(jC))
        else:
            np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(np.asarray(jC)).max()))


def test_subpixel_coords_and_rays_bit_exact():
    for tc in _cameras():
        w, h = tc.width, tc.height
        ids = np.arange(w * h * 4)
        jc = jcam.cpu_subpixel_coords_traced(w, h, jnp.asarray(ids))
        tcoords = tcam.cpu_subpixel_coords_traced(w, h, torch.from_numpy(ids))
        np.testing.assert_array_equal(tcoords.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(
            tcoords.numpy().reshape(h, w, 4, 2), jcam.cpu_subpixel_coords(w, h))
        # the same basis into both make_rays (see test_camera_basis_bit_exact)
        basis = tcam.camera_basis(tc)
        jo, jd = jcam.make_rays(*(jnp.asarray(b.numpy()) for b in basis),
                                jnp.asarray(tc.position.numpy()), jc)
        to, td = tcam.make_rays(*basis, tc.position, tcoords)
        assert to.dtype == td.dtype == torch.float32
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("quantize", ["match", "smooth"])
def test_color_ops_bit_exact(quantize):
    rng = np.random.RandomState(1)
    # unit-domain inputs for init, [0,255]-domain for the rest, both
    # straddling the clamp limits
    unit = (rng.rand(4096, 3) * 1.4 - 0.2).astype(np.float32)
    a, b = ((rng.rand(4096, 3) * 300 - 20).astype(np.float32) for _ in range(2))
    coef = (rng.rand(4096, 1) * 1.2).astype(np.float32)
    jops, tops = jcolors.ColorOps(quantize), tcolors.ColorOps(quantize)
    cases = [("init", (unit,)), ("add", (np.abs(a), np.abs(b))),
             ("mul", (np.abs(a), coef)), ("mul", (np.abs(a), 0.25)),
             ("mul2", (np.abs(a), np.abs(b))), ("finalize", (a,))]
    for op, args in cases:
        want = np.asarray(getattr(jops, op)(*(jnp.asarray(x) for x in args)))
        got = getattr(tops, op)(*(torch.as_tensor(x) for x in args))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{quantize} {op}")
    np.testing.assert_array_equal(tops.zeros((5,)).numpy(), np.asarray(jops.zeros((5,))))


def test_scene_to_moves_tensors_only():
    s = tproc.make_sphere_scene(8, 8, n_lat=6, n_lon=9)
    moved = s.to("cpu")
    assert moved is not s and moved.geometry is not s.geometry
    assert moved.camera.width == 8 and moved.lights.kind == s.lights.kind
    assert moved.n_triangles == s.n_triangles and moved.device == torch.device("cpu")
    for part in (s.camera, s.lights, s.geometry, s.materials):
        copy = part.to("cpu")
        assert type(copy) is type(part)
        for f in dataclasses.fields(part):
            a, b = getattr(part, f.name), getattr(copy, f.name)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
