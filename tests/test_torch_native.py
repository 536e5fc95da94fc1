"""The port's native library (`raytracing_gpu_tpu_torch/native/`): the C++
`.svati` tokenizer and the PPM / PNG writers, each held to the port's Python
twin and to the JAX package's Python parser and writers, on text the tests
write. The JAX package's own native library is not built here (its tests
build it next to its sources)."""

import os
import shutil

import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models import procedural as jproc
from raytracing_gpu_tpu.models.parser import SvatiParseError as JSvatiParseError
from raytracing_gpu_tpu.models.parser import parse_scene_text as jparse_text
from raytracing_gpu_tpu.utils.image import ppm_bytes as jppm_bytes
from raytracing_gpu_tpu.utils.image import read_ppm as jread_ppm

from raytracing_gpu_tpu_torch.models.parser import (
    SvatiParseError,
    parse_scene,
    parse_scene_text,
)
from raytracing_gpu_tpu_torch.models.scene import scene_from_numpy
from raytracing_gpu_tpu_torch.native import build
from raytracing_gpu_tpu_torch.native import svati
from raytracing_gpu_tpu_torch.utils import image

from chip_smoke import require_same_scene, svati_text

# three objects, every light kind, materials before, between and after the
# vertices, comments, an object whose vertex count is no multiple of 3
MULTI_SVATI = """# a comment line
camera 12 10 0.5 2.0 -7.25 -1.0 0.0 0.0 0.0 1.0 0.0 75.5
a_light 0.15 0.15 0.18
d_light 0.7 0.65 0.6 0.3 -1.0 0.5
p_light 0.9 0.3 0.2 -3.0 4.0 -2.0   # trailing comment
object 6
Kd 0.8 0.2 0.1
Ka 0.1 0.1 0.1
v 1.0 2.0 0.0
v -1.0 -1.0 0.0
v 1.0 -1.0 0.0
Ns 32
v 0.1 0.2 0.3
v 0.4 0.5 0.6
v 0.7 0.8 0.9000001
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 1.0 0.0
vn 0.0 1.0 0.0
Nr 0.45
vn 1e-3 1.0 -2.5e-1
object 3
Ks 0.5 0.5 0.5
Ni 1.5
d 0.75
v -5 0 -5
v -5 0 5
v 5 0 5
vn 0 1 0
vn 0 1 0
vn 0 1 0
object 4
Kd 0.3 0.3 0.9
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
"""


@pytest.fixture(scope="module")
def lib():
    """The port's native library, built once per test process; skips
    without a C++ compiler."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    return svati.library("force")


def _write(tmp_path, text, name="scene.svati"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same_as_jax(port_scene, jscene):
    """Every leaf of the port's scene equal to the JAX package's host scene."""
    require_same_scene(port_scene, scene_from_numpy(jscene), "against the JAX parser")


def test_library_lands_under_the_build_dir(lib):
    path = build.library_path()
    root = os.path.join(os.path.dirname(svati.__file__), os.pardir, "_build")
    assert os.path.commonpath([path, os.path.realpath(root)]) == os.path.realpath(root)
    assert path.parent.name == f"native-{build.source_hash()}"
    assert (path.parent / "build.log").exists()


@pytest.mark.parametrize("pads", [(128, 8), (4, 2)])
def test_native_parse_equals_python_and_jax(lib, tmp_path, pads):
    path = _write(tmp_path, MULTI_SVATI)
    nat = svati.parse_scene_native(path, *pads)
    py = parse_scene_text(MULTI_SVATI, *pads)
    require_same_scene(nat, py, "native against Python")
    assert nat.camera.width == 12 and nat.camera.height == 10
    assert nat.lights.kind == (0, 1, 2) and nat.n_objects == 3
    # 6 vertices: 2 triangles; 3: 1; 4: 1 (the fourth vertex is dropped)
    assert nat.n_triangles == 4
    _same_as_jax(nat, jparse_text(MULTI_SVATI, *pads))


def test_sphere_scene_round_trips_through_svati(lib, tmp_path):
    """The chip smoke's `.svati` writer, read back by both parsers, gives the
    procedural scene leaf for leaf (and the JAX parser the JAX scene)."""
    from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene

    scene = make_sphere_scene(16, 12, n_lat=8, n_lon=12)
    text = svati_text(scene)
    path = _write(tmp_path, text)
    nat = parse_scene(path, native="force")
    require_same_scene(nat, scene, "native parse against the procedural scene")
    require_same_scene(parse_scene(path, native="never"), scene, "Python parse")
    jscene = jproc.make_sphere_scene(16, 12, n_lat=8, n_lon=12)
    _same_as_jax(nat, jparse_text(text))
    _same_as_jax(nat, jscene)


@pytest.mark.parametrize("text", [
    "camera 4 4 0 0 0 1 0 0 0 1 0 90\nbogus_keyword 1 2 3\n",
    "camera 4 4 0 0 0 1 0 0 0 1 0 90\nobject 3\nv 0 0 0\nfoo 1\n",
    "camera 4 4 0 0 0 1 0 0\n",
    "camera 4 4 0 0 0 1 0 0 0 1 0 90\nobject",
    "a_light 1 1 1\n",
], ids=["keyword", "object-keyword", "eof-numbers", "eof-object", "no-camera"])
def test_parse_errors_match_jax(lib, tmp_path, text):
    path = _write(tmp_path, text)
    with pytest.raises(JSvatiParseError) as want:
        jparse_text(text)
    for native in ("force", "never"):
        with pytest.raises(SvatiParseError) as got:
            parse_scene(path, native=native)
        assert str(got.value) == str(want.value), native


def test_native_choice(lib, tmp_path, monkeypatch):
    path = _write(tmp_path, MULTI_SVATI)
    auto = parse_scene(path, native="auto")
    require_same_scene(auto, parse_scene(path, native="never"), "auto against never")
    with pytest.raises(ValueError, match="native must be one of"):
        parse_scene(path, native="sometimes")

    def boom():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(svati, "_load", boom)
    parse_scene(path, native="never")
    image.write_ppm(str(tmp_path / "a.ppm"), np.zeros((2, 2, 3)), native="never")
    monkeypatch.setenv("RGT_NATIVE", "0")
    assert not svati.available()
    with pytest.raises(RuntimeError, match="RGT_NATIVE=0"):
        parse_scene(path, native="force")
    require_same_scene(parse_scene(path, native="auto"), auto, "auto under RGT_NATIVE=0")


def _images():
    rng = np.random.RandomState(0)
    return [
        (rng.rand(9, 7, 3) * 255.9).astype(np.float32),  # truncated floats
        rng.randint(0, 256, (5, 6, 3)).astype(np.uint8),
        np.array([[[0.0, -0.5, 254.999], [255.0, 99.99, 10.0]]], np.float32),
    ]


def test_ppm_writer_byte_exact(lib, tmp_path):
    for i, img in enumerate(_images()):
        nat, py = tmp_path / f"n{i}.ppm", tmp_path / f"p{i}.ppm"
        image.write_ppm(str(nat), img, native="force")
        image.write_ppm(str(py), img, native="never")
        data = nat.read_bytes()
        assert data == py.read_bytes() == image.ppm_bytes(img) == jppm_bytes(img), i
        np.testing.assert_array_equal(image.read_ppm(str(nat)), jread_ppm(str(nat)))
        np.testing.assert_array_equal(image.read_ppm(str(nat)),
                                      np.asarray(img).astype(np.int32).astype(np.uint8))


def test_ppm_outside_the_native_range_takes_python(lib, tmp_path):
    """Values the native writer cannot format (four digits, or not exact in
    float32) are written by the Python path under "auto", refused under
    "force"."""
    for img in (np.full((1, 2, 3), 1234, np.int16), np.full((1, 2, 3), 7.0, np.float64)):
        path = tmp_path / "wide.ppm"
        image.write_ppm(str(path), img)
        assert path.read_bytes() == jppm_bytes(img)
        with pytest.raises(ValueError, match="native PPM writer"):
            image.write_ppm(str(path), img, native="force")


def test_png_writer_byte_identical(lib, tmp_path):
    rng = np.random.RandomState(1)
    for i, img in enumerate([rng.randint(0, 256, (13, 11, 3)).astype(np.uint8),
                             rng.randint(0, 256, (4, 5, 4)).astype(np.uint8),
                             rng.rand(6, 3, 3).astype(np.float32) * 300.0]):
        nat, py = tmp_path / f"n{i}.png", tmp_path / f"p{i}.png"
        image.write_png(str(nat), img, native="force")
        image.write_png(str(py), img, native="never")
        assert nat.read_bytes() == py.read_bytes(), i
        assert nat.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_parse_in_the_port_takes_no_jax_leaf(lib, tmp_path):
    """The native parse gives CPU tensors of the port's dtypes."""
    scene = parse_scene(_write(tmp_path, MULTI_SVATI), native="force")
    assert scene.device == torch.device("cpu")
    assert scene.geometry.vertices.dtype == torch.float32
    assert scene.geometry.tri_obj.dtype == torch.int32
    assert scene.geometry.valid.dtype == torch.bool
    assert scene.lights.count == 3
    assert scene.geometry.padded_count == 128 and scene.materials.padded_count == 8
