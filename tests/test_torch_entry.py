"""The port's file entry points against the JAX package's: `render(input,
output, cfg)` and the command line's `--unroll` / `--profile`, on `.svati`
text the tests write, on the CPU."""

import importlib
import json
import os

import pytest
import torch

import raytracing_gpu_tpu as jpkg
from raytracing_gpu_tpu.__main__ import build_parser as jbuild_parser

import raytracing_gpu_tpu_torch as pkg
from raytracing_gpu_tpu_torch.__main__ import main as cli_main
from raytracing_gpu_tpu_torch.render import render
from raytracing_gpu_tpu_torch.utils.image import read_ppm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny scenes: one intra-op thread is as fast and keeps its pace beside
    other test workers (see tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a lit triangle in front of a mirror-free ground quad, three light kinds
SCENE_SVATI = """camera 8 6 0.0 1.0 -5.0 -1.0 0.0 0.0 0.0 1.0 0.0 70
a_light 0.2 0.2 0.2
d_light 0.6 0.6 0.6 0.3 -1.0 0.5
p_light 0.5 0.4 0.3 -2.0 3.0 -2.0
object 3
Kd 0.8 0.2 0.1
Ka 0.5 0.5 0.5
Ks 0.3 0.3 0.3
Ns 16
v 1.0 2.0 0.0
v -1.0 0.2 0.0
v 1.0 0.2 0.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
object 6
Kd 0.4 0.5 0.4
Ka 0.2 0.2 0.2
v -6 0 -6
v -6 0 6
v 6 0 6
v -6 0 -6
v 6 0 6
v 6 0 -6
vn 0 1 0
vn 0 1 0
vn 0 1 0
vn 0 1 0
vn 0 1 0
vn 0 1 0
"""


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("entry") / "scene.svati"
    path.write_text(SCENE_SVATI)
    return str(path)


def _jax_render(monkeypatch, scene_path, out):
    """The JAX package's render() with its native library off: its Python
    parser and writers are the reference, and its library is built only by
    its own tests."""
    with monkeypatch.context() as m:
        m.setenv("RGT_NATIVE", "0")
        jpkg.render(scene_path, out, jpkg.RenderConfig())
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_render_file_entry_writes_the_jax_bytes(scene_path, tmp_path, monkeypatch, ext):
    out = str(tmp_path / f"port.{ext}")
    pkg.render(scene_path, out, pkg.RenderConfig(), device="cpu")
    want = _jax_render(monkeypatch, scene_path, str(tmp_path / f"jax.{ext}"))
    with open(out, "rb") as f:
        assert f.read() == want
    if ext == "ppm":
        img = read_ppm(out)
        assert img.shape == (6, 8, 3) and img.max() > 0


def test_render_exported_and_defaults_to_cuda(scene_path, tmp_path):
    assert "render" in pkg.__all__ and pkg.render is render
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pkg.render(scene_path, str(tmp_path / "out.ppm"))
    assert not (tmp_path / "out.ppm").exists()


def test_cli_unroll_and_profile(scene_path, tmp_path, capsys):
    plain, traced = str(tmp_path / "plain.png"), str(tmp_path / "traced.png")
    trace_dir = tmp_path / "trace"
    assert cli_main([scene_path, plain, "--device", "cpu"]) == 0
    assert cli_main([scene_path, traced, "--device", "cpu", "--unroll", "static",
                     "--profile", str(trace_dir), "--time"]) == 0
    assert "8x6 in" in capsys.readouterr().err
    with open(plain, "rb") as a, open(traced, "rb") as b:
        assert a.read() == b.read()
    # torch.profiler's trace and the program recorder's, beside it
    files = sorted(os.listdir(trace_dir))
    assert [f.split(".")[0] for f in files] == ["program", "trace"]
    assert all(f.endswith(".json") and str(os.getpid()) in f for f in files)
    with open(trace_dir / files[1]) as f:
        assert json.load(f)["traceEvents"]
    with open(trace_dir / files[0]) as f:
        program = json.load(f)
    names = {e["name"] for e in program["traceEvents"] if e.get("cat") == "device"}
    assert {"collide", "cull", "sweep", "shade", "shadow", "update"} <= names
    assert program["otherData"]["dropped"] == 0


@pytest.mark.parametrize("value", ["auto", "while", "static"])
def test_cli_unroll_reaches_the_config(scene_path, tmp_path, monkeypatch, value):
    seen = []

    def fake_render(scene, cfg, device):
        seen.append(cfg.unroll)
        return torch.zeros((6, 8, 3)).numpy()

    # the module, not the package's `render` function of the same name
    monkeypatch.setattr(importlib.import_module("raytracing_gpu_tpu_torch.render"),
                        "render_scene", fake_render)
    assert cli_main([scene_path, str(tmp_path / "o.ppm"), "--device", "cpu",
                     "--unroll", value]) == 0
    assert seen == [value]


def test_cli_rejects_unroll_scan_as_jax_does(scene_path, tmp_path):
    argv = [scene_path, str(tmp_path / "o.ppm"), "--unroll", "scan"]
    with pytest.raises(SystemExit) as want:
        jbuild_parser().parse_args(argv)
    with pytest.raises(SystemExit) as got:
        cli_main(argv + ["--device", "cpu"])
    assert got.value.code == want.value.code == 2
    assert not (tmp_path / "o.ppm").exists()
