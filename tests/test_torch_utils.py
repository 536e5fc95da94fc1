"""The port's host utilities against the JAX package's: `utils.inspect`
(text equal character for character), `utils.profiling` (`Timer`, `trace`,
`annotate`, the busy-share union) and `utils.compare` (`diff_images`, and
tests/test_compare.py's six comparator cases run through both modules)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_gpu_tpu.models.parser import parse_scene_text as jparse_text
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.partition import aabb as jaabb
from raytracing_gpu_tpu.partition import octree as joct
from raytracing_gpu_tpu.utils import compare as jcompare
from raytracing_gpu_tpu.utils import inspect as jinspect
from raytracing_gpu_tpu.utils.profiling import Timer as JTimer

from raytracing_gpu_tpu_torch.models.parser import parse_scene_text
from raytracing_gpu_tpu_torch.partition import aabb as taabb
from raytracing_gpu_tpu_torch.partition import octree as toct
from raytracing_gpu_tpu_torch.utils import compare as tcompare
from raytracing_gpu_tpu_torch.utils import inspect as tinspect
from raytracing_gpu_tpu_torch.utils import profiling

from chip_smoke import svati_text


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small inputs: one intra-op thread keeps the file's pace beside other
    test workers (see tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid_text():
    """The sphere grid's 12 objects as `.svati` text, through the port's
    procedural scene."""
    from raytracing_gpu_tpu_torch.models.procedural import make_sphere_grid_scene

    return svati_text(make_sphere_grid_scene(8, 8, nx=3, ny=2, nz=2, n_lat=4, n_lon=6))


def _jax_structures(jscene):
    """What the JAX package's inspect.main builds (its own code, eagerly)."""
    dev = scene_to_device(jscene)
    g, n_obj = dev.geometry, dev.materials.padded_count
    obj_valid = jax.ops.segment_sum(g.valid.astype(jnp.int32), g.tri_obj,
                                    num_segments=n_obj) > 0
    aabbs = jaabb.compute_object_aabbs(g.vertices, g.tri_obj, g.valid, n_obj)
    box = jaabb.compute_scene_aabb(aabbs, obj_valid)
    return dev, obj_valid, aabbs, box


def _port_structures(scene):
    g, n_obj = scene.geometry, scene.materials.padded_count
    obj_valid = taabb.objects_valid(g.tri_obj, g.valid, n_obj)
    aabbs = taabb.compute_object_aabbs(g.vertices, g.tri_obj, g.valid, n_obj)
    return obj_valid, aabbs, taabb.compute_scene_aabb(aabbs, obj_valid)


def test_describe_text_equals_jax(grid_text):
    jscene, scene = jparse_text(grid_text), parse_scene_text(grid_text)
    assert scene.n_objects == 12
    dev, jvalid, jboxes, jbox = _jax_structures(jscene)
    tvalid, tboxes, tbox = _port_structures(scene)
    want = jinspect.describe_scene(dev)
    assert tinspect.describe_scene(scene) == want
    assert want.count("\n") == 2 + scene.n_objects
    assert tinspect.describe_aabbs(tboxes, tvalid) == jinspect.describe_aabbs(jboxes, jvalid)
    jkeys, jlev, _ = joct.position_keys(jboxes, jbox, jvalid)
    tkeys, tlev, _ = toct.position_keys(tboxes, tbox, tvalid)
    want = jinspect.describe_keys(jkeys, jlev)
    assert tinspect.describe_keys(tkeys, tlev) == want and "key[0] = 0x" in want
    want = jinspect.describe_octree(joct.build_octree(jboxes, jbox, jvalid))
    assert tinspect.describe_octree(toct.build_octree(tboxes, tbox, tvalid)) == want
    assert want.startswith("octree: ") and "box=[" in want


def test_inspect_main_prints_the_jax_lines(grid_text, tmp_path, capsys, monkeypatch):
    path = tmp_path / "grid.svati"
    path.write_text(grid_text)
    flags = ["--aabbs", "--keys", "--octree"]
    assert tinspect.main([str(path), *flags, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert tinspect.main([str(path), "--memory", "--device", "cpu"]) == 0
    with_memory = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("RGT_NATIVE", "0")  # the JAX library is built by its own tests
    assert jinspect.main([str(path), *flags]) == 0
    want = capsys.readouterr().out
    assert got == want and "scene box: " in want and "position keys:" in want
    n_scene = got.split("aabbs:")[0].count("\n")
    assert with_memory == got.splitlines()[:n_scene] + ["cpu: memory stats unavailable"]


def test_inspect_defaults_to_cuda(grid_text, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path = tmp_path / "grid.svati"
    path.write_text(grid_text)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinspect.main([str(path)])
    assert tinspect.describe_device_memory("cpu") == "cpu: memory stats unavailable"


def test_timer_calls_and_report():
    calls = []
    timer = profiling.Timer(warmup=2, repeats=3)
    best = timer.measure("render", lambda x: calls.append(x) or torch.zeros(2), 7)
    assert calls == [7] * 5 and best == timer.times["render"] >= 0.0
    timer.measure("a longer name", lambda: {"out": (torch.ones(1), [1.0])})
    jtimer = JTimer()
    jtimer.times = dict(timer.times)
    assert timer.report() == jtimer.report()
    assert profiling.Timer().report() == JTimer().report() == ""


def test_timer_syncs_only_for_cuda_outputs(monkeypatch):
    @dataclasses.dataclass
    class Out:
        img: torch.Tensor
        extra: tuple

    def no_sync():
        raise AssertionError("synchronised for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    profiling.Timer._sync(Out(torch.zeros(1), ({"a": [torch.ones(2)]},)))
    assert not profiling._has_cuda_tensor([torch.zeros(1), {"k": (1.0, None)}])


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as path:
        with profiling.annotate("rgt_test_span"):
            torch.ones(64).sum()
    assert os.path.dirname(path) == str(tmp_path / "t")
    assert os.listdir(tmp_path / "t") == [os.path.basename(path)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "rgt_test_span" in names


def test_union_of_kernel_intervals():
    assert profiling.union_us([]) == 0.0
    assert profiling.union_us([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 6.5)]) == 5.0
    prof = profiling.CallProfile(wall_ms=10.0, kernels=[], busy_ms=2.5)
    assert prof.busy_share == 0.25


def test_diff_images_fields_equal_jax():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (17, 9, 3)).astype(np.uint8)
    b = a.copy()
    b[3, 4] += 1
    b[5, 5, 2] = 255 - b[5, 5, 2]
    for tol in (0, 1, 5):
        got, want = tcompare.diff_images(a, b, tol), jcompare.diff_images(a, b, tol)
        for name in ("max_abs", "mean_abs", "n_diff", "n_bad", "total", "tol",
                     "frac_diff", "frac_bad"):
            assert getattr(got, name) == getattr(want, name), (tol, name)
    with pytest.raises(ValueError, match="shape mismatch"):
        tcompare.diff_images(a, b[:, :8])
    d = tcompare.assert_images_close(a, a)
    assert d.n_diff == 0 and d == tcompare.diff_images(a, a)


# tests/test_compare.py's six cases, each run through both comparators


def _flat_image(h=540, w=960, value=100):
    return np.full((h, w, 3), value, np.uint8)


def _max_outlier_run_basic(mod):
    m = np.zeros((8, 8), bool)
    assert mod.max_outlier_run(m) == 0
    m[2, 3] = True
    assert mod.max_outlier_run(m) == 1
    m[3, 3] = True
    m[4, 3] = True
    assert mod.max_outlier_run(m) == 3
    m2 = np.zeros((8, 8), bool)
    m2[5, 1:6] = True
    assert mod.max_outlier_run(m2) == 5


def _column_stripe_fails(mod):
    golden = _flat_image()
    ours = golden.copy()
    ours[100:130, 480, :] = 110
    with pytest.raises(AssertionError, match="run="):
        mod.assert_images_close(ours, golden, max_frac_off_edge=4e-4)


def _row_stripe_fails(mod):
    golden = _flat_image()
    ours = golden.copy()
    ours[270, 100:130, :] = 110
    with pytest.raises(AssertionError, match="run="):
        mod.assert_images_close(ours, golden, max_frac_off_edge=4e-4)


def _isolated_flips_pass(mod):
    golden = _flat_image()
    ours = golden.copy()
    rng = np.random.RandomState(0)
    for y in range(0, 90, 3):
        ours[y, 480, :] = 140
    for _ in range(30):
        y, x = rng.randint(0, 540), rng.randint(0, 959)
        if x == 480 or ours[y, x, 0] != 100:
            continue
        ours[y, x, :] = 160
    mod.assert_images_close(ours, golden, max_frac_off_edge=4e-4)


def _short_runs_pass(mod):
    golden = _flat_image()
    ours = golden.copy()
    ours[10:12, 5, :] = 120
    mod.assert_images_close(ours, golden, max_frac_off_edge=4e-4)


def _low_magnitude_runs_pass(mod):
    golden = _flat_image()
    low = golden.copy()
    low[200:212, 300, :] = 104
    mod.assert_images_close(low, golden, max_frac_off_edge=4e-4)
    high = golden.copy()
    high[200:212, 300, :] = 110
    with pytest.raises(AssertionError, match="run="):
        mod.assert_images_close(high, golden, max_frac_off_edge=4e-4)


@pytest.mark.parametrize("module", [jcompare, tcompare], ids=["jax", "port"])
@pytest.mark.parametrize("case", [
    _max_outlier_run_basic, _column_stripe_fails, _row_stripe_fails,
    _isolated_flips_pass, _short_runs_pass, _low_magnitude_runs_pass,
], ids=lambda f: f.__name__.lstrip("_"))
def test_comparator_cases(case, module):
    case(module)
