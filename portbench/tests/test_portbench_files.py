"""The benchmark's files: every cell resolves through its files (its
configuration and that configuration's shapes, its traffic mix and that
mix's kind, its limits, its metrics' readers), the contract's limits on
names, units and bounds hold, and each configuration's scene has its
census."""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, scenes  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert callable(harness.plugin("traffic", c.traffic["kind"]).run)
    for o in c.config["objects"]:
        assert callable(harness.plugin("scenes", o["shape"]).build)
    assert c.config["name"] == [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    assert set(c.check["limits"]) and all(v >= 0 for v in c.check["limits"].values())
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:  # the metric a layer metric moves is reported here
        assert m["moves"] in reported


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_an_unknown_file_is_named():
    with pytest.raises(SystemExit, match="traffic/no_such_kind.py"):
        harness.plugin("traffic", "no_such_kind")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_scene_has_its_census(name):
    config = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    s = scenes.build(config, 64, 48, seed=2**31 + 7)
    census = config["census"]
    assert len(s.objects) == census["objects"]
    assert s.n_triangles == census["triangles"]
    assert len(s.light_kind) == census["lights"]
    assert sum(k == scenes.POINT for k in s.light_kind) == census["point_lights"]
    if name == "spheres":
        assert [o.vertices.shape[0] for o in s.objects] == [1600, 1600, 1600, 12]
        assert max(o.nr for o in s.objects) == np.float32(0.85)  # depth cap 29


def test_a_seed_draws_colours_and_nothing_else():
    config = json.loads((ROOT / "portbench" / "configs" / "spheres.json").read_text())
    a, b = scenes.build(config, 32, 32, 1), scenes.build(config, 32, 32, 2**33 + 5)
    va, na, ta, ma = a.soup()
    vb, nb, tb, mb = b.soup()
    assert np.array_equal(va, vb) and np.array_equal(na, nb) and np.array_equal(ta, tb)
    assert np.array_equal(ma[:, 9:], mb[:, 9:])  # ns, nr
    assert np.array_equal(a.light_v, b.light_v) and a.light_kind == b.light_kind
    assert not np.array_equal(ma[:, :9], mb[:, :9])
    assert not np.array_equal(a.light_rgb, b.light_rgb)
    c = scenes.build(config, 32, 32, 1)
    assert np.array_equal(ma, c.soup()[3]) and np.array_equal(a.light_rgb, c.light_rgb)


def test_svati_text_reads_back_through_the_program_parser():
    from raytracing_gpu_tpu_torch import parse_scene_text

    config = json.loads((ROOT / "portbench" / "configs" / "spheres.json").read_text())
    s = scenes.build(config, 40, 24, seed=99)
    scene = parse_scene_text(scenes.svati_text(s))
    verts, norms, tri_obj, mats = s.soup()
    T, O = len(verts), len(s.objects)
    assert np.array_equal(scene.geometry.vertices[:T].numpy(), verts)
    assert np.array_equal(scene.geometry.normals[:T].numpy(), norms)
    assert np.array_equal(scene.geometry.tri_obj[:T].numpy(), tri_obj)
    m = scene.materials
    got = np.concatenate([m.ka.numpy(), m.kd.numpy(), m.ks.numpy(), m.ns.numpy()[:, None],
                          m.nr.numpy()[:, None]], 1)[:O]
    assert np.array_equal(got, mats)
    assert np.array_equal(scene.lights.rgb.numpy(), s.light_rgb)
    assert np.array_equal(scene.lights.v.numpy(), s.light_v)
    assert scene.lights.kind == s.light_kind
    cam = scene.camera
    assert (cam.width, cam.height) == (40, 24) and float(cam.fov) == s.fov
    assert np.array_equal(cam.position.numpy(), s.position)
