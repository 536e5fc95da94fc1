"""The port's multi-process layer: `parallel.multihost`, the sharded
checkpoint and the CLI's `--tiles` / `--scene-shards`, in a 2-process gloo
group on the CPU (`tests/_torch_dist_worker.py`, suite "multihost", one
group for the whole file) and in this process.

The group forms through `multihost.initialize(address, 2, rank)`; both
ranks must return the whole image, equal to the single-process render.
"""

import datetime
import os
import re
import socket
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracing_gpu_tpu_torch import RenderConfig, render_scene
from raytracing_gpu_tpu_torch.__main__ import main
from raytracing_gpu_tpu_torch.parallel import extract_params, make_train_step, multihost
from raytracing_gpu_tpu_torch.parallel.checkpoint import (
    restore_train_state,
    save_train_state,
)
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS

import _torch_dist_worker as worker


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These scenes are tiny: one intra-op thread is as fast, and the file
    keeps its pace when other test workers load every core (several
    processes' spinning thread pools on the same cores slow every one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD = 2

# two objects, 8x8: 3 triangles padded to 128, which splits over 2 shards
SCENE_SVATI = """camera 8 8 0.0 0.0 -4.0 1.0 0.0 0.0 0.0 -1.0 0.0 90.0
a_light 0.3 0.3 0.3
d_light 1.0 1.0 1.0 0.5 -1.0 1.0
p_light 0.8 0.8 0.8 -1.0 1.0 -3.0
object 3
Kd 0.8 0.2 0.1
Ka 0.5 0.5 0.5
v 1.0 2.0 0.0
v -1.0 -1.0 0.0
v 1.0 -1.0 0.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
object 6
Kd 0.1 0.7 0.3
Ka 0.2 0.2 0.2
Nr 0.5
v -3.0 -2.0 2.0
v 3.0 -2.0 2.0
v 3.0 3.0 2.0
v -3.0 -2.0 2.0
v 3.0 3.0 2.0
v -3.0 3.0 2.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
vn 0.0 0.0 -1.0
"""


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multihost")
    (out / "scene.svati").write_text(SCENE_SVATI)
    run = worker.Launch("multihost", WORLD, out)
    yield run
    run.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_without_a_request_stays_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.warns(UserWarning, match="continuing single-process"):
        multihost.initialize()
    assert not dist.is_initialized()
    mesh = multihost.global_mesh()
    assert mesh.shape == {"tiles": 1, "scene": 1} and mesh.tile == 0


def test_initialize_raises_on_a_request_it_cannot_meet(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no silent fall-back to one process
        with pytest.raises(ValueError, match="needs a coordinator"):
            multihost.initialize(num_processes=2, process_id=1)
        with pytest.raises(ValueError, match="needs num_processes and process_id"):
            multihost.initialize(f"127.0.0.1:{_free_port()}")
        # rank 1 of a group whose coordinator never comes up
        with pytest.raises((RuntimeError, TimeoutError)):
            multihost.initialize(f"127.0.0.1:{_free_port()}", num_processes=2,
                                 process_id=1, backend="gloo",
                                 timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


def test_global_mesh_errors():
    with pytest.raises(ValueError, match="1 devices not divisible by scene=2"):
        multihost.global_mesh(scene_shards=2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        multihost.global_mesh(tiles=2)


def test_cli_tiles_flags_in_one_process(tmp_path):
    """`--tiles 1 --scene-shards 1` writes what no flag writes; `--tiles 2`
    without a group of 2 raises and names the torchrun command."""
    scene = tmp_path / "scene.svati"
    scene.write_text(SCENE_SVATI)
    plain, flagged = tmp_path / "plain.ppm", tmp_path / "flagged.ppm"
    assert main([str(scene), str(plain), "--device", "cpu"]) == 0
    assert main([str(scene), str(flagged), "--device", "cpu", "--tiles", "1",
                 "--scene-shards", "1"]) == 0
    assert flagged.read_bytes() == plain.read_bytes()
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        main([str(scene), str(tmp_path / "x.ppm"), "--device", "cpu", "--tiles", "2"])


@pytest.mark.parametrize("mesh", ["-1x1", "1x2"])
def test_render_scene_multihost_two_processes(group, mesh):
    ref = render_scene(worker.sphere_scene(), RenderConfig(backend="cuda", **worker.MATCH),
                       device="cpu")
    for r in range(WORLD):
        img = group.load("multihost_render", r)[mesh]
        assert img.shape == ref.shape
        np.testing.assert_array_equal(np.trunc(img), np.trunc(ref), err_msg=f"rank {r}")


def test_sharded_checkpoint_is_the_one_device_checkpoint(group, tmp_path):
    """A state sharded over (1,2) after one Adam step, saved by its two
    ranks, is the one-device checkpoint of the same step (backend "torch",
    whose sharded gradients are bit-equal to one process's); restored into
    a sharded state, each rank gets its own slices back."""
    scene = worker.sphere_scene()
    cfg = RenderConfig(backend="torch", **worker.SMOOTH)
    init, step = make_train_step(None, cfg, scene, device="cpu")
    state, _ = step(init(extract_params(scene)), scene, worker.all_coords(),
                    torch.full((worker.W ** 2, 3), 0.25))
    want = restore_train_state(save_train_state(str(tmp_path), state))
    results = [group.load("checkpoint", r) for r in range(WORLD)]
    got = restore_train_state(str(results[0]["path"]))
    assert got.step == want.step == 1
    for k in PARAM_KEYS:
        assert torch.equal(got.params[k], want.params[k]), k
    assert got.opt_state["param_groups"] == want.opt_state["param_groups"]
    for i, slot in want.opt_state["state"].items():
        for name, v in slot.items():
            assert torch.equal(got.opt_state["state"][i][name], v), (i, name)
    n = scene.geometry.vertices.shape[0] // WORLD
    for r, res in enumerate(results):
        assert bool(res["restored_equal"]), f"rank {r}"
        np.testing.assert_array_equal(res["local_vertices"],
                                      want.params["vertices"][r * n:(r + 1) * n].numpy())


@pytest.mark.parametrize("name", ["tiles2", "shards2", "tiles2_profiled"])
def test_cli_sharded_in_a_group(group, tmp_path, name):
    """`--tiles 2` and `--tiles 1 --scene-shards 2` in the 2-process group:
    rank 0 writes the file that one process writes."""
    group.wait()
    scene = tmp_path / "scene.svati"
    scene.write_text(SCENE_SVATI)
    plain = tmp_path / "plain.ppm"
    assert main([str(scene), str(plain), "--device", "cpu"]) == 0
    with open(os.path.join(group.out, f"{name}.ppm"), "rb") as f:
        assert f.read() == plain.read_bytes()


def test_cli_profile_writes_one_trace_per_rank(group):
    """`--tiles 2 --profile DIR`: each rank's traces land in DIR under its
    own name, torch.profiler's (`trace.*`) and the program recorder's
    (`program.*`)."""
    group.wait()
    files = sorted(os.listdir(os.path.join(group.out, "traces")))
    assert len(files) == 4 and all(f.endswith(".json") for f in files)
    for kind in ("program", "trace"):
        ranks = {re.search(r"\.rank(\d+)\.", f).group(1) for f in files
                 if f.startswith(kind + ".")}
        assert ranks == {"0", "1"}, files
