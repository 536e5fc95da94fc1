"""Small cells for the CPU tests: a configuration's spheres cut to a few
triangles, the image to a few pixels; the program runs its kernels' plain
versions on the CPU."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(name: str, size: int):
    """The cell `name` with n_lat 4, n_lon 6 spheres (36 triangles each), a
    size x size image and its whole image checked."""
    from portbench import harness

    cell = harness.load_cell(name)
    config = json.loads(json.dumps(cell.config))
    for o in config["objects"]:
        if "n_lat" in o:
            o["n_lat"], o["n_lon"] = 4, 6
    traffic = dict(cell.traffic, width=size, height=size)
    if traffic["kind"] == "train":
        traffic["render"] = dict(traffic["render"], ray_chunk=size * size * 2)
    return dataclasses.replace(cell, config=config, traffic=traffic,
                               check=dict(cell.check, pixels=size * size))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
