"""Multi-process rendering: one process per device, on one host or several.

The JAX package forms its process group with `jax.distributed.initialize`
and runs one `shard_map` program over a global mesh. Here the group is a
`torch.distributed` process group, usually started by `torchrun`, and every
process runs the same Python:

    from raytracing_gpu_tpu_torch.parallel import multihost
    multihost.initialize()                   # joins torchrun's group
    mesh = multihost.global_mesh(tiles=-1)   # every rank on the tiles axis
    img = multihost.render_scene_multihost(scene, cfg, mesh)  # whole image,
                                             # the same on every process
"""

from __future__ import annotations

import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from raytracing_gpu_tpu_torch.config import RenderConfig
from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.parallel.mesh import make_mesh
from raytracing_gpu_tpu_torch.parallel.render import render_scene_sharded


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               timeout: datetime.timedelta | None = None) -> None:
    """Form the process group (`dist.init_process_group`).

    `coordinator_address` ("host:port", rank 0's) with `num_processes` and
    `process_id` forms it over `tcp://`; otherwise the `env://` variables
    that `torchrun` sets (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`,
    `MASTER_PORT`) are read. The backend defaults to NCCL where CUDA is
    available and gloo elsewhere; with NCCL each process takes the card
    `LOCAL_RANK` names. No-op when a group exists. Only when nothing at all
    was asked for (no argument, no `WORLD_SIZE`) does it warn and stay
    single-process: a request it cannot meet raises."""
    if dist.is_initialized():
        return
    asked = (coordinator_address is not None or process_id is not None
             or num_processes not in (None, 1))
    if not asked and "WORLD_SIZE" not in os.environ:
        warnings.warn("multihost.initialize: no process group requested "
                      "(no coordinator, no WORLD_SIZE); continuing single-process")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if timeout is None else {"timeout": timeout}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        address = coordinator_address.removeprefix("tcp://")
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                world_size=num_processes, rank=process_id, **kw)
    elif "WORLD_SIZE" in os.environ:
        if num_processes is not None and num_processes != int(os.environ["WORLD_SIZE"]):
            raise ValueError(f"num_processes={num_processes} but WORLD_SIZE="
                             f"{os.environ['WORLD_SIZE']}")
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        raise ValueError(f"num_processes={num_processes} needs a coordinator "
                         "address or the WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT "
                         "variables (torchrun sets them)")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def global_mesh(tiles: int = -1, scene_shards: int = 1):
    """A (tiles, scene) mesh over every process of the group; tiles=-1 uses
    all of them divided by scene_shards. Ranks are process-major, so a
    contiguous block of tiles lands on one host."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if tiles == -1:
        if n % scene_shards:
            raise ValueError(f"{n} devices not divisible by scene={scene_shards}")
        tiles = n // scene_shards
    need = tiles * scene_shards
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    return make_mesh(tiles, scene_shards)


def render_scene_multihost(scene: Scene, cfg: RenderConfig, mesh,
                           device="cuda") -> np.ndarray:
    """Render over a mesh that may span hosts; every process returns the
    whole image (the tiles' colors are gathered over the tiles group, the
    only traffic of the forward pass besides the scene group's combines)."""
    return render_scene_sharded(scene, cfg, mesh, device=device)
