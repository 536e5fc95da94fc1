"""Checkpoint and resume of the inverse-rendering training state.

The JAX package's `parallel/checkpoint.py` over `torch.save`: one file
`step_%08d` per step under a directory, holding the 13 parameter tensors,
the optimizer's `state_dict` and the step, all on the host. It is read back
with `torch.load(weights_only=True)`, so a checkpoint holds plain tensors
and Python scalars only.

A state sharded over a mesh (`TrainState.mesh`) is saved whole, as the JAX
package saves its global arrays: the scene-sharded groups and their
optimizer slots are gathered over the scene group and rank 0 writes the
file, which is the one-device checkpoint of the same parameters. Restoring
into a sharded state gives each rank its slices again.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from raytracing_gpu_tpu_torch.parallel import collectives
from raytracing_gpu_tpu_torch.parallel.mesh import SCENE
from raytracing_gpu_tpu_torch.parallel.render import shard_rows
from raytracing_gpu_tpu_torch.parallel.train import PARAM_SPECS, TrainState

SHARDED_KEYS = tuple(k for k, axis in PARAM_SPECS.items() if axis == SCENE)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _sharded_slots(state: TrainState):
    """{optimizer index: local shape} of the groups split over the scene
    axis; empty for a state that is not scene-sharded. A slot tensor of that
    shape (Adam's moments) is split like its parameter."""
    mesh = state.mesh
    if mesh is None or collectives.group_size(mesh.scene_group) == 1:
        return {}
    name = {id(p): k for k, p in state.params.items()}
    order = [p for g in state.opt_state.param_groups for p in g["params"]]
    return {i: tuple(p.shape) for i, p in enumerate(order)
            if name[id(p)] in SHARDED_KEYS}


def _map_slots(opt_state: dict, sharded: dict, fn) -> dict:
    """`opt_state` with every slot tensor `v` of a sharded group replaced by
    `fn(v, local shape of its parameter)`."""
    return dict(opt_state, state={
        i: {k: fn(v, sharded[i]) if i in sharded and torch.is_tensor(v) else v
            for k, v in slot.items()}
        for i, slot in opt_state["state"].items()})


def save_train_state(directory: str, state: TrainState) -> str:
    """Write `state` under `directory` as `step_%08d`; returns the path.
    Saving a step again overwrites it (written beside it, then renamed). A
    sharded state is gathered first and written by rank 0; every rank of
    the mesh calls this and returns once the file is there."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{int(state.step):08d}")
    params = state.params
    opt_state = state.opt_state.state_dict()
    sharded = _sharded_slots(state)
    if sharded:
        group = state.mesh.scene_group
        params = {k: collectives.all_gather(p.detach(), group)
                  if k in SHARDED_KEYS else p for k, p in params.items()}
        opt_state = _map_slots(opt_state, sharded, lambda v, shape: (
            collectives.all_gather(v, group) if tuple(v.shape) == shape else v))
    if state.mesh is None or not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(directory, exist_ok=True)
        blob = {"params": _to_host(params), "opt_state": _to_host(opt_state),
                "step": int(state.step)}
        tmp = path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
    if state.mesh is not None:
        # rank 0 (tile 0, shard 0) is in the tiles group of shard 0 and the
        # scene group of tile 0: after both barriers every rank is past it
        collectives.barrier(state.mesh.tiles_group)
        collectives.barrier(state.mesh.scene_group)
    return path


def latest_checkpoint(directory: str) -> str | None:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_train_state(path: str, like: TrainState | None = None) -> TrainState:
    """Restore a TrainState. With `like` (a state of the target structure,
    for example freshly initialized) the saved values are loaded into its
    tensors and its optimizer, on their device, and `like` is returned at
    the saved step. Without it the result holds host tensors and, as
    `opt_state`, the optimizer's bare `state_dict`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if like is None:
        return TrainState(params=blob["params"], opt_state=blob["opt_state"],
                          step=blob["step"])
    opt_state, sharded = blob["opt_state"], _sharded_slots(like)
    with torch.no_grad():
        for k, p in like.params.items():
            saved = blob["params"][k]
            p.copy_(shard_rows(saved, like.mesh) if k in SHARDED_KEYS
                    and like.mesh is not None else saved)
    if sharded:
        n_scene = like.mesh.shape[SCENE]
        opt_state = _map_slots(opt_state, sharded, lambda v, shape: (
            shard_rows(v, like.mesh) if tuple(v.shape) == (shape[0] * n_scene,)
            + shape[1:] else v))
    like.opt_state.load_state_dict(opt_state)
    like.step = blob["step"]
    return like


def resume_or_init(directory: str, init_state: TrainState) -> tuple[TrainState, bool]:
    """(state, resumed): the latest checkpoint loaded into `init_state`, or
    `init_state` as it is."""
    path = latest_checkpoint(directory)
    if path is None:
        return init_state, False
    return restore_train_state(path, like=init_state), True
