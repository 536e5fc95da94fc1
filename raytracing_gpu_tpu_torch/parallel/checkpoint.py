"""Checkpoint and resume of the inverse-rendering training state.

The JAX package's `parallel/checkpoint.py` over `torch.save`: one file
`step_%08d` per step under a directory, holding the 13 parameter tensors,
the optimizer's `state_dict` and the step, all on the host. It is read back
with `torch.load(weights_only=True)`, so a checkpoint holds plain tensors
and Python scalars only.
"""

from __future__ import annotations

import os

import torch

from raytracing_gpu_tpu_torch.parallel.train import TrainState


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save_train_state(directory: str, state: TrainState) -> str:
    """Write `state` under `directory` as `step_%08d`; returns the path.
    Saving a step again overwrites it (written beside it, then renamed)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{int(state.step):08d}")
    blob = {"params": _to_host(state.params),
            "opt_state": _to_host(state.opt_state.state_dict()),
            "step": int(state.step)}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
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
    with torch.no_grad():
        for k, p in like.params.items():
            p.copy_(blob["params"][k])
    like.opt_state.load_state_dict(blob["opt_state"])
    like.step = blob["step"]
    return like


def resume_or_init(directory: str, init_state: TrainState) -> tuple[TrainState, bool]:
    """(state, resumed): the latest checkpoint loaded into `init_state`, or
    `init_state` as it is."""
    path = latest_checkpoint(directory)
    if path is None:
        return init_state, False
    return restore_train_state(path, like=init_state), True
