"""A training step captured once and replayed: the port's counterpart of the
JAX package's `jax.jit(step_fn)` (`parallel/train.py`).

The JAX package jits its whole training step (the forward pass,
`value_and_grad` and the optax update) and then only dispatches it. On the
card a `StepPlan` does the same with one CUDA graph, captured over static
buffers. The graph holds one whole step, as `parallel.train.make_train_step`
builds it:

1. the parameters put into the scene (`insert_params`);
2. the kernel pack rebuilt from the current vertices (`pack_geometry`);
3. the camera basis and rays, on the device
   (`ops.camera.camera_basis_on_device`);
4. for each chunk of `cfg.ray_chunk` rays, the trace at a fixed depth
   (every bounce step, as the JAX package's differentiable strategy runs
   them: a step whose rays are all dead adds exact zeros), the chunk's loss
   and its backward pass (with `loss_blur`, the whole image's blurred loss
   and one backward pass);
5. the optimizer's step.

The graph reads and updates the `TrainState`'s own tensors in place:
parameters, gradients and optimizer state. Each call copies its inputs
(coords, target and the scene's tensors) into the static buffers, replays
the graph and returns a copy of the loss.

A call whose state differs from the one the graph was captured on (other
parameter or optimizer-state tensors, as a fresh `init_state` or
`restore_train_state` gives, or other optimizer settings) or whose inputs
have another structure captures again, as JAX traces again for a new
input. The first call on a state is a real step, run eagerly on a side
stream with any host sync raising; it also creates the optimizer's state.
The capture follows it, so after N calls the state has taken N steps.

On the CPU nothing is captured: every call runs the same step code over
the same buffers, so the CPU tests run it.

A capture that fails raises; nothing falls back to the eager step. An
optimizer that has a `capturable` option must have it on
(`require_capturable`): a non-capturable `torch.optim.Adam` reads its step
count on the host. The warm-up, the capture and the launch counts of a
replay are every plan's (`utils/capture.py`).
"""

from __future__ import annotations

import time

import torch

from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import capture
from raytracing_gpu_tpu_torch.utils.profiling import annotate


def step_graph_blocker(cfg, mesh=None) -> str | None:
    """Why a training step of this configuration stays eager, or None."""
    if mesh is not None:
        return ("a mesh: the step's collectives run over gloo, which a CUDA "
                "graph cannot capture")
    if cfg.backend == "torch" and cfg.partitioning != "none":
        return ("backend 'torch' with partitioning: the object-level boxes "
                "(`with_accel`) are rebuilt on the host in every step")
    return None


def uses_step_graph(cfg, device, mesh=None) -> bool:
    """True where `make_train_step` replays a captured step: on a CUDA
    device, unless `step_graph_blocker` names a reason to stay eager."""
    return (torch.device(device).type == "cuda"
            and step_graph_blocker(cfg, mesh) is None)


def require_capturable(optimizer) -> None:
    """Raise unless `optimizer` can step inside a CUDA graph: an optimizer
    that has a `capturable` option (Adam, AdamW, ...) must have it on in
    every parameter group."""
    if "capturable" not in optimizer.defaults:
        return
    for group in optimizer.param_groups:
        if not group.get("capturable", False):
            raise ValueError(
                f"a captured training step needs an optimizer that reads nothing "
                f"back to the host: build {type(optimizer).__name__} with "
                f"capturable=True (e.g. torch.optim.Adam(params, lr=..., "
                f"capturable=True)), or pass plan=False to make_train_step for "
                f"an eager step")


def _state_key(state, scene, coords, target):
    """(plain values, objects) that a captured step depends on: the state's
    and optimizer's tensors (held, compared by identity) with their storage
    addresses, the optimizer's settings, and the inputs' structure."""
    opt = state.opt_state
    values, objects = [capture.structure(scene)], [state, opt]
    for t in (coords, target):
        values.append((tuple(t.shape), t.dtype, t.device))
    for k, p in state.params.items():
        values.append((k, p.data_ptr(), p.requires_grad))
        objects.append(p)
    for group in opt.param_groups:
        values.append(tuple((k, v) for k, v in group.items()
                            if k != "params" and not torch.is_tensor(v)))
        objects += [v for k, v in group.items() if torch.is_tensor(v)]
        objects += group["params"]
    for slot in opt.state.values():
        for name, v in slot.items():
            values.append((name, v.data_ptr() if torch.is_tensor(v) else None))
            if torch.is_tensor(v):
                objects.append(v)
    return tuple(values), objects


def _same_key(a, b) -> bool:
    return (a is not None and b is not None and a[0] == b[0]
            and len(a[1]) == len(b[1]) and all(x is y for x, y in zip(a[1], b[1])))


class StepPlan:
    """One training step as a CUDA graph and its replays (see the module
    docstring). `loss_and_grads(params, scene, coords, target)` runs the
    forward and backward passes of one step over the buffers (leaving the
    gradients in the free groups' `.grad`) and returns the loss as a 0-d
    tensor; the plan zeroes the gradients before it and steps the
    optimizer after it. Captured on `device` when it is a card, run
    uncaptured on the CPU.

    After each `step()`: `last_call` ("eager" on the CPU, "captured" for a
    warm-up step followed by a capture, "replay"), `captures`, `replays`;
    after a capture, `capture_ms` (warm-up step and capture; `warmup_ms`
    the warm-up step alone), `held_bytes`
    (memory the card reserved over them: the graph's pool and the buffers;
    nothing the allocator had cached is released), `warmup_launches` and
    `graph_launches` (kernel launches of the warm-up step and of one
    replay)."""

    def __init__(self, loss_and_grads, device):
        self._loss_and_grads = loss_and_grads
        self.device = torch.device(device)
        self._key = None
        self._graph = None
        self.last_call = None
        self.captures = self.replays = 0
        self.capture_ms = self.warmup_ms = 0.0
        self.held_bytes = 0
        self.warmup_launches = {k: 0 for k in ck.LAUNCHES}
        self.graph_launches = dict(self.warmup_launches)

    def step(self, state, scene, coords, target) -> torch.Tensor:
        """One step of `state` (updated in place) on inputs that already
        lie on the plan's device; returns the loss of the parameters before
        the update, a tensor of its own."""
        fresh = not _same_key(_state_key(state, scene, coords, target), self._key)
        with capture.current(self.device):
            if fresh:
                self._bind(state, scene, coords, target)
            else:
                self._load(scene, coords, target)
            if self.device.type != "cuda":
                self.last_call = "eager"
                state.opt_state.zero_grad(set_to_none=True)
                self._step()
            elif fresh:
                self.last_call = "captured"
                self._warm_up_and_capture()
            else:
                self.last_call = "replay"
                with annotate("step.launch", device=False):
                    capture.replay(self._graph, self.graph_launches)
                self.replays += 1
            loss = self._loss.clone()
        if fresh:  # the first step created the optimizer's state
            self._key = _state_key(state, scene, coords, target)
        return loss

    # ---- the buffers and the step over them ------------------------------

    def _bind(self, state, scene, coords, target):
        """Static buffers of the plan's own for a new state or structure."""
        self._graph = self._key = None
        self._state = state
        self._scene = capture.cloned(scene)
        self._coords, self._target = coords.clone(), target.clone()
        self._loss = torch.zeros((), device=self.device)

    def _load(self, scene, coords, target):
        """Copy this call's inputs into the static buffers."""
        for buf, new in zip(capture.tensor_leaves(self._scene) + [self._coords, self._target],
                            capture.tensor_leaves(scene) + [coords, target]):
            buf.copy_(new)

    def _forward_backward(self):
        """The forward and backward passes over the buffers: the loss into
        its buffer, the gradients into the state's `.grad`."""
        self._loss.copy_(self._loss_and_grads(self._state.params, self._scene,
                                              self._coords, self._target))

    def _step(self):
        """Span "step" around the forward and backward passes and span
        "optimizer" (`loss_and_grads` spans "forward" and "backward")."""
        with annotate("step"):
            self._forward_backward()
            with annotate("optimizer"):
                self._state.opt_state.step()

    def _warm_up_and_capture(self):
        """This call's step warmed up, then captured (`utils/capture.py`).
        The state keeps the warm-up step's gradients."""
        dev, opt = self.device, self._state.opt_state
        require_capturable(opt)
        t0 = time.perf_counter()
        reserved = capture.reserved_bytes(dev)
        passes = [("step", self._step)]
        opt.zero_grad(set_to_none=True)
        side, self.warmup_ms, self.warmup_launches = capture.warm_up(dev, passes,
                                                                     "training step")
        grads = [(p, p.grad) for p in self._state.params.values() if p.grad is not None]
        # backward() in the capture makes the gradients in the graph's pool
        opt.zero_grad(set_to_none=True)
        (self._graph,), (self.graph_launches,) = capture.capture(side, passes,
                                                                 "training step")
        with torch.no_grad():
            for p, g in grads:
                p.grad.copy_(g)
        torch.cuda.synchronize(dev)
        self.held_bytes = capture.reserved_bytes(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.captures += 1
