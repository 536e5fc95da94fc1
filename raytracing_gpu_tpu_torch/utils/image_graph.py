"""`render_image` compiled once and replayed: the port's counterpart of the
JAX package's `jax.jit` on `render._render_cpu_mode` / `_render_gpu_mode`
(static config, depth, width and height), under `jax.grad` or without it.

The JAX package compiles its render once per configuration and shapes, and
`jax.grad` of it runs a compiled forward and a compiled backward pass. On
the card an `ImagePlan` does the same with CUDA graphs, captured over
static buffers of its own: a copy of every tensor of the scene (bool and
int ones too), and the gradients of those that require grad. Which call
takes which path follows the JAX package's strategy (`cfg.resolve_unroll()`):

- grad needed, the unrolled strategy: a forward graph (the kernel pack,
  the camera basis on the device, each chunk's rays and its trace at a
  fixed depth (every bounce step, checkpointed under `remat` with its
  `SweepTape`), the fold or the downscale) and a backward graph
  (`torch.autograd.grad` of the image over the grad-requiring buffers),
  captured in that order into one memory pool, as
  `torch.cuda.make_graphed_callables` does. A call copies the scene's
  tensors into the buffers, replays the forward graph and returns a copy of
  the image, recorded by `_GraphedImage`; its backward copies the incoming
  gradient into a buffer, replays the backward graph and returns copies of
  the gradients (None for a tensor that does not require grad or that the
  image does not reach, as eager autograd leaves it);
- no grad, the unrolled strategy: the forward graph alone, autograd off;
- no grad, the while-loop strategy: `SceneRenderer`'s frame program (a
  `frame_graph.FramePlan`: one graph, its loops on the device) over the
  plan's buffers, after an "inputs" graph that rebuilds the kernel pack
  and the camera basis from the scene's buffers into the tensors the frame
  graph reads: two launches per call, no host sync between them;
- grad needed with the while-loop strategy, and backend "torch" with
  partitioning, stay eager (`image_graph_blocker` says why).

The first call of a plan is a real forward (and backward) pass over its
buffers, run eagerly on a side stream with any host sync raising; the
capture follows, and the call then replays the forward graph for its
image. Plans are kept by configuration, depth, device, the scene's
structure, which of its tensors require grad and whether grad is needed
(`image_plan`), at most `MAX_PLANS` of them, least recently used dropped
first (each holds a graph pool): the counterpart of jit's cache.
`clear_image_plans()` drops them all.

One way this differs from JAX, whose functions are pure: a plan holds one
set of saved tensors, so a second forward replay overwrites what the
first image's backward pass needs. The backward pass of any image but the
newest of its plan raises `RuntimeError` and never returns numbers.
`backward(retain_graph=True)` twice on the newest image replays the
backward graph twice; `create_graph=True` raises (the captured backward
pass is once-differentiable).

On the CPU nothing is captured: every call runs the same code over the
same buffers, uncaptured (the stale-forward error too), so the CPU tests
run it. A warm-up or a capture that fails raises, naming the step; nothing
falls back to the eager path. Launch counts stay true: the warm-up launches
for real, and each replay adds the launches its capture recorded.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple

import torch

from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils.frame_graph import (
    _current,
    _sync_debug_error,
    capture_graph,
    reserved_bytes,
)
from raytracing_gpu_tpu_torch.utils.step_graph import cloned, structure, tensor_leaves

MAX_PLANS = 4

STALE = ("render_image: this image's forward pass was overwritten by a later call "
         "of its plan (the same configuration, depth, scene structure and "
         "grad-requiring tensors) before its backward pass ran: call backward "
         "before rendering again, or pass plan=False")


class ImageProgram(NamedTuple):
    """What a plan runs (`render.IMAGE_PROGRAM`): `image(scene, cfg, depth)`,
    the unrolled image with nothing read back to the host
    (`render.unrolled_image`); `inputs(scene, cfg)`, the kernel pack and the
    camera's (u, v, C) a frame program reads (`render.frame_program_inputs`);
    `frame(scene, cfg, depth, pack, basis)`, the `FramePlan` over them
    (`render.frame_plan`)."""

    image: Callable
    inputs: Callable
    frame: Callable


def needs_grad(scene) -> bool:
    """Grad mode is on and some tensor of the scene requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensor_leaves(scene))


def image_graph_blocker(cfg, grad: bool) -> str | None:
    """Why a `render_image` call of this configuration stays eager, or None."""
    if grad and not cfg.resolve_unroll():
        return ("gradients through the while-loop strategy (quantize='match' "
                "under unroll='auto', or unroll='while'), whose lax.while_loop "
                "the JAX package cannot reverse-differentiate: the port's eager "
                "loop can")
    if cfg.backend == "torch" and cfg.partitioning != "none":
        return ("backend 'torch' with partitioning: its object-level cull reads "
                "boxes that `with_accel` builds on the host, as in a training "
                "step")
    return None


def uses_image_graph(cfg, device, grad: bool) -> bool:
    """True where `render_image` replays a plan's CUDA graphs: on a CUDA
    device, unless `image_graph_blocker` names a reason to stay eager."""
    return (torch.device(device).type == "cuda"
            and image_graph_blocker(cfg, grad) is None)


class ImagePlan:
    """`render_image` of one configuration, depth and scene structure as
    CUDA graphs and their replays (see the module docstring). Built from
    the scene of its first call; captured on that scene's device when it
    is a card, run uncaptured on the CPU.

    After each call: `last_call` ("eager" on the CPU, "captured" for the
    warm-up and capture, "replay"), `captures`, `replays` and
    `backward_replays` (of the forward and the backward graph),
    `generation` (forward passes so far); after a capture, `capture_ms`
    (the plan's construction, warm-up and captures; `warmup_ms` the warm-up
    alone),
    `held_bytes` (memory the card reserved over them: the buffers, the
    graphs' pools, with the image's whole autograd graph when grad is
    needed; nothing the allocator had cached is released),
    `warmup_launches`, `forward_launches` and `backward_launches` (kernel
    launches of the warm-up and of one replay of each graph; a frame
    program's launches are its `FramePlan`'s, counted at each frame)."""

    def __init__(self, scene, cfg, depth: int, grad: bool, program: ImageProgram):
        self.cfg, self.depth, self.grad = cfg, depth, grad
        self.device = scene.device
        self.frame_program = not cfg.resolve_unroll()
        self._program = program
        self._t0 = time.perf_counter()
        self._reserved = reserved_bytes(self.device)
        self.last_call = None
        self.captures = self.replays = self.backward_replays = self.generation = 0
        self.capture_ms = self.warmup_ms = 0.0
        self.held_bytes = 0
        self.warmup_launches = dict.fromkeys(ck.LAUNCHES, 0)
        self.forward_launches = dict(self.warmup_launches)
        self.backward_launches = dict(self.warmup_launches)
        self._graphs = None
        self._image = self._grads = None
        with torch.no_grad():
            self._scene = cloned(scene)
            self._buffers = tensor_leaves(self._scene)
            for buf, t in zip(self._buffers, tensor_leaves(scene)):
                buf.requires_grad_(grad and t.requires_grad)
            self._grad_bufs = [b for b in self._buffers if b.requires_grad]
            cam = scene.camera
            self._grad_image = (torch.zeros((cam.height, cam.width, 3), device=self.device)
                                if grad else None)
            if self.frame_program:
                # the pack and the basis the frame graph reads, refreshed in
                # place by every call (`_run_forward`)
                self._pack, self._basis = program.inputs(self._scene, cfg)
                self._frame = program.frame(self._scene, cfg, depth, self._pack,
                                            self._basis)

    def image(self, scene) -> torch.Tensor:
        """The image of `scene` (on the plan's device, of its structure),
        recorded by autograd when the plan's grad is needed."""
        leaves = tensor_leaves(scene)
        if self.grad:
            return _GraphedImage.apply(self, *leaves)
        return self.forward(leaves)

    # ---- the passes over the buffers ---------------------------------------

    def forward(self, leaves) -> torch.Tensor:
        """Copy the scene's tensors into the buffers, run the forward pass
        over them (the first call on a card: warm-up, capture, replay) and
        return the image, a tensor of its own."""
        with torch.no_grad(), _current(self.device):
            for buf, t in zip(self._buffers, leaves):
                buf.copy_(t)
            if self.device.type != "cuda":
                self.last_call = "eager"
                self._run_forward()
            else:
                if self._graphs is None:
                    self.last_call = "captured"
                    self._warm_up_and_capture()
                else:
                    self.last_call = "replay"
                    self.replays += 1
                self._graphs[0].replay()
                ck.add_launches(self.forward_launches)
            self.generation += 1
            if self.frame_program:
                return self._frame.render()
            return self._image.clone()

    def backward(self, generation: int, grad_image) -> list:
        """The gradients of the buffers that require grad (None where the
        image does not reach one), copies of their own, for the image of
        forward pass `generation`, which must be the newest."""
        if generation != self.generation:
            raise RuntimeError(STALE)
        with torch.no_grad(), _current(self.device):
            self._grad_image.copy_(grad_image)
            if self._graphs is None:
                self._run_backward()
            else:
                self._graphs[1].replay()
                ck.add_launches(self.backward_launches)
                self.backward_replays += 1
            return [None if g is None else g.clone() for g in self._grads]

    def _run_forward(self):
        """What the forward graph holds: the image over the buffers (with
        autograd recording when grad is needed), or a frame program's
        inputs rebuilt into the tensors its graph reads."""
        if self.frame_program:
            pack, basis = self._program.inputs(self._scene, self.cfg)
            for buf, new in zip(_flat(self._pack, self._basis), _flat(pack, basis)):
                buf.copy_(new)
            return
        with torch.set_grad_enabled(self.grad):
            self._image = self._program.image(self._scene, self.cfg, self.depth)

    def _run_backward(self):
        """What the backward graph holds: the gradients of the last forward
        pass's image against `_grad_image`, its graph kept for the next
        backward pass of the same image."""
        self._grads = torch.autograd.grad(self._image, self._grad_bufs, self._grad_image,
                                          retain_graph=True, allow_unused=True)

    # ---- warm-up and capture on the card -----------------------------------

    def _warm_up_and_capture(self):
        """The passes eager on a side stream of the plan's device with any
        host sync raising, then each captured into a CUDA graph on the same
        stream (which runs nothing), all into one memory pool: forward
        first, so that the backward capture allocates nothing over what the
        forward pass saved."""
        dev = self.device
        passes = [("forward pass" if not self.frame_program
                   else "pack and camera basis (the frame program's inputs)",
                   self._run_forward)]
        if self.grad:
            passes.append(("backward pass", self._run_backward))
        what = " and ".join(name for name, _ in passes)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = dict(ck.LAUNCHES)
        with torch.cuda.stream(side):
            try:
                with _sync_debug_error():
                    for _, run in passes:
                        run()
            except RuntimeError as e:
                raise RuntimeError(f"render_image: the warm-up {what} before the "
                                   f"capture failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        self.warmup_launches = {k: ck.LAUNCHES[k] - before[k] for k in before}
        self._image = self._grads = None  # the warm-up's graph and gradients
        pool = torch.cuda.graph_pool_handle()
        graphs, counts = [], []
        for name, run in passes:
            graph = torch.cuda.CUDAGraph()
            with ck.captured_launches() as recorded:
                try:
                    capture_graph(graph, run, side, pool)
                except RuntimeError as e:
                    raise RuntimeError(f"render_image: capturing the {name} into a "
                                       f"CUDA graph failed: {e}") from e
            graphs.append(graph)
            counts.append(recorded)
        self._graphs = graphs
        self.forward_launches = counts[0]
        if self.grad:
            self.backward_launches = counts[1]
        torch.cuda.synchronize(dev)
        self.held_bytes = reserved_bytes(dev) - self._reserved
        self.capture_ms = (time.perf_counter() - self._t0) * 1e3
        self.captures += 1


def _flat(pack, basis) -> list:
    """The tensors of a kernel pack (None: none) and of a camera basis."""
    return [t for t in (pack or ()) if t is not None] + list(basis)


class _GraphedImage(torch.autograd.Function):
    """A plan's image as one autograd node over the scene's tensors: the
    forward pass through `ImagePlan.forward`, the backward pass through
    `ImagePlan.backward` (see the module docstring)."""

    @staticmethod
    def forward(ctx, plan, *leaves):
        image = plan.forward(leaves)
        ctx.plan, ctx.generation = plan, plan.generation
        return image

    @staticmethod
    def backward(ctx, grad_image):
        if torch.is_grad_enabled():
            raise RuntimeError("render_image: the captured backward pass is "
                               "once-differentiable, so create_graph=True cannot "
                               "be taken through it; pass plan=False")
        plan = ctx.plan
        grads = iter(plan.backward(ctx.generation, grad_image))
        return (None, *(next(grads) if buf.requires_grad else None
                        for buf in plan._buffers))


_PLANS: collections.OrderedDict = collections.OrderedDict()


def image_plan(scene, cfg, depth: int, grad: bool, program: ImageProgram) -> ImagePlan:
    """The plan for this call (made on a miss), now the most recently
    used; beyond `MAX_PLANS` the least recently used one is dropped."""
    key = (cfg, depth, scene.device, structure(scene), grad,
           tuple(t.requires_grad for t in tensor_leaves(scene)) if grad else None)
    plan = _PLANS.pop(key, None) or ImagePlan(scene, cfg, depth, grad, program)
    _PLANS[key] = plan
    while len(_PLANS) > MAX_PLANS:
        _PLANS.popitem(last=False)
    return plan


def image_plans() -> list:
    """The cached plans, least recently used first."""
    return list(_PLANS.values())


def clear_image_plans() -> None:
    """Drop every cached plan (and, once no image refers to it, its graphs
    and their memory pool)."""
    _PLANS.clear()
