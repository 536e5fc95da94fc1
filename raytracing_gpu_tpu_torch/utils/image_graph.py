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

The buffers and the graphs over them form a slot (`ImageSlot`). A plan
without grad has one: its image is a tensor of its own once the call
returns. A plan that needs grad keeps one slot per outstanding forward
pass, because the backward pass reads what its forward pass saved in its
slot's buffers and pool: a forward pass takes the lowest free slot, or
captures a new one (its own buffers, gradient buffers, graphs and memory
pool) while the plan has fewer than `MAX_SLOTS`. A slot is busy from its
forward pass until its image's autograd node is freed or its backward pass
ran without `retain_graph` (a zero-size token saved by the node is then
freed, and its finalizer frees the slot). So every image of a plan has its
own gradients, in any order, as under `jax.grad` of the JAX package's pure
render; a training loop (`render_image(...).mean().backward()` per step)
reuses one slot. Beyond `MAX_SLOTS` outstanding images a call renders
eagerly (`_render_frame`, the `plan=False` path, the same kernels), counted
in `eager_calls`. Each slot holds its memory for the plan's life (at 256²
with `remat` about 432 MiB on the card).

The first call of a slot is a real forward (and backward) pass over its
buffers, run eagerly on a side stream with any host sync raising; the
capture follows, and the call then replays the forward graph for its
image. Plans are kept by configuration, depth, device, the scene's
structure, which of its tensors require grad and whether grad is needed
(`image_plan`), at most `MAX_PLANS` of them, least recently used dropped
first (each holds its slots' graph pools): the counterpart of jit's cache.
`clear_image_plans()` drops them all. `backward(retain_graph=True)` twice
replays an image's backward graph twice; `create_graph=True` raises (the
captured backward pass is once-differentiable).

On the CPU nothing is captured: every call runs the same code over the
same slots' buffers, uncaptured, so the CPU tests run it. The warm-up, the
captures and the launch counts of a replay are every plan's
(`utils/capture.py`): a failure raises, naming the pass, and nothing falls
back to the eager path.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Callable, NamedTuple

import torch

from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import capture

MAX_PLANS = 4
MAX_SLOTS = 8


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
                                           for t in capture.tensor_leaves(scene))


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


class ImageSlot:
    """One set of a plan's buffers and the graphs captured over them: a copy
    of every tensor of the scene (bool and int ones too), the gradients of
    those that require grad and the incoming gradient of the image, the
    forward and backward graphs and their memory pool (see the module
    docstring).

    `busy` while an image of its forward pass may still be differentiated;
    `uses` counts its forward passes (an image's backward pass checks that
    its slot has run no forward pass since its own); after its capture, `capture_ms` (the slot's construction, warm-up and
    captures; `warmup_ms` the warm-up alone), `held_bytes` (memory the card
    reserved over them: the buffers and the pool, with the image's whole
    autograd graph when grad is needed; nothing the allocator had cached
    is released), `warmup_launches`, `forward_launches` and
    `backward_launches` (kernel launches of the warm-up and of one replay
    of each graph)."""

    def __init__(self, scene, grad: bool):
        self._t0 = time.perf_counter()
        self._reserved = capture.reserved_bytes(scene.device)
        self.busy = False
        self.uses = 0
        self.capture_ms = self.warmup_ms = 0.0
        self.held_bytes = 0
        self.warmup_launches = dict.fromkeys(ck.LAUNCHES, 0)
        self.forward_launches = dict(self.warmup_launches)
        self.backward_launches = dict(self.warmup_launches)
        self.graphs = None
        self.image = self.grads = None
        with torch.no_grad():
            self.scene = capture.cloned(scene)
            self.buffers = capture.tensor_leaves(self.scene)
            for buf, t in zip(self.buffers, capture.tensor_leaves(scene)):
                buf.requires_grad_(grad and t.requires_grad)
            self.grad_bufs = [b for b in self.buffers if b.requires_grad]
            cam = scene.camera
            self.grad_image = (torch.zeros((cam.height, cam.width, 3), device=scene.device)
                               if grad else None)


class ImagePlan:
    """`render_image` of one configuration, depth and scene structure as
    CUDA graphs and their replays, over one slot per outstanding forward
    pass (see the module docstring). Built from the scene of its first
    call; captured on that scene's device when it is a card, run uncaptured
    on the CPU.

    After each call: `last_call` ("eager" on the CPU and for a call beyond
    `MAX_SLOTS`, "captured" for a slot's warm-up and capture, "replay"),
    `slots` (its `ImageSlot`s, in the order they were made), `captures`
    (slots captured), `replays` and `backward_replays` (of the forward and
    the backward graphs), `generation` (forward passes over the slots so
    far), `eager_calls` (calls beyond `MAX_SLOTS` outstanding images), and
    `capture_ms`, `warmup_ms` and `held_bytes`, the sums of the slots' (a
    frame program's capture falls in its one slot's). A frame program's
    launches are its `FramePlan`'s, counted at each frame."""

    def __init__(self, scene, cfg, depth: int, grad: bool, program: ImageProgram):
        self.cfg, self.depth, self.grad = cfg, depth, grad
        self.device = scene.device
        self.frame_program = not cfg.resolve_unroll()
        self._program = program
        self.last_call = None
        self.captures = self.replays = self.backward_replays = 0
        self.generation = self.eager_calls = 0
        self.slots = [ImageSlot(scene, grad)]
        if self.frame_program:
            # the pack and the basis the frame graph reads, refreshed in
            # place by every call (`_run_forward`)
            with torch.no_grad():
                self._pack, self._basis = program.inputs(self.slots[0].scene, cfg)
                self._frame = program.frame(self.slots[0].scene, cfg, depth,
                                            self._pack, self._basis)

    @property
    def capture_ms(self) -> float:
        return sum(s.capture_ms for s in self.slots)

    @property
    def warmup_ms(self) -> float:
        return sum(s.warmup_ms for s in self.slots)

    @property
    def held_bytes(self) -> int:
        return sum(s.held_bytes for s in self.slots)

    def image(self, scene) -> torch.Tensor | None:
        """The image of `scene` (on the plan's device, of its structure),
        recorded by autograd when the plan's grad is needed, through the
        lowest free slot; None beyond `MAX_SLOTS` outstanding images (the
        call counted in `eager_calls`: the caller renders it eagerly)."""
        leaves = capture.tensor_leaves(scene)
        if not self.grad:
            return self.forward(self.slots[0], leaves)
        slot = self._free_slot(scene)
        if slot is None:
            self.last_call = "eager"
            self.eager_calls += 1
            return None
        return _GraphedImage.apply(self, slot, *leaves)

    # ---- the slots ----------------------------------------------------------

    def _free_slot(self, scene) -> ImageSlot | None:
        """The lowest free slot; a new one while there are fewer than
        `MAX_SLOTS`; else None. A slot is freed by a finalizer, which may
        run on autograd's device thread or inside a garbage collection on
        this one: a flag is set or read in one step, and nothing waits on
        a lock the finalizer would need."""
        slot = next((s for s in self.slots if not s.busy), None)
        if slot is None and len(self.slots) < MAX_SLOTS:
            slot = ImageSlot(scene, self.grad)
            self.slots.append(slot)
        return slot

    def _hold(self, slot: ImageSlot, token: torch.Tensor) -> None:
        """Mark `slot` busy until `token` (saved by its image's autograd
        node) is freed."""
        slot.busy = True
        weakref.finalize(token, _release, slot)

    # ---- the passes over a slot's buffers ------------------------------------

    def forward(self, slot: ImageSlot, leaves) -> torch.Tensor:
        """Copy the scene's tensors into the slot's buffers, run the forward
        pass over them (the slot's first call on a card: warm-up, capture,
        replay) and return the image, a tensor of its own."""
        with torch.no_grad(), capture.current(self.device):
            for buf, t in zip(slot.buffers, leaves):
                buf.copy_(t)
            slot.uses += 1
            if self.device.type != "cuda":
                self.last_call = "eager"
                self._run_forward(slot)
            else:
                if slot.graphs is None:
                    self.last_call = "captured"
                    self._warm_up_and_capture(slot)
                else:
                    self.last_call = "replay"
                    self.replays += 1
                capture.replay(slot.graphs[0], slot.forward_launches)
            self.generation += 1
            if self.frame_program:
                return self._frame.render()
            return slot.image.clone()

    def backward(self, slot: ImageSlot, grad_image) -> list:
        """The gradients of the slot's buffers that require grad (None where
        the image does not reach one), copies of their own, for the image
        of the slot's last forward pass."""
        with torch.no_grad(), capture.current(self.device):
            slot.grad_image.copy_(grad_image)
            if slot.graphs is None:
                self._run_backward(slot)
            else:
                capture.replay(slot.graphs[1], slot.backward_launches)
                self.backward_replays += 1
            return [None if g is None else g.clone() for g in slot.grads]

    def _run_forward(self, slot: ImageSlot):
        """What the forward graph holds: the image over the slot's buffers
        (with autograd recording when grad is needed), or a frame program's
        inputs rebuilt into the tensors its graph reads."""
        if self.frame_program:
            pack, basis = self._program.inputs(slot.scene, self.cfg)
            for buf, new in zip(_flat(self._pack, self._basis), _flat(pack, basis)):
                buf.copy_(new)
            return
        with torch.set_grad_enabled(self.grad):
            slot.image = self._program.image(slot.scene, self.cfg, self.depth)

    def _run_backward(self, slot: ImageSlot):
        """What the backward graph holds: the gradients of the slot's last
        forward pass's image against its `grad_image`, its graph kept for
        the next backward pass of the same image."""
        slot.grads = torch.autograd.grad(slot.image, slot.grad_bufs, slot.grad_image,
                                         retain_graph=True, allow_unused=True)

    # ---- warm-up and capture on the card -----------------------------------

    def _warm_up_and_capture(self, slot: ImageSlot):
        """The passes warmed up, then captured (`utils/capture.py`) into the
        slot's own memory pool: forward first, so that the backward capture
        allocates nothing over what the forward pass saved."""
        passes = [("forward pass" if not self.frame_program
                   else "pack and camera basis (the frame program's inputs)",
                   lambda: self._run_forward(slot))]
        if self.grad:
            passes.append(("backward pass", lambda: self._run_backward(slot)))
        side, slot.warmup_ms, slot.warmup_launches = capture.warm_up(self.device, passes,
                                                                     "render_image")
        slot.image = slot.grads = None  # the warm-up's graph and gradients
        # a pool per slot: a slot's saved tensors and `SweepTape`s stay where
        # its own graphs put them, whatever the other slots replay
        slot.graphs, launches = capture.capture(side, passes, "render_image",
                                                torch.cuda.graph_pool_handle())
        slot.forward_launches = launches[0]
        if self.grad:
            slot.backward_launches = launches[1]
        torch.cuda.synchronize(self.device)
        slot.held_bytes = capture.reserved_bytes(self.device) - slot._reserved
        slot.capture_ms = (time.perf_counter() - slot._t0) * 1e3
        self.captures += 1


def _release(slot: ImageSlot) -> None:
    slot.busy = False


def _flat(pack, basis) -> list:
    """The tensors of a kernel pack (None: none) and of a camera basis."""
    return [t for t in (pack or ()) if t is not None] + list(basis)


class _GraphedImage(torch.autograd.Function):
    """A plan's image as one autograd node over the scene's tensors: the
    forward pass through `ImagePlan.forward` over a slot, the backward pass
    through `ImagePlan.backward` over the same slot (see the module
    docstring). The node saves a zero-size token whose finalizer frees the
    slot: autograd drops it after a backward pass without `retain_graph`,
    and with the node. A saved-tensor hook that keeps a copy of the token
    (`torch.autograd.graph.save_on_cpu`, non-reentrant checkpointing)
    frees the slot as the forward pass returns; should a later forward
    pass then take that slot, this image's backward pass raises rather
    than read the later image's saved tensors."""

    @staticmethod
    def forward(ctx, plan, slot, *leaves):
        image = plan.forward(slot, leaves)
        token = torch.empty(0)
        ctx.save_for_backward(token)
        plan._hold(slot, token)
        ctx.plan, ctx.slot, ctx.use = plan, slot, slot.uses
        return image

    @staticmethod
    def backward(ctx, grad_image):
        if torch.is_grad_enabled():
            raise RuntimeError("render_image: the captured backward pass is "
                               "once-differentiable, so create_graph=True cannot "
                               "be taken through it; pass plan=False")
        ctx.saved_tensors  # raises once the token, and with it the slot, is freed
        slot = ctx.slot
        if slot.uses != ctx.use:
            raise RuntimeError(
                "render_image: this image's slot was freed while the image was "
                "outstanding and a later forward pass has taken it (a saved-tensor "
                "hook, such as torch.autograd.graph.save_on_cpu or non-reentrant "
                "checkpointing, copied the token that holds it); render such "
                "images with plan=False")
        grads = iter(ctx.plan.backward(slot, grad_image))
        return (None, None, *(next(grads) if buf.requires_grad else None
                              for buf in slot.buffers))


_PLANS: collections.OrderedDict = collections.OrderedDict()


def image_plan(scene, cfg, depth: int, grad: bool, program: ImageProgram) -> ImagePlan:
    """The plan for this call (made on a miss), now the most recently
    used; beyond `MAX_PLANS` the least recently used one is dropped."""
    key = (cfg, depth, scene.device, capture.structure(scene), grad,
           tuple(t.requires_grad for t in capture.tensor_leaves(scene)) if grad else None)
    plan = _PLANS.pop(key, None) or ImagePlan(scene, cfg, depth, grad, program)
    _PLANS[key] = plan
    while len(_PLANS) > MAX_PLANS:
        _PLANS.popitem(last=False)
    return plan


def image_plans() -> list:
    """The cached plans, least recently used first."""
    return list(_PLANS.values())


def clear_image_plans() -> None:
    """Drop every cached plan (and, once no image refers to it, its slots'
    graphs and their memory pools)."""
    _PLANS.clear()
