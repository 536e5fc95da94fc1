"""A frame captured once and replayed: the port's counterpart of the JAX
package's compiled frame program.

The JAX `SceneRenderer` compiles its frame once (`aot_compiled` or plain
`jax.jit` of `render._render_cpu_mode` / `render._render_gpu_mode`) and then
only dispatches it: `lax.map` over chunk indices, each chunk's rays made on
the device from `ci * chunk + arange`, and one `lax.while_loop` per chunk
whose condition `jnp.any(alive & ...)` is evaluated on the device. On the
card a `FramePlan` does the same with CUDA graphs. It captures three pieces
once, over static buffers of one chunk:

- "rays": the chunk's ray ids from a device scalar (the chunk index, never a
  Python constant), the pipeline's id map and pixel coordinates, the camera
  rays, and the reset of the running state (coefficient, alive, color);
- "step": one bounce step (`render._bounce_step`), narrowed as the eager
  loop narrows it, its results copied back into the state, and whether any
  ray is still alive reduced on the device and copied into a pinned host
  flag;
- "fold": the chunk's colors (folded into pixels when the frame folds)
  written into the frame's buffer at the chunk's offset.

`render()` then replays "rays", replays "step" until the flag says every
ray is dead or the depth cap is reached (one stream sync and one byte read
per bounce: the while loop's condition brought back to the host), replays
"fold", chunk after chunk, and assembles the image eagerly (the finalize and
unswizzle, or the box downscale). The chunks and bounces it runs are
exactly the eager loop's, and the image is the eager image bit for bit.

On the CPU nothing is captured: each piece is called as it stands, over the
same buffers and by the same loop, so the CPU tests run the plan's code.

Launch counts (`ops.cuda_intersect.LAUNCHES`) stay true: the launches a
piece records while it is captured are taken back out, and each replay adds
them again. The warm-up before each capture launches for real and counts
(`warmup_launches`).

A capture that fails raises, naming the piece; nothing falls back to eager
rendering. The graphs read the scene's tensors and the kernel pack at the
addresses they had at capture: like the JAX `SceneRenderer`'s closure over
its scene, reassigning them afterwards is not seen.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple

import torch

from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.colors import ColorOps
from raytracing_gpu_tpu_torch.ops.fp import f32

PIECES = ("rays", "step", "fold")


def uses_frame_graph(cfg, device) -> bool:
    """True where `SceneRenderer` renders by replaying a captured frame: on
    a CUDA device, with the bounce loops in the JAX package's compiled
    while-loop strategy (`cfg.resolve_unroll()` False). Elsewhere it renders
    eagerly: on the CPU, and in the unrolled, differentiable strategy."""
    return torch.device(device).type == "cuda" and not cfg.resolve_unroll()


class FrameLayout(NamedTuple):
    """One frame of either pipeline as the chunk loop sees it: `n_rays`
    rays made on `scene`'s camera from their ids (through `ray_id_map` when
    it is not None, then `coord_fn`), `chunk` at a time, traced through the
    GPU pipeline's bounce loop or the CPU pipeline's recursion
    (`gpu_semantics`), folded into pixels chunk by chunk when `fold4`;
    `finish` turns the frame's (n_out, 3) colors into the (H,W,3) image."""

    scene: Scene
    n_rays: int
    chunk: int
    coord_fn: Callable
    ray_id_map: Callable | None
    gpu_semantics: bool
    fold4: bool
    finish: Callable

    @property
    def n_out(self) -> int:
        return self.n_rays // 4 if self.fold4 else self.n_rays

    def coords(self, ray_ids):
        """(R,2) plane coordinates of the rays with these ids."""
        if self.ray_id_map is not None:
            ray_ids = self.ray_id_map(ray_ids)
        return self.coord_fn(ray_ids)


class FrameCounts(NamedTuple):
    """What one `FramePlan.render()` did: graph replays (calls on the CPU),
    stream syncs for the alive flag, and bounce steps per chunk."""

    replays: int
    syncs: int
    steps: tuple


@contextlib.contextmanager
def _sync_debug_error():
    """Any host sync inside the block raises (torch's sync debug mode)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _current(dev):
    """`dev` made the current CUDA device for the block (a graph is captured
    and replayed on the current device's streams); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def reserved_bytes(dev) -> int:
    """Bytes the caching allocator has reserved on a CUDA device (cached
    free blocks included; nothing is released to measure it); 0 on the
    CPU. A plan's `held_bytes` is the growth over its construction: the
    segments of its graphs' private pool, its buffers, and whatever its
    warm-up could not fit into blocks cached before."""
    return torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0


def capture_graph(graph, fn, stream, pool=None) -> None:
    """Capture `fn()` into the CUDA graph `graph` on `stream`, in the memory
    pool `pool` (None: a private one), as `torch.cuda.graph` does but
    without its `torch.cuda.empty_cache()`: a capture leaves the blocks the
    allocator has cached for the rest of the process where they are."""
    torch.cuda.synchronize(stream.device)  # nothing of before is in flight
    with torch.cuda.stream(stream):
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture is already invalid: fn's error says why
            raise
        graph.capture_end()


class FramePlan:
    """One scene's frame as three captured pieces and a replay loop (see
    the module docstring). `frame` is the pipeline's `FrameLayout`,
    `n_bounces` the depth cap, `step(o, d, coef, alive, color)` one bounce
    step returning `(o, d, coef, use, color)` and `fold(colors)` the fold of
    a chunk's subsamples. Built on `frame.scene`'s device: captured there on
    a card, run uncaptured on the CPU.

    After construction: `graphs` (pieces captured, 0 on the CPU),
    `capture_ms` (warm-up and capture), `held_bytes` (memory the card
    reserved for the buffers and the graphs, `reserved_bytes`; nothing the
    allocator had cached is released), `warmup_launches` and
    `graph_launches` (kernel launches of the warm-up, and of one replay of
    each piece); after each `render()`, `last_frame` (`FrameCounts`)."""

    def __init__(self, frame: FrameLayout, cfg, n_bounces: int, step, fold):
        self.frame, self.n_bounces = frame, n_bounces
        self._step_fn, self._fold_fn = step, fold
        self.cutoff = f32(cfg.reflect_cutoff)
        self.n_chunks = -(-frame.n_rays // frame.chunk)
        # the eager loop tests its rays before the first step too: every ray
        # is alive there with coefficient 1 (GPU mode: unconditional)
        self.first_step = frame.gpu_semantics or 1.0 >= self.cutoff
        dev = frame.scene.device
        self.device = dev
        self.last_frame = None
        t0 = time.perf_counter()
        reserved = reserved_bytes(dev)
        with torch.no_grad():
            # the camera basis once, on the host (camera_basis reads it back)
            self._u, self._v, self._C = camera_ops.camera_basis(frame.scene.camera)
            self._pos = frame.scene.camera.position
            cops = ColorOps(cfg.quantize)
            n = frame.chunk
            self._chunk_index = torch.zeros((), dtype=torch.int64, device=dev)
            self._o = torch.zeros((n, 3), device=dev)
            self._d = torch.zeros((n, 3), device=dev)
            self._coef = torch.zeros((n,), device=dev)
            self._alive = torch.zeros((n,), dtype=torch.bool, device=dev)
            self._color = cops.zeros((n,), device=dev)
            rows = n // 4 if frame.fold4 else n
            self._out = torch.zeros((self.n_chunks, rows, 3), device=dev)
            self._flag = torch.zeros((1,), dtype=torch.bool,
                                     pin_memory=dev.type == "cuda")
            self._flag_host = self._flag.numpy()
            self._pieces = {"rays": self._rays, "step": self._step,
                            "fold": self._fold}
            self._graphs = None
            self.warmup_launches = {k: 0 for k in ck.LAUNCHES}
            self.graph_launches = {p: dict(self.warmup_launches) for p in PIECES}
            if dev.type == "cuda":
                with _current(dev):
                    self._capture()
        self.graphs = len(self._graphs or ())
        self.held_bytes = reserved_bytes(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    # ---- the pieces: device work only, no host read ----------------------

    def _rays(self):
        """The chunk's camera rays and a fresh state."""
        dev = self.device
        chunk = self.frame.chunk
        r = torch.clamp(self._chunk_index * chunk + torch.arange(chunk, device=dev),
                        max=self.frame.n_rays - 1)
        o, d = camera_ops.make_rays(self._u, self._v, self._C, self._pos,
                                    self.frame.coords(r))
        self._o.copy_(o)
        self._d.copy_(d)
        self._coef.fill_(1.0)
        self._alive.fill_(True)
        self._color.zero_()

    def _step(self):
        """One bounce step over the state, narrowed as `render._trace`
        narrows it, and the flag: is any ray alive for the next step?"""
        alive = self._alive
        if not self.frame.gpu_semantics:
            alive = alive & (self._coef >= self.cutoff)
        o, d, coef, use, color = self._step_fn(self._o, self._d, self._coef,
                                               alive, self._color)
        if self.frame.gpu_semantics:
            use = use & (coef > self.cutoff)
            more = use
        else:
            more = use & (coef >= self.cutoff)
        for buf, new in ((self._o, o), (self._d, d), (self._coef, coef),
                         (self._alive, use), (self._color, color)):
            buf.copy_(new)
        self._flag.copy_(more.any().reshape(1), non_blocking=True)

    def _fold(self):
        """The chunk's colors (or pixels) into the frame buffer."""
        colors = self._fold_fn(self._color) if self.frame.fold4 else self._color
        self._out.index_copy_(0, self._chunk_index.reshape(1), colors[None])

    # ---- capture and replay ----------------------------------------------

    def _capture(self):
        """Warm each piece up on a side stream of the plan's device, in
        frame order and with any host sync raising, then capture it into a
        CUDA graph on the same stream; all three share one memory pool (they
        run one after another on one stream)."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = dict(ck.LAUNCHES)
        with torch.cuda.stream(side):
            for name in PIECES:
                try:
                    with _sync_debug_error():
                        self._pieces[name]()
                except RuntimeError as e:
                    raise RuntimeError(f"SceneRenderer: warming up the frame's "
                                       f"{name!r} piece failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmup_launches = {k: ck.LAUNCHES[k] - before[k] for k in before}
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for name in PIECES:
            graph = torch.cuda.CUDAGraph()
            with ck.captured_launches() as counts:
                try:
                    # on the side stream: torch's default capture stream
                    # belongs to the device current at its first use
                    capture_graph(graph, self._pieces[name], side, pool)
                except RuntimeError as e:
                    raise RuntimeError(f"SceneRenderer: capturing the frame's "
                                       f"{name!r} piece into a CUDA graph failed: "
                                       f"{e}") from e
            graphs[name] = graph
            self.graph_launches[name] = counts
        self._graphs = graphs
        torch.cuda.synchronize(dev)

    def _run(self, name):
        if self._graphs is None:
            self._pieces[name]()
        else:
            self._graphs[name].replay()
            ck.add_launches(self.graph_launches[name])

    def _any_alive(self) -> bool:
        """Wait for the last step and read its flag."""
        if self._graphs is not None:
            torch.cuda.current_stream(self.device).synchronize()
        return bool(self._flag_host[0])

    @torch.no_grad()
    def render(self) -> torch.Tensor:
        """One frame: (H,W,3) float32 in [0,255] on the device, a tensor of
        its own (the frame buffer is reused by the next frame)."""
        syncs, steps = 0, []
        with _current(self.device):
            for ci in range(self.n_chunks):
                self._chunk_index.fill_(ci)
                self._run("rays")
                n = 0
                go = self.first_step
                while go and n < self.n_bounces:
                    self._run("step")
                    n += 1
                    if n < self.n_bounces:
                        syncs += 1
                        go = self._any_alive()
                self._run("fold")
                steps.append(n)
        self.last_frame = FrameCounts(2 * self.n_chunks + sum(steps), syncs,
                                      tuple(steps))
        out = self._out.reshape(-1, 3)[:self.frame.n_out]
        return self.frame.finish(out).clone()
