"""A frame captured once and launched as one CUDA graph: the port's
counterpart of the JAX package's compiled frame program.

The JAX `SceneRenderer` compiles its frame once (`aot_compiled` or plain
`jax.jit` of `render._render_cpu_mode` / `render._render_gpu_mode`) and then
only dispatches it: `lax.map` over chunk indices, each chunk's rays made on
the device from `ci * chunk + arange`, and one `lax.while_loop` per chunk
whose condition `jnp.any(alive & ...)` is evaluated on the device. On the
card a `FramePlan` does the same. It captures three pieces once with
PyTorch, over static buffers of one chunk:

- "rays": the chunk's ray ids from a device scalar (the chunk index, never a
  Python constant), the pipeline's id map and pixel coordinates, the camera
  rays, and the reset of the running state (coefficient, alive, color);
- "step": one bounce step (`render._bounce_step`), narrowed as the eager
  loop narrows it, its results copied back into the state, and whether any
  ray is still alive for the next step reduced into a one-element device
  flag;
- "fold": the chunk's colors (folded into pixels when the frame folds)
  written into the frame's buffer at the chunk's offset.

It then assembles them (`csrc/frame_loop.cu`) into one graph that runs
`PROGRAM`: a WHILE node over the chunks whose body holds "rays", the bounce
loop (a WHILE node over "step" and the `bounce_condition` kernel) and
"fold", with the `loop_reset` and `chunk_advance` kernels setting the two
conditions on the device. `render()` launches that graph once, assembles
the image eagerly (the finalize and unswizzle, or the box downscale), while
the recorder is on counting the host syncs torch makes meanwhile (there are
none), and then reads the loop state's counts once: the condition kernels'
launches and the bounce steps each chunk took, both counted on the device.
No host sync happens between chunks or bounces. The chunks and bounces it
runs are exactly the eager loop's, and the image is the eager image bit for
bit.

The pieces are the program's spans "rays", "bounce" (the bounce step's own
spans inside it, and "update" for the state copies and the flag) and
"fold" (`utils.profiling.annotate`); "bounce" also counts the rays it
traces and its slots (`profiling.count`). A plan captured inside
`profiling.recording()` holds their stamps and counters, so they replay
inside the WHILE bodies; one captured outside holds none.

On the CPU nothing is captured: `interpret` walks the same `PROGRAM` node
by node, calling the pieces and the kernels' plain twins (`loop_reset`,
`bounce_condition`, `chunk_advance`) over the same buffers, so the CPU tests
run the plan's code and its loop logic.

Launch counts stay true: `LAUNCHES` here gets the condition kernels'
launches as they counted them on the device, and `ops.cuda_intersect.
LAUNCHES` the launches each piece recorded at its capture times the number
of times the frame ran it, which the kernel after it in the program counted
(`loop_reset` for "rays", `bounce_condition` for "step", `chunk_advance`
for "fold"). The pieces are warmed up and captured as every plan's passes
are (`utils/capture.py`): the warm-up launches for real and counts
(`warmup_launches`).

A capture, an assembly or a launch that fails raises, naming the step;
nothing falls back to eager rendering or to a loop driven from the host.
The graph reads the scene's tensors and the kernel pack at the addresses
they had at capture: like the JAX `SceneRenderer`'s closure over its scene,
reassigning them afterwards is not seen. `render_image`'s plan
(`utils/image_graph.py`) owns such tensors and the camera basis and
refreshes them in place before each launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from typing import Callable, NamedTuple

import torch

from raytracing_gpu_tpu_torch.models.scene import Scene
from raytracing_gpu_tpu_torch.ops import camera as camera_ops
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.colors import ColorOps
from raytracing_gpu_tpu_torch.ops.fp import f32
from raytracing_gpu_tpu_torch.utils import capture, profiling
from raytracing_gpu_tpu_torch.utils.profiling import annotate

PIECES = ("rays", "step", "fold")
KERNELS = ("loop_reset", "bounce_condition", "chunk_advance")
CONDITIONS = ("chunks", "bounces")

# The frame program as plain data, walked by `interpret` on the CPU and, on
# the card, handed encoded (`encode_program`) to the assembly of the frame
# graph, which builds this program and refuses any other. A node is
# ("reset",): chunk index and counts set to 0; ("piece", name): one captured
# piece; ("kernel", name): a condition kernel (its twin on the CPU); or
# ("while", condition, body): the body run while the condition holds. The
# "chunks" condition is n_chunks > 0 at each launch (the graph's default);
# the "bounces" condition is set by `loop_reset` before each chunk.
PROGRAM = (
    ("reset",),
    ("while", "chunks", (                     # lax.map over chunk indices
        ("piece", "rays"),
        ("kernel", "loop_reset"),
        ("while", "bounces", (                # the chunk's lax.while_loop
            ("piece", "step"),
            ("kernel", "bounce_condition"),
        )),
        ("piece", "fold"),
        ("kernel", "chunk_advance"),
    )),
)

# opcodes of the encoded program (csrc/frame_loop.cu enum Op)
OPCODES = {"end": 0, "reset": 1, "piece": 2, "kernel": 3, "while": 4}

# Launches of the condition kernels, by kernel, as the kernels counted them
# on the device: `FramePlan.render()` adds them once it has read the loop
# state after a frame (never on the CPU, where their twins run).
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def encode_program(program) -> list[int]:
    """The program as the flat list of ints `rgt_frame_graph_build` reads:
    each node its opcode and argument, a WHILE body closed by "end"."""
    out = []
    for node in program:
        kind = node[0]
        out.append(OPCODES[kind])
        if kind == "piece":
            out.append(PIECES.index(node[1]))
        elif kind == "kernel":
            out.append(KERNELS.index(node[1]))
        elif kind == "while":
            out += [CONDITIONS.index(node[1]), *encode_program(node[2]), OPCODES["end"]]
    return out


def uses_frame_graph(cfg, device) -> bool:
    """True where `SceneRenderer` renders by launching a captured frame: on
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
    """What one `FramePlan.render()` did, as counted: launches of the frame
    graph (`FrameGraph.launches`; 0 on the CPU, which interprets the
    program), host syncs torch made from the launch to the finished image
    (`counted_syncs`, while the recorder is on; None otherwise and on the
    CPU), the bounce steps per chunk and
    {condition kernel: launches}, both counted on the device by the kernels
    (on the CPU by their twins) and read once, after the frame."""

    launches: int
    syncs: int | None
    steps: tuple
    loops: dict


class LoopState(NamedTuple):
    """The loops' state on the device: the chunk being traced (int64
    scalar), `counts` (int32: the launches of each of KERNELS, then the
    bounce steps each chunk took, `steps`), and whether any ray is alive
    for the next step (bool, 1; the step writes it)."""

    chunk_index: torch.Tensor
    counts: torch.Tensor
    flag: torch.Tensor

    @classmethod
    def zeros(cls, n_chunks: int, device) -> "LoopState":
        return cls(torch.zeros((), dtype=torch.int64, device=device),
                   torch.zeros((len(KERNELS) + n_chunks,), dtype=torch.int32,
                               device=device),
                   torch.zeros((1,), dtype=torch.bool, device=device))

    @property
    def steps(self) -> torch.Tensor:
        """The bounce steps of each chunk (a view of `counts`)."""
        return self.counts[len(KERNELS):]

    def read(self) -> tuple[tuple, dict]:
        """(steps per chunk, {kernel: launches}): one read to the host."""
        counts = self.counts.tolist()
        return tuple(counts[len(KERNELS):]), dict(zip(KERNELS, counts))


# ---- the condition kernels' plain twins (csrc/frame_loop.cu) --------------
# Each counts its run in the loop state, computes the next state from its
# tensors and writes the condition it sets into a one-element bool tensor;
# none reads to the host.

def reset_loops(state: LoopState) -> None:
    """The program's "reset" node: chunk index and counts to 0."""
    state.chunk_index.zero_()
    state.counts.zero_()


def loop_reset(bounces, state: LoopState, first_step: bool, n_bounces: int) -> None:
    """`loop_reset_kernel`: a chunk's bounce loop is entered when the eager
    loop's first test passes and the depth cap is not 0."""
    state.counts[KERNELS.index("loop_reset")].add_(1)
    bounces.fill_(bool(first_step and n_bounces > 0))


def bounce_condition(bounces, state: LoopState, n_bounces: int) -> None:
    """`bounce_condition_kernel`: count the step for the current chunk, and
    go on while a ray is alive for the next one and the cap allows it."""
    state.counts[KERNELS.index("bounce_condition")].add_(1)
    ci = state.chunk_index.reshape(1)
    n = state.steps.index_select(0, ci) + 1
    state.steps.index_copy_(0, ci, n)
    bounces.copy_(state.flag & (n < n_bounces))


def chunk_advance(chunks, state: LoopState, n_chunks: int) -> None:
    """`chunk_advance_kernel`: the next chunk, while there is one."""
    state.counts[KERNELS.index("chunk_advance")].add_(1)
    state.chunk_index.add_(1)
    chunks.copy_(state.chunk_index < n_chunks)


def interpret(program, state: LoopState, pieces: dict, n_chunks: int,
              n_bounces: int, first_step: bool) -> None:
    """Run `program` as the frame graph runs it, node by node, with the
    pieces (`pieces[name]()`) and the kernels' plain twins over `state`.
    Unlike the frame graph, the interpreter reads each condition to the
    host, with `tolist()` (on a CUDA tensor a sync: only the comparison of
    the kernels with their twins runs the interpreter there)."""
    dev = state.counts.device
    conds = {c: torch.zeros((1,), dtype=torch.bool, device=dev) for c in CONDITIONS}
    conds["chunks"].fill_(n_chunks > 0)  # the graph's default, at its launch
    twins = {"loop_reset": lambda: loop_reset(conds["bounces"], state, first_step,
                                              n_bounces),
             "bounce_condition": lambda: bounce_condition(conds["bounces"], state,
                                                          n_bounces),
             "chunk_advance": lambda: chunk_advance(conds["chunks"], state, n_chunks)}

    def run(nodes):
        for node in nodes:
            kind = node[0]
            if kind == "reset":
                reset_loops(state)
            elif kind == "piece":
                pieces[node[1]]()
            elif kind == "kernel":
                twins[node[1]]()
            else:
                while conds[node[1]].tolist()[0]:
                    run(node[2])

    run(program)


# ---- the frame graph on the card (csrc/frame_loop.cu) ----------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# cudaGraphNodeType's order (csrc/frame_loop.cu node_type_name)
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty",
              "event wait", "event record", "semaphore signal", "semaphore wait",
              "memory allocation", "memory free", "batch memory op", "conditional")


@functools.cache
def _loop_lib():
    """The frame-loop entry points of the kernels' library (built from
    csrc/ at first use)."""
    from raytracing_gpu_tpu_torch.csrc.build import load_library

    lib = load_library()
    return {
        "versions": ctypes.CFUNCTYPE(_I, ctypes.POINTER(_I), ctypes.POINTER(_I))(
            ("rgt_cuda_versions", lib)),
        "build": ctypes.CFUNCTYPE(_I, ctypes.POINTER(_I), _I, ctypes.POINTER(_P), _P, _P,
                                  _P, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_P),
                                  ctypes.c_char_p, _I)(("rgt_frame_graph_build", lib)),
        "launch": ctypes.CFUNCTYPE(_I, _P, _P)(("rgt_frame_graph_launch", lib)),
        "destroy": ctypes.CFUNCTYPE(_I, _P)(("rgt_frame_graph_destroy", lib)),
        "error_string": ctypes.CFUNCTYPE(ctypes.c_char_p, _I)(("rgt_error_string", lib)),
    }


def cuda_versions() -> tuple[int, int]:
    """(the CUDA version the system supports, the kernels' library's
    runtime version), e.g. 12080 for 12.8; conditional WHILE nodes need
    12030 or later."""
    system, runtime = _I(), _I()
    rc = _loop_lib()["versions"](ctypes.byref(system), ctypes.byref(runtime))
    if rc:
        raise RuntimeError(f"reading the CUDA versions: {_loop_lib()['error_string'](rc)}")
    return system.value, runtime.value


class FrameGraph:
    """`PROGRAM` assembled into one executable CUDA graph over the pieces'
    `cudaGraph_t`s (`pieces[name]`, an int) and the loop state, on the
    current device. `piece_nodes`: each piece's node types and their counts
    (child graphs' nodes included), from the walk that refuses the types a
    conditional body may not hold. `launches` counts `launch` calls.
    Assembly fails with a RuntimeError naming the step; so does `launch`."""

    def __init__(self, state: LoopState, pieces: dict, n_chunks: int, n_bounces: int,
                 first_step: bool):
        lib = _loop_lib()
        code = encode_program(PROGRAM)
        self._state = state  # the graph writes these tensors
        graphs = (_P * len(PIECES))(*(pieces[p] for p in PIECES))
        nodes = (_I * (len(PIECES) * len(NODE_TYPES)))()
        exec_ = _P()
        err = ctypes.create_string_buffer(512)
        rc = lib["build"]((_I * len(code))(*code), len(code), graphs,
                          state.chunk_index.data_ptr(), state.counts.data_ptr(),
                          state.flag.data_ptr(), n_chunks, n_bounces, int(first_step),
                          nodes, ctypes.byref(exec_), err, len(err))
        if rc:
            raise RuntimeError(f"assembling the frame graph failed at "
                               f"{err.value.decode() or lib['error_string'](rc).decode()}")
        self._exec = exec_.value
        self.launches = 0
        k = len(NODE_TYPES)
        self.piece_nodes = {p: {t: n for t, n in zip(NODE_TYPES, nodes[i * k:(i + 1) * k])
                                if n}
                            for i, p in enumerate(PIECES)}

    def launch(self, stream) -> None:
        """One launch on `stream` (a torch.cuda.Stream); does not sync."""
        rc = _loop_lib()["launch"](self._exec, stream.cuda_stream)
        if rc:
            raise RuntimeError("launching the frame graph failed: "
                               f"{_loop_lib()['error_string'](rc).decode()}")
        self.launches += 1

    def __del__(self):
        if getattr(self, "_exec", None):
            _loop_lib()["destroy"](self._exec)
            self._exec = None


class FramePlan:
    """One scene's frame as three captured pieces assembled into one CUDA
    graph with its loops on the device (see the module docstring). `frame`
    is the pipeline's `FrameLayout`, `n_bounces` the depth cap,
    `step(o, d, coef, alive, color)` one bounce step returning
    `(o, d, coef, use, color)` and `fold(colors)` the fold of a chunk's
    subsamples. `basis`: the camera's (u, v, C, position) as tensors the
    caller owns and refreshes in place before each frame (the graph reads
    them where they lie); None computes (u, v, C) once, on the host, and
    reads `frame.scene.camera.position`. Built on `frame.scene`'s device:
    captured and assembled there on a card, interpreted on the CPU.

    After construction: `graph` (the `FrameGraph` a frame launches, None on
    the CPU), `graphs` (1 on the card, 0 on the CPU), `piece_nodes` (each
    piece's node types and their counts, on the card), `capture_ms` (warm-up, capture and
    assembly; `assembly_ms` the last alone), `held_bytes` (memory the card
    reserved for the buffers and the pieces, `reserved_bytes`; nothing the
    allocator had cached is released), `warmup_launches` and
    `graph_launches` (kernel launches of the warm-up, and of one run of each
    piece); after each `render()`, `last_frame` (`FrameCounts`)."""

    def __init__(self, frame: FrameLayout, cfg, n_bounces: int, step, fold,
                 basis=None):
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
        reserved = capture.reserved_bytes(dev)
        with torch.no_grad():
            if basis is None:
                # the camera basis once, on the host (camera_basis reads it back)
                basis = (*camera_ops.camera_basis(frame.scene.camera),
                         frame.scene.camera.position)
            self._u, self._v, self._C, self._pos = basis
            cops = ColorOps(cfg.quantize)
            n = frame.chunk
            self._loop = LoopState.zeros(self.n_chunks, dev)
            self._o = torch.zeros((n, 3), device=dev)
            self._d = torch.zeros((n, 3), device=dev)
            self._coef = torch.zeros((n,), device=dev)
            self._alive = torch.zeros((n,), dtype=torch.bool, device=dev)
            self._color = cops.zeros((n,), device=dev)
            rows = n // 4 if frame.fold4 else n
            self._out = torch.zeros((self.n_chunks, rows, 3), device=dev)
            self._pieces = {"rays": self._rays, "step": self._step,
                            "fold": self._fold}
            self._graphs = self.graph = None
            self.piece_nodes = {}
            self.assembly_ms = 0.0
            self.warmup_launches = {k: 0 for k in ck.LAUNCHES}
            self.graph_launches = {p: dict(self.warmup_launches) for p in PIECES}
            if dev.type == "cuda":
                with capture.current(dev):
                    self._capture()
        self.graphs = int(self.graph is not None)
        self.held_bytes = capture.reserved_bytes(dev) - reserved
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    # ---- the pieces: device work only, no host read ----------------------

    def _rays(self):
        """The chunk's camera rays and a fresh state (span "rays")."""
        with annotate("rays"):
            dev = self.device
            chunk = self.frame.chunk
            r = torch.clamp(self._loop.chunk_index * chunk
                            + torch.arange(chunk, device=dev), max=self.frame.n_rays - 1)
            o, d = camera_ops.make_rays(self._u, self._v, self._C, self._pos,
                                        self.frame.coords(r))
            self._o.copy_(o)
            self._d.copy_(d)
            self._coef.fill_(1.0)
            self._alive.fill_(True)
            self._color.zero_()

    def _step(self):
        """One bounce step over the state, narrowed as `render._trace`
        narrows it, and the flag: is any ray alive for the next step? (Span
        "bounce"; the recorder counts the rays it traces and its slots.)"""
        with annotate("bounce"):
            alive = self._alive
            if not self.frame.gpu_semantics:
                alive = alive & (self._coef >= self.cutoff)
            profiling.count("live_rays", alive)
            profiling.count("ray_slots", alive.numel())
            o, d, coef, use, color = self._step_fn(self._o, self._d, self._coef,
                                                   alive, self._color)
            with annotate("update"):
                if self.frame.gpu_semantics:
                    use = use & (coef > self.cutoff)
                    more = use
                else:
                    more = use & (coef >= self.cutoff)
                for buf, new in ((self._o, o), (self._d, d), (self._coef, coef),
                                 (self._alive, use), (self._color, color)):
                    buf.copy_(new)
                self._loop.flag.copy_(more.any().reshape(1))

    def _fold(self):
        """The chunk's colors (or pixels) into the frame buffer (span
        "fold")."""
        with annotate("fold"):
            colors = self._fold_fn(self._color) if self.frame.fold4 else self._color
            self._out.index_copy_(0, self._loop.chunk_index.reshape(1), colors[None])

    # ---- capture, assembly and launch -------------------------------------

    def _capture(self):
        """Warm the pieces up and capture them, in frame order, into one
        memory pool (they run one after another on one stream), keeping
        each graph's `cudaGraph_t` (`utils/capture.py`); then assemble them
        into the frame graph."""
        passes = [(f"frame's {name!r} piece", self._pieces[name]) for name in PIECES]
        side, _, self.warmup_launches = capture.warm_up(self.device, passes,
                                                        "SceneRenderer")
        graphs, launches = capture.capture(side, passes, "SceneRenderer",
                                           torch.cuda.graph_pool_handle(), keep_graph=True)
        self._graphs = graphs  # they hold the pieces' memory pool
        self.graph_launches = dict(zip(PIECES, launches))
        t0 = time.perf_counter()
        raw = {name: g.raw_cuda_graph() for name, g in zip(PIECES, graphs)}
        try:
            self.graph = FrameGraph(self._loop, raw, self.n_chunks, self.n_bounces,
                                    self.first_step)
        except RuntimeError as e:
            raise RuntimeError(f"SceneRenderer: {e}") from e
        self.piece_nodes = self.graph.piece_nodes
        torch.cuda.synchronize(self.device)
        self.assembly_ms = (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def render(self) -> torch.Tensor:
        """One frame: (H,W,3) float32 in [0,255] on the device, a tensor of
        its own (the frame buffer is reused by the next frame)."""
        with capture.current(self.device):
            if self.graph is None:
                with annotate("frame.launch", device=False):
                    interpret(PROGRAM, self._loop, self._pieces, self.n_chunks,
                              self.n_bounces, self.first_step)
                with annotate("frame.finish", device=False):
                    out = self._finish()
                launches, syncs = 0, None
            else:
                before = self.graph.launches
                # syncs are counted only while recording: the count's sync
                # debug mode and caught warnings stay off the hot path
                recording = profiling.active() is not None
                with capture.counted_syncs() if recording else contextlib.nullcontext() as synced:
                    with annotate("frame.launch", device=False):
                        self.graph.launch(torch.cuda.current_stream(self.device))
                    with annotate("frame.finish", device=False):
                        out = self._finish()
                launches = self.graph.launches - before
                syncs = synced.n if recording else None
            # the frame's one read back, after its last chunk (`tolist`
            # dispatches no operation, so the CPU tests' guard lets it by)
            with annotate("frame.read", device=False):
                steps, loops = self._loop.read()
        if self.graph is not None:
            # each piece ran as often as the kernel after it in PROGRAM
            runs = {"rays": loops["loop_reset"], "step": loops["bounce_condition"],
                    "fold": loops["chunk_advance"]}
            for piece, n in runs.items():
                ck.add_launches({k: c * n for k, c in self.graph_launches[piece].items()})
            for k, n in loops.items():
                LAUNCHES[k] += n
        self.last_frame = FrameCounts(launches, syncs, steps, loops)
        return out

    def _finish(self):
        return self.frame.finish(self._out.reshape(-1, 3)[:self.frame.n_out]).clone()
