"""The port's one way to capture work into CUDA graphs and keep its launch
counts true, for the frame's, the training step's and `render_image`'s
plans (`utils/frame_graph.py`, `utils/step_graph.py`, `utils/image_graph.py`).

A plan warms its named passes up (`warm_up`: eager, in order, on a side
stream with any host sync raising; those launches are real and stay counted
in `ops.cuda_intersect.LAUNCHES`), does what is its own, then captures them
on the same stream (`capture`), which gives each graph's recorded launches.
`replay` replays a graph and adds them again: a replay counts what one
eager run of its pass would. A failure raises, naming the plan and the
pass; nothing falls back to eager work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import types
import warnings

import torch

from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.utils import profiling


def tensor_leaves(obj) -> list:
    """The tensors of a (nested) dataclass, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += tensor_leaves(v)
    return out


def structure(obj) -> tuple:
    """Everything of a (nested) dataclass but its tensors' values: field
    names, plain values, and each tensor's shape, dtype and device."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append((f.name, tuple(v.shape), v.dtype, v.device))
        elif dataclasses.is_dataclass(v):
            out.append((f.name, structure(v)))
        else:
            out.append((f.name, v))
    return tuple(out)


def cloned(obj):
    """A copy of a (nested) dataclass with its own copy of every tensor."""
    return dataclasses.replace(obj, **{
        f.name: (v.clone() if isinstance(v, torch.Tensor)
                 else cloned(v) if dataclasses.is_dataclass(v) else v)
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)})


@contextlib.contextmanager
def counted_syncs():
    """Counts the host syncs torch makes inside the block, on a card (sync
    debug mode "warn", whose warnings are caught here): yields an object
    whose `n` holds the count once the block has ended. Other warnings are
    passed on."""
    count = types.SimpleNamespace(n=0)
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(before)
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            count.n += 1
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


def current(dev):
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
    # a graph captured while recording writes the recorder's buffers: it holds them
    graph.recorder = profiling.active()
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


def warm_up(dev, passes, owner: str) -> tuple:
    """Run each of `passes` ((name, fn) pairs) once, in order, eagerly on a
    new side stream of the CUDA device `dev` with any host sync raising,
    and wait for them: (that stream, milliseconds, {kernel: launches}). A
    pass that fails raises a RuntimeError naming `owner` and the pass."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    before, mode = dict(ck.LAUNCHES), torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side):
        for name, fn in passes:
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError as e:
                raise RuntimeError(f"{owner}: the warm-up of the {name} before the "
                                   f"capture failed: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    return (side, (time.perf_counter() - t0) * 1e3,
            {k: ck.LAUNCHES[k] - before[k] for k in before})


def capture(stream, passes, owner: str, pool=None, keep_graph: bool = False) -> tuple:
    """Each of `passes` ((name, fn) pairs) captured, in order, into a CUDA
    graph on the warm-up's `stream` (which runs nothing), in the memory pool
    `pool` (None: a private one each), each graph keeping its `cudaGraph_t`
    when `keep_graph`: ([graph], [{kernel: launches} its capture recorded]).
    A capture that fails raises a RuntimeError naming `owner` and the pass."""
    graphs, launches = [], []
    for name, fn in passes:
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with ck.captured_launches() as recorded:
            try:
                # on the side stream: torch's default capture stream belongs
                # to the device current at its first use
                capture_graph(graph, fn, stream, pool)
            except RuntimeError as e:
                raise RuntimeError(f"{owner}: capturing the {name} into a CUDA graph "
                                   f"failed: {e}") from e
        graphs.append(graph)
        launches.append(recorded)
    return graphs, launches


def replay(graph, launches: dict) -> None:
    """One replay of a captured graph, with the launches its capture
    recorded added to `ops.cuda_intersect.LAUNCHES`."""
    graph.replay()
    ck.add_launches(launches)
