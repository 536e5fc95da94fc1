"""Profiling and timing: the JAX package's `utils/profiling.py` (`trace`,
`annotate`, `Timer`) over torch.profiler and CUDA synchronisation, and the
measuring helpers `chip_smoke.py` times the kernels and frames with.

- `trace(log_dir)`: torch.profiler over the block (CPU, and CUDA when there
  is a card); on exit a Chrome trace file lands in `log_dir`, one per
  process (host, rank and pid in its name).
- `annotate(name)`: a named span in that trace.
- `Timer`: best-of-N wall time of calls, synchronised with the card
  whenever their output holds a CUDA tensor.
- `cuda_ms`, `timed_once`, `device_ms`: CUDA-event times of calls on the
  card (eager, or captured in a CUDA graph and replayed); `profile_call`:
  one traced call's kernels and the device's busy share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time
from dataclasses import dataclass, field

import torch


def _trace_name() -> str:
    import torch.distributed as dist

    rank = f"rank{dist.get_rank()}." if dist.is_initialized() else ""
    return f"trace.{socket.gethostname()}.{rank}{os.getpid()}.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; yields the path of the Chrome trace file that is
    written into `log_dir` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, _trace_name())
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named span in the trace of an enclosing `trace()`."""
    return torch.profiler.record_function(name)


def _has_cuda_tensor(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_has_cuda_tensor(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_has_cuda_tensor(v) for v in out)
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return any(_has_cuda_tensor(getattr(out, f.name))
                   for f in dataclasses.fields(out))
    return False


@dataclass
class Timer:
    """Best-of-N wall timing of calls (device-synchronised)."""

    warmup: int = 1
    repeats: int = 5
    times: dict = field(default_factory=dict)

    @staticmethod
    def _sync(out):
        """Wait for the card when the output holds a CUDA tensor (in
        tuples, lists, dicts and dataclasses too): the host clock would
        otherwise time the enqueue."""
        if _has_cuda_tensor(out):
            torch.cuda.synchronize()

    def measure(self, name: str, fn, *args, **kwargs) -> float:
        for _ in range(self.warmup):
            self._sync(fn(*args, **kwargs))
        best = float("inf")
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            self._sync(fn(*args, **kwargs))
            best = min(best, time.perf_counter() - t0)
        self.times[name] = best
        return best

    def report(self) -> str:
        width = max((len(k) for k in self.times), default=0)
        return "\n".join(
            f"{k:<{width}s} {v * 1000:10.3f} ms" for k, v in self.times.items())


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds per call over `iters` calls, after one
    warm-up call."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call of `fn`."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device-only milliseconds per call: `launches` calls captured into one
    CUDA graph, the graph replayed `replays` times between two events. No
    host work of the caller is inside the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


@dataclass
class CallProfile:
    """One traced call: its host wall time, the device's kernels and copies
    (torch.profiler events) and the union of their intervals."""

    wall_ms: float
    kernels: list
    busy_ms: float

    @property
    def busy_share(self) -> float:
        return self.busy_ms / self.wall_ms


def profile_call(fn) -> CallProfile:
    """Trace one call of `fn` on the card with torch.profiler; raises when
    the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = union_us((k.time_range.start, k.time_range.end) for k in kernels)
    return CallProfile(wall_ms, kernels, busy / 1e3)
