"""Profiling and timing: the JAX package's `utils/profiling.py` (`trace`,
`annotate`, `Timer`) over torch.profiler and CUDA synchronisation, the
program's own recorder of spans and counters, and the measuring helpers
`chip_smoke.py` times the kernels and frames with.

- `trace(log_dir)`: torch.profiler over the block (CPU, and CUDA when there
  is a card); on exit a Chrome trace file lands in `log_dir`, one per
  process (host, rank and pid in its name).
- `annotate(name)`: a named span of the program. Off by default: one shared
  null context, or a named range of host time in the trace while a
  torch.profiler runs (a host event alone: `record_function`'s user
  annotation would also put a device row over the kernels it encloses,
  which the readers of a profile count as device work). Inside
  `recording()` it is also a span of the recorder.
- `recording()`: the recorder, on for the block. Each span takes two host
  stamps (`time.perf_counter_ns`) and, on a card, enqueues two device stamps
  (`stamp_kernel` of `csrc/frame_loop.cu`: its tag and `%globaltimer` into a
  preallocated buffer) on the stream of the work it encloses. What a CUDA
  graph holds is decided when it is captured: a plan captured inside
  `recording()` replays its stamps and counters inside its WHILE bodies and
  steps, where torch.profiler records nothing; one captured outside holds
  none, node for node what it held before the recorder existed.
  `count(name, value)` adds into a fixed table of int64 device slots
  (`COUNTERS`). `Recorder.export()` rebuilds the spans' nesting from the
  order of their stamps, puts device spans on the host clock (one
  calibration at each end of the block), and names each idle gap of the
  device between top-level device spans by the host span active at its
  midpoint. On the CPU the device spans are the host stamps, so
  `interpret` and the eager paths give the same span tree.
  `chrome_trace(export)` is the export as a Chrome trace: host and device
  tracks on the one clock (`rt --profile DIR` writes it beside torch's).
- `Timer`: best-of-N wall time of calls, synchronised with the card
  whenever their output holds a CUDA tensor.
- `cuda_ms`, `timed_once`, `device_ms`: CUDA-event times of calls on the
  card (eager, or captured in a CUDA graph and replayed); `profile_call`:
  one traced call's kernels and the device's busy share.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch


def _trace_name(kind: str = "trace") -> str:
    import torch.distributed as dist

    rank = f"rank{dist.get_rank()}." if dist.is_initialized() else ""
    return f"{kind}.{socket.gethostname()}.{rank}{os.getpid()}.json"


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


# ---- the program's recorder ---------------------------------------------------

# The device counters' slots: the rays each bounce step traces, after its
# narrowing, and the ray slots it was given (`FramePlan._step`, `render._trace`);
# the (triangle tile, ray tile) pairs that each tile cull keeps, and all of its
# pairs (`ops.intersect._count_tiles`); the (warp, 64-triangle unit) scans
# that the sweeps K1 and K2 are offered, and those they make because some ray
# of the warp enters the unit's box (`ops.cuda_intersect._count_units`).
COUNTERS = ("live_rays", "ray_slots", "tile_pairs_kept", "tile_pairs",
            "sweep_units", "sweep_units_scanned")
CAPACITY = 1 << 20  # device stamps a recorder holds: 16 MB, ~350 `spheres` frames
CALIBRATION_TRIES = 5
OUTSIDE = "outside the program"  # an idle gap no host span encloses
_NULL = contextlib.nullcontext()
_ACTIVE = None  # the Recorder of the enclosing `recording()`, or None


def active():
    """The recorder that `recording()` has on, or None."""
    return _ACTIVE


def _profiler_on() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _profiler_range(name: str):
    """A named range of host time in torch.profiler's trace, with no device
    row (`record_function`'s user annotation adds one over the kernels it
    encloses)."""
    return torch._C._profiler._RecordFunctionFast(name)


def annotate(name: str, device: bool = True):
    """A span of the program named `name`, around the work of a `with` block.
    With the recorder off it is one shared null context (a named range of
    host time in the trace while a torch.profiler runs).
    Inside `recording()` it takes two host stamps and, with `device` on a
    card, enqueues two device stamps on the current stream; `device=False`
    marks a span of host work alone (a launch, a read back)."""
    rec = _ACTIVE
    if rec is None:
        return _profiler_range(name) if _profiler_on() else _NULL
    return _Span(rec, rec.tag(name), device)


def count(name: str, value) -> None:
    """Add `value` (a tensor, summed, or an int) into the recorder's device
    counter `name` (one of COUNTERS); nothing with the recorder off."""
    rec = _ACTIVE
    if rec is not None:
        rec.count(name, value)


@contextlib.contextmanager
def recording(device=None):
    """The recorder on for the block (on `device`: the current card, or the
    CPU without one); yields it. Calibrates the device clock against the
    host's as it starts and as it ends."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("the recorder is already on")
    rec = Recorder(device)
    rec.calibrate()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec.calibrate()


@functools.cache
def _stamp_fn():
    """`rgt_stamp` of the kernels' library (built from csrc/ at first use)."""
    from raytracing_gpu_tpu_torch.csrc.build import load_library

    P, L = ctypes.c_void_p, ctypes.c_longlong
    return ctypes.CFUNCTYPE(ctypes.c_int, P, P, L, L, P)(("rgt_stamp", load_library()))


class _Span:
    __slots__ = ("_rec", "_tag", "_device", "_prof")

    def __init__(self, rec, tag: int, device: bool):
        self._rec, self._tag, self._device, self._prof = rec, tag, device, None

    def __enter__(self):
        if _profiler_on():
            self._prof = _profiler_range(self._rec.names[self._tag // 2])
            self._prof.__enter__()
        self._rec.stamp(self._tag, self._device)
        return self

    def __exit__(self, *exc):
        self._rec.stamp(self._tag + 1, self._device)
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False


class Span(NamedTuple):
    """A span: name, start and end in host-clock ns, depth, its parent's
    index in the same list (-1 at the top), and the host thread that took
    its stamps (0 for a device span)."""

    name: str
    start: int
    end: int
    depth: int
    parent: int
    thread: int = 0

    @property
    def ns(self) -> int:
        return self.end - self.start


def nest(stamps, names, thread: int = 0) -> list:
    """Spans from stamps `(tag, ns)` in the order they were taken (a span
    `i` begins at tag 2i and ends at 2i+1; negative tags are skipped): each
    end closes the innermost open span of its name, and any span opened
    inside it and still open. Nesting comes from this order alone, never
    from which host thread launched the work."""
    rows, stack, last = [], [], None
    for tag, t in stamps:
        if tag < 0:
            continue
        sid, end = divmod(int(tag), 2)
        last = t
        if not end:
            rows.append([names[sid], t, None, len(stack), stack[-1] if stack else -1])
            stack.append(len(rows) - 1)
            continue
        for k in range(len(stack) - 1, -1, -1):
            if rows[stack[k]][0] == names[sid]:
                for i in stack[k:]:
                    rows[i][2] = t
                del stack[k:]
                break
    for i in stack:  # left open: closed at the last stamp
        rows[i][2] = last
    return [Span(n, s, e, d, p, thread) for n, s, e, d, p in rows]


class Calibration(NamedTuple):
    """One reading of the two clocks: host ns before a stamp is launched,
    the stamp's device ns, host ns once it has synchronised."""

    host_before: int
    device: int
    host_after: int

    @property
    def offset(self) -> float:
        """Host ns minus device ns, at the middle of the host's window."""
        return (self.host_before + self.host_after) / 2 - self.device


def to_host(calibrations):
    """Device ns -> host ns from the first and last calibration, the offset
    moved linearly between them (the drift); one calibration: its offset."""
    a, b = calibrations[0], calibrations[-1]
    slope = ((b.offset - a.offset) / (b.device - a.device)
             if b.device > a.device else 0.0)
    return lambda g: int(round(g + a.offset + slope * (g - a.device)))


def host_span_at(spans, points) -> list:
    """For each of `points` (host ns), the name of the innermost (shortest)
    of `spans` that holds it, or OUTSIDE."""
    order = sorted(range(len(points)), key=points.__getitem__)
    by_start = sorted(spans, key=lambda s: s.start)
    out, open_, j = [OUTSIDE] * len(points), [], 0
    for i in order:
        p = points[i]
        while j < len(by_start) and by_start[j].start <= p:
            open_.append(by_start[j])
            j += 1
        open_ = [s for s in open_ if s.end >= p]
        if open_:
            out[i] = min(open_, key=lambda s: s.ns).name
    return out


def idle_gaps(device_spans, host_spans) -> list:
    """[(name, start ns, ns)] of the device's idle stretches between its
    top-level spans, each named by the innermost host span active at its
    midpoint (or OUTSIDE)."""
    top = sorted((s for s in device_spans if s.depth == 0), key=lambda s: s.start)
    gaps, end = [], None
    for s in top:
        if end is not None and s.start > end:
            gaps.append((end, s.start))
        end = s.end if end is None else max(end, s.end)
    names = host_span_at(host_spans, [(a + b) // 2 for a, b in gaps])
    return [(n, a, b - a) for n, (a, b) in zip(names, gaps)]


def resolution_ns(times) -> dict:
    """The device clock's step seen in successive stamps: the greatest
    common divisor and the least of their positive differences."""
    ts = sorted(times)
    steps = [b - a for a, b in zip(ts, ts[1:]) if b > a]
    return {"gcd": functools.reduce(math.gcd, steps) if steps else None,
            "min": min(steps) if steps else None}


class Recorder:
    """Spans and counters of the program in memory, on one device (see the
    module docstring). `names`: span names by id; host stamps `(tag, ns,
    thread, device)`; on a card `capacity` device stamps, their cursor (which
    counts on past the capacity: the excess was dropped) and the counters,
    all allocated here, before any capture can refer to them."""

    def __init__(self, device=None):
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if torch.cuda.is_available() else torch.device("cpu"))
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.capacity = CAPACITY
        self.names, self._ids = [], {}
        self._host = []
        self.calibrations = []
        self.counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=self.device)
        if self.cuda:
            self._buf = torch.zeros((CAPACITY, 2), dtype=torch.int64, device=self.device)
            self._cursor = torch.zeros((1,), dtype=torch.int64, device=self.device)
            self._cal = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
            self._cal_cursor = torch.zeros((1,), dtype=torch.int64, device=self.device)

    def tag(self, name: str) -> int:
        """The begin tag of the span `name` (its end tag is one more)."""
        sid = self._ids.get(name)
        if sid is None:
            sid = self._ids[name] = len(self.names)
            self.names.append(name)
        return 2 * sid

    def _launch(self, buf, cursor, capacity: int, tag: int) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = _stamp_fn()(buf.data_ptr(), cursor.data_ptr(), capacity, tag, stream)
        if rc:
            raise RuntimeError(f"launching the recorder's stamp kernel failed (CUDA "
                               f"error {rc})")

    def stamp(self, tag: int, device: bool = True) -> None:
        """A host stamp and, with `device` on a card, a device stamp."""
        self._host.append((tag, time.perf_counter_ns(), threading.get_ident(), device))
        if device and self.cuda:
            self._launch(self._buf, self._cursor, self.capacity, tag)

    def count(self, name: str, value) -> None:
        slot = self.counters[COUNTERS.index(name)]
        if isinstance(value, torch.Tensor):
            slot.add_(value.sum(dtype=torch.int64).to(self.device))
        else:
            slot.add_(int(value))

    def calibrate(self) -> Calibration:
        """Read both clocks: host ns, one synced device stamp, host ns; of
        CALIBRATION_TRIES, the one with the narrowest host window is kept."""
        best = None
        for _ in range(CALIBRATION_TRIES if self.cuda else 1):
            if self.cuda:
                torch.cuda.synchronize(self.device)
                self._cal_cursor.zero_()
                torch.cuda.synchronize(self.device)
                before = time.perf_counter_ns()
                self._launch(self._cal, self._cal_cursor, 1, -1)
                torch.cuda.synchronize(self.device)
                after = time.perf_counter_ns()
                cal = Calibration(before, int(self._cal[0, 1]), after)
            else:  # the CPU's device spans are on the host clock already
                now = time.perf_counter_ns()
                cal = Calibration(now, now, now)
            if best is None or cal.host_after - cal.host_before < \
                    best.host_after - best.host_before:
                best = cal
        self.calibrations.append(best)
        return best

    def clear(self) -> None:
        """Forget the stamps and counts so far (not the calibrations): what
        is exported afterwards is what runs from now on."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self._cursor.zero_()
        self.counters.zero_()
        self._host.clear()

    def _host_spans(self, device_kind=None) -> list:
        by_thread = {}
        for tag, t, thread, dev in self._host:
            if device_kind is None or dev == device_kind:
                by_thread.setdefault(thread, []).append((tag, t))
        spans = []
        for thread, stamps in by_thread.items():
            at = len(spans)
            spans += [s._replace(parent=s.parent + at if s.parent >= 0 else -1)
                      for s in nest(stamps, self.names, thread)]
        return spans

    def export(self) -> dict:
        """What was recorded, read to the host once: `host` and `device`
        spans (`Span`s on the host clock), `counters` {name: int},
        `stamps` (device stamps taken), `dropped` (past the capacity),
        `calibration` (the offset of the device clock at each end, the drift
        between, the widest host window of a reading), `resolution_ns` of
        the device clock, and `gaps` (`idle_gaps`)."""
        host = self._host_spans()
        counters = dict(zip(COUNTERS, (int(v) for v in self.counters.tolist())))
        cals = self.calibrations
        if self.cuda:
            taken = int(self._cursor.item())
            raw = self._buf[:min(taken, self.capacity)].tolist()
            clock = to_host(cals)
            device = nest([(tag, clock(t)) for tag, t in raw], self.names)
            resolution = resolution_ns([t for _, t in raw])
        else:
            device = self._host_spans(device_kind=True)
            taken, resolution = sum(d for *_, d in self._host), {"gcd": None, "min": None}
        drift = cals[-1].offset - cals[0].offset
        calibration = {
            "offset_ns": cals[0].offset, "offset_end_ns": cals[-1].offset,
            "drift_ns": drift,
            "between_s": (cals[-1].device - cals[0].device) * 1e-9,
            "window_ns": max(c.host_after - c.host_before for c in cals)}
        return {"device_kind": self.device.type, "host": host, "device": device,
                "counters": counters, "stamps": taken,
                "dropped": max(taken - self.capacity, 0) if self.cuda else 0,
                "calibration": calibration, "resolution_ns": resolution,
                "gaps": idle_gaps(device, host)}


def chrome_trace(export: dict) -> dict:
    """An export as a Chrome trace (chrome://tracing, Perfetto): one track
    per host thread, one for the device and one for its idle gaps, all on
    the host clock in µs from the first stamp; the counters, the dropped
    stamps and the calibration in `otherData`."""
    spans = export["host"] + export["device"]
    t0 = min((s.start for s in spans), default=0)
    threads = {}
    events = []
    for s in export["host"]:
        tid = threads.setdefault(s.thread, len(threads) + 1)
        events.append({"name": s.name, "ph": "X", "pid": 1, "tid": tid,
                       "ts": (s.start - t0) / 1e3, "dur": s.ns / 1e3, "cat": "host"})
    for s in export["device"]:
        events.append({"name": s.name, "ph": "X", "pid": 1, "tid": 0,
                       "ts": (s.start - t0) / 1e3, "dur": s.ns / 1e3, "cat": "device"})
    for name, start, ns in export["gaps"]:
        events.append({"name": name, "ph": "X", "pid": 1, "tid": -1,
                       "ts": (start - t0) / 1e3, "dur": ns / 1e3, "cat": "idle"})
    tracks = {0: "device", -1: "device idle", **{t: f"host thread {h}"
                                                  for h, t in threads.items()}}
    for tid, name in tracks.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                       "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ns",
            "otherData": {"counters": export["counters"], "stamps": export["stamps"],
                          "dropped": export["dropped"],
                          "calibration": export["calibration"],
                          "resolution_ns": export["resolution_ns"]}}


def write_chrome_trace(export: dict, log_dir: str) -> str:
    """`chrome_trace(export)` into `log_dir` as `program.<host>.<pid>.json`
    (the rank too, in a process group), beside `trace()`'s file; its path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, _trace_name("program"))
    with open(path, "w") as f:
        json.dump(chrome_trace(export), f)
    return path


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
