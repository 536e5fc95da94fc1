"""The benchmark's harness: one run of one cell.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`configs/<config>.json`, whose objects name their shapes, each built by
`scenes/<shape>.py`) and a traffic mix (`traffic/<traffic>.json`, data
whose `kind` names the loop `traffic/<kind>.py` that runs it);
`workloads/<cell>.json` holds the limits of its check and the check's size.
Every metric is a reader, `metrics/<metric>.py`, with `read(ctx) -> float |
None` over what the loop recorded: the window's host-clock times, the
program's counters, CUDA events, the profiler's trace, the work count. A
reader that finds nothing returns None and the metric is left out of the
result. The harness finds each of these files by the name that
BENCHMARK.json or the data gives (`plugin`), so a new cell, configuration,
shape, traffic mix, traffic kind or metric is a new file and an entry in
BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# compared by the whole top-level name: the program's name begins with the
# JAX package's, so a prefix test would flag the program itself
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_gpu_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names in `modules` (default sys.modules) that the run may
    not have loaded."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list
    check: dict  # workloads/<cell>.json: the limits and the size of the check


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                json.loads((HERE / "workloads" / f"{name}.json").read_text()))


@functools.lru_cache(maxsize=None)
def plugin(folder: str, name: str):
    """The module `<folder>/<name>.py` of the benchmark (a metric's reader,
    a traffic kind's loop, a shape's builder), loaded once."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {folder}/{name}.py in the benchmark")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """`read` of metrics/<metric>.py."""
    return plugin("metrics", metric).read


def read_metrics(entries: list, ctx: dict) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def peaks(kind: str) -> dict:
    """The card's published peaks (peaks.json), by torch's device name."""
    table = json.loads((HERE / "peaks.json").read_text())
    return table.get(kind) or table["default"]


def power_limit() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the profiler's trace, reduced
# ---------------------------------------------------------------------------

def short_name(name: str) -> str:
    """A kernel's name without its namespaces, argument list and `void`,
    cut to 100 characters: what the breakdown prints."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(junk, "")
    depth, out = 0, []
    for ch in name:  # drop the argument list that follows the template
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:100].strip()


def reduce_profile(prof) -> dict:
    """Device intervals of a torch.profiler run (`prof.events()`, which
    holds the kernels a CUDA graph launches): {"ops": [(name, start_ns,
    dur_ns)] of every device event (kernels, copies, sets), "kernels": how
    many were kernels, "busy_s": union of the intervals, "by_name": {short
    name: seconds}, "gaps": [(host activity, seconds)] of the idle
    stretches between them, longest first}."""
    import torch

    dev, host = [], []
    for e in prof.events():
        s, d = int(e.time_range.start * 1e3), int(e.time_range.elapsed_us() * 1e3)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, s, d))
        else:
            host.append((e.name, s, d))
    dev.sort(key=lambda x: x[1])
    busy, cur_s, cur_e, gaps = 0, None, None, []
    for name, s, d in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for name, s, d in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + d * 1e-9
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) // 2
        inner = [h for h in host if h[1] <= mid <= h[1] + h[2]]
        what = short_name(min(inner, key=lambda h: h[2])[0]) if inner else "host idle"
        named.append((what, (g1 - g0) * 1e-9))
    return {"ops": dev, "kernels": sum(not n.startswith(("Memcpy", "Memset")) for n, _, _ in dev),
            "busy_s": busy * 1e-9, "by_name": by_name, "gaps": named}


def breakdown(profile: dict, idle_gaps=None) -> dict:
    """The profile's ten device operations that took most time, and the ten
    longest idle gaps (the profile's own, or `idle_gaps` measured apart)."""
    top = sorted(profile["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = profile["gaps"] if idle_gaps is None else idle_gaps
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
