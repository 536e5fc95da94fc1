"""Run one cell of the port's benchmark once, on the card it is started on.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`
(`busy_s`, `window_s` with `--trace 1`), `breakdown` with `--trace 1`, and
`checks` last. Exits non-zero without a result when there is no CUDA card
(or fewer than the cell asks for), when the program is missing, or when
`jax`, `jaxlib`, `flax` or the JAX package `raytracing_gpu_tpu` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import common, harness  # noqa: E402


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault=None, cell=None, t_start=None) -> tuple:
    """(result dict, checks {name: (value, limit)}) of one run; `device`,
    `fault` and `cell` (a `harness.Cell` to use instead of BENCHMARK.json's)
    serve the tests."""
    import torch

    cell = cell or harness.load_cell(workload)
    limits = cell.check["limits"]
    ctx = {"t_start": T_START if t_start is None else t_start, "counters": {}}
    common.stamp(ctx, "torch imported")
    if device == "cuda":
        kind = torch.cuda.get_device_name(0)
        ctx["peaks"] = harness.peaks(kind)
    else:
        kind = "cpu"
    loop = harness.plugin("traffic", cell.traffic["kind"])
    got = loop.run(cell, seed, seconds, trace, device, ctx, fault=fault)
    # after the window, so that nvidia-smi's start-up is no part of set-up
    if device == "cuda":
        harness.log(f"card: {harness.power_limit()}; torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}")
    harness.log("set-up, seconds from the start at the end of each stage: " + "; ".join(
        f"{stage} {t:.2f}" for stage, t in ctx["stamps"]))
    loaded = harness.forbidden_modules()
    if loaded:
        raise SystemExit(f"forbidden modules loaded in the run: {loaded}")
    checks = {k: (float(v), float(limits[k])) for k, v in got.items()}
    correct = all(v <= lim for v, lim in checks.values())
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    result = {"correct": correct, "attempted": ctx["window"]["items"],
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(ctx["memory_peak_bytes"])}}
    if trace and "profile" in ctx:
        busy = ctx.get("device_busy", ctx["profile"])
        result["device"]["busy_s"] = busy["busy_s"]
        result["device"]["window_s"] = busy["window_s"]
        result["breakdown"] = harness.breakdown(ctx["profile"], ctx.get("idle_gaps"))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run(args.workload, args.seed, args.seconds, bool(args.trace),
                         cell=cell)
    for k, (v, lim) in checks.items():
        harness.log(f"check {k}: {v!r} (limit {lim!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
