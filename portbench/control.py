"""The readings that a cell's limits are set from, on the card, at the
cell's own size:

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--control N] [--program N] [--seconds 2]

- the control: the plain reference computed in TF32 (every stored float32
  intermediate rounded to 10 mantissa bits, `reference.round_tf32`), the
  precision below the configuration's float32, put in the program's place
  and held to the float32 reference by the cell's own comparison; for a
  frame cell also `ties_pct`, the reference against itself with the other
  order on exact ties (the highest triangle index wins), which says how
  much of a frame the order on ties decides;
- for a training cell, the faults as well: the step that leaves its state
  unchanged reads 1 on `change_gap` by construction; half of the batch left
  out (the reference's loss, gradient and Adam steps over the first half of
  the image's pixels, the mean taken over them) is read here; and `ties`,
  the reference against itself with the other order on exact ties;
- with `--program N`, the program's own readings (the lower ones) on the
  first N seeds, through `run.run` in this one process, `--seconds` each.

One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, reference, scenes  # noqa: E402


def frame_control(cell, seed: int, device) -> dict:
    tr = cell.traffic
    arrays = scenes.build(cell.config, tr["width"], tr["height"], seed)
    rng = np.random.default_rng([seed % (1 << 64), 2])
    n_pix = arrays.width * arrays.height
    pix = np.sort(rng.choice(n_pix, size=min(cell.check["pixels"], n_pix), replace=False))
    pix = torch.from_numpy(pix).to(device)
    ref = reference.frame_pixels(reference.ref_scene(arrays, device), tr["render"], pix)
    low = reference.frame_pixels(reference.ref_scene(arrays, device, reference.round_tf32),
                                 tr["render"], pix)
    sc = reference.ref_scene(arrays, device)
    other = reference.frame_pixels(sc, tr["render"], pix, reference.Tracer(sc, last_on_tie=True))
    diff = (ref.long() - low.long()).abs()
    return {"mismatch_pct": float((diff > 0).float().mean() * 100.0),
            "over1_pct": float((diff > 1).float().mean() * 100.0),
            "ties_pct": float((ref != other).float().mean() * 100.0)}


def train_readings(cell, seed: int, device) -> dict:
    tr = cell.traffic
    train = harness.plugin("traffic", "train")
    arrays = scenes.build(cell.config, tr["width"], tr["height"], seed)
    start = train.perturbed_start(arrays, tr["perturb"], seed)
    n = train.CHECKED_STEPS
    ref = reference.train_steps(arrays, tr["render"], start, tr["free"], n, device)
    out = {}
    for what, got in (("control", reference.train_steps(arrays, tr["render"], start, tr["free"],
                                                        n, device, q=reference.round_tf32)),
                      ("half_batch", reference.train_steps(
                          arrays, tr["render"], start, tr["free"], n, device,
                          pixels=torch.arange(arrays.width * arrays.height // 2,
                                              device=device))),
                      ("ties", reference.train_steps(arrays, tr["render"], start, tr["free"],
                                                     n, device, last_on_tie=True))):
        change = {k: got["params"][k] - start[k] for k in tr["free"]}
        ref_change = {k: ref["params"][k] - start[k] for k in tr["free"]}
        out[what] = {
            "first_loss_gap": abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": train.gaps(got["grads"], ref["grads"])[0],
            "change_gap": train.gaps(change, ref_change)[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--program", type=int, default=0,
                   help="also run the program on the first N seeds")
    p.add_argument("--control", type=int, default=None,
                   help="run the control and the faults on the first N seeds only")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("control.py needs a CUDA card")
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    from portbench import run as run_mod

    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        got = {}
        if args.control is None or i < args.control:
            if cell.traffic["kind"] == "train":
                got = train_readings(cell, seed, "cuda")
            else:
                got = {"control": frame_control(cell, seed, "cuda")}
        got["seed"], got["control_s"] = seed, time.perf_counter() - t
        if i < args.program:
            t = time.perf_counter()
            result, checks = run_mod.run(args.workload, seed, args.seconds, False, cell=cell,
                                         t_start=t)
            got["program"] = {k: v for k, (v, _) in checks.items()}
            got["program_metrics"] = {k: m["value"] for k, m in result["metrics"].items()}
        torch.cuda.empty_cache()
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
