"""The "train" traffic kind: inverse rendering, a closed loop of training
steps, one at a time, each `step_fn(state, scene, coords, target)` ending
in `torch.cuda.synchronize()`; the losses stay on the device until the
end. A mix of this kind (`traffic/<mix>.json`) gives the image size,
`render` (the `RenderConfig` fields), the free groups with their learning
rates (`free`) and the start's perturbation (`perturb`).

Set-up renders the target from the true scene, builds the step
(`make_train_step`, Adam with `capturable=True` on a card) and takes one
step from the start drawn from the seed: on a card that call runs the
step eagerly and captures it into a CUDA graph. The start parameters and
Adam's state are then put back in place, so that the CHECKED_STEPS steps
that the check reads are replays of the graph the window times (on a card
each must be one). The window goes on from them. With `trace`,
PROFILE_STEPS more steps run under torch.profiler. The check, against the
plain reference's steps from the same start: the first step's loss, the
first gradient (from Adam's state after that step), the parameters'
change over the checked steps, and the window's losses all finite.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, harness, reference

CHECKED_STEPS = 3
PROFILE_STEPS = 3


def perturbed_start(arrays, perturb: dict, seed: int) -> dict:
    """The training start drawn from the seed: kd moved uniformly within
    +-perturb["kd"] (clipped to [0.05, 1]), vertices by a normal of
    perturb["vertices"] times the scene's extent."""
    rng = np.random.default_rng([seed % (1 << 64), 1])
    verts, _, _, mats = arrays.soup()
    kd = mats[:, 3:6]
    kd = np.clip(kd + rng.uniform(-perturb["kd"], perturb["kd"], kd.shape), 0.05, 1.0)
    ext = float(verts.max() - verts.min())
    v = verts + rng.normal(0.0, perturb["vertices"] * ext, verts.shape)
    return {"kd": kd.astype(np.float32), "vertices": v.astype(np.float32)}


def gaps(prog: dict, ref: dict) -> tuple:
    """(worst leaf's |norm(prog) - norm(ref)| / max(norm(ref), median
    leaf's norm), {leaf: gap}) over the leaves whose reference norm is at
    least a thousandth of the median leaf's."""
    norms = {k: float(np.linalg.norm(ref[k])) for k in ref}
    med = float(np.median(list(norms.values())))
    out = {k: abs(float(np.linalg.norm(prog[k])) - norms[k]) / max(norms[k], med, 1e-30)
           for k in ref if norms[k] >= 1e-3 * med}
    return max(out.values()), out


def _restart(state, start: dict, torch) -> None:
    """Put the start parameters back into the state's tensors and Adam's
    state back to nought, in place: the tensors the captured step reads
    stay the same, and the next step is a first step again."""
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(start[k])
        for slot in state.opt_state.state.values():
            for v in slot.values():
                if torch.is_tensor(v):
                    v.zero_()


def run(cell, seed: int, seconds: float, trace: bool, device: str, ctx: dict,
        fault=None) -> dict:
    """One run of the cell; returns the compared numbers. `fault(step_fn)`,
    for the tests of the check, wraps the step."""
    import torch

    from raytracing_gpu_tpu_torch import RenderConfig
    from raytracing_gpu_tpu_torch.parallel import extract_params, make_train_step, predict_pixels
    from raytracing_gpu_tpu_torch.render import required_depth

    tr = cell.traffic
    arrays, scene = common.load_scene(cell, seed, ctx)
    cfg = RenderConfig(**tr["render"])
    free = tr["free"]
    start = perturbed_start(arrays, tr["perturb"], seed)
    n_obj, n_tri = len(arrays.objects), arrays.n_triangles
    cuda = torch.device(device).type == "cuda"

    def optimizer(p):
        return torch.optim.Adam([{"params": [p[k]], "lr": lr} for k, lr in free.items()],
                                capturable=cuda)

    init_state, step_fn = make_train_step(None, cfg, scene, optimizer=optimizer,
                                          device=device)
    plan = step_fn.plan
    if fault is not None:
        step_fn = fault(step_fn)
    params = {k: v.clone() for k, v in extract_params(scene).items()}
    params["kd"][:n_obj] = torch.from_numpy(start["kd"])
    params["vertices"][:n_tri] = torch.from_numpy(start["vertices"])
    state = init_state(params)
    start_params = {k: p.detach().clone() for k, p in state.params.items()}
    scene_d = scene.to(device)
    W, H = arrays.width, arrays.height
    coords = reference.cpu_coords(W, H, torch.arange(W * H * 4)).to(device)
    depth = required_depth(float(scene.materials.nr.max()), cfg.reflect_cutoff,
                           cfg.diff_max_depth)
    with torch.no_grad():
        target = predict_pixels(scene_d, cfg, depth, coords, device=device)
    common.stamp(ctx, "step built, target rendered")
    # the first call captures the step (on a card); the checked steps start
    # again from the start and replay it
    state, _ = step_fn(state, scene_d, coords, target)
    common.sync(torch, device)
    _restart(state, start_params, torch)
    common.stamp(ctx, "step captured")
    losses = []
    for i in range(CHECKED_STEPS):
        state, loss = step_fn(state, scene_d, coords, target)
        common.sync(torch, device)
        if plan is not None and cuda and plan.last_call != "replay":
            raise RuntimeError(f"checked step {i + 1} was {plan.last_call!r}, not a replay "
                               f"of the captured step")
        losses.append(loss)
        if i == 0:
            beta1 = state.opt_state.param_groups[0]["betas"][0]
            first_grad = {k: (state.opt_state.state[state.params[k]]["exp_avg"] / (1 - beta1))
                          .detach().cpu().numpy().copy() for k in free}
    after = {k: state.params[k].detach().cpu().numpy().copy() for k in free}
    if plan is not None:
        ctx["counters"]["capture_ms"] = plan.capture_ms
        ctx["counters"]["k1_per_step"] = plan.graph_launches.get("nearest_hit")
    common.stamp(ctx, "checked steps")
    ctx["setup_s"] = time.perf_counter() - ctx["t_start"]
    window_losses = []

    def item():
        nonlocal state
        state, loss = step_fn(state, scene_d, coords, target)
        window_losses.append(loss)
        common.sync(torch, device)

    wall, times = common.window(item, seconds, torch, device)
    ctx["window"] = {"seconds": wall, "times": times, "items": len(times), "unit": "step"}
    ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        ctx["profile"] = common.profiled(item, PROFILE_STEPS, torch)
    losses = [float(x) for x in losses]
    window_finite = bool(torch.isfinite(torch.stack(window_losses)).all())
    del state, step_fn, init_state, scene_d, target, window_losses, plan, start_params
    common.free(torch, device)

    t = time.perf_counter()
    ref = reference.train_steps(arrays, tr["render"], start, free, CHECKED_STEPS, device)
    rows = {"kd": n_obj, "vertices": n_tri}  # the program's groups are padded
    grad, grad_leaves = gaps({k: first_grad[k][:rows[k]] for k in free}, ref["grads"])
    change, change_leaves = gaps({k: after[k][:rows[k]] - start[k] for k in free},
                                 {k: ref["params"][k] - start[k] for k in free})
    harness.log(f"reference: {CHECKED_STEPS} steps in {time.perf_counter() - t:.2f} s; "
                f"losses {losses} against {ref['losses']}; grad gaps {grad_leaves}; "
                f"change gaps {change_leaves}")
    # the first step's loss: the later steps' losses swing by seed and by
    # run as exact ties and shadow edges flip under parameters that differ
    # by rounding (PERF.md §6)
    return {"first_loss_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": grad, "change_gap": change,
            "window_losses_nonfinite": 0.0 if window_finite else 1.0}
