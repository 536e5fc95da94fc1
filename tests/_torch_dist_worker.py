"""One rank of the port's multi-process tests: a gloo group of CPU processes.

Launched by tests/test_torch_parallel.py (suite "parallel", 4 ranks) and
tests/test_torch_multihost.py (suite "multihost", 2 ranks), once per file:

    python _torch_dist_worker.py <suite> <port> <rank> <world> <out_dir>

Every rank forms the group through `parallel.multihost.initialize` and runs
every case of its suite in the same order (a mesh smaller than the world
leaves the other ranks idle for that case). A case's results go to
`<out_dir>/<case>.<rank>.npz`, read by the tests; a case that raises writes
`<out_dir>/error.<rank>.txt` and the process exits 1. Imports torch, numpy
and the port only, never jax: the tests compare these results with the
JAX package in their own process.
"""

import datetime
import os
import socket
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from raytracing_gpu_tpu_torch import RenderConfig  # noqa: E402
from raytracing_gpu_tpu_torch.models.procedural import make_sphere_scene  # noqa: E402
from raytracing_gpu_tpu_torch.ops import camera as camera_ops  # noqa: E402
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck  # noqa: E402
from raytracing_gpu_tpu_torch.ops.intersect import collide  # noqa: E402
from raytracing_gpu_tpu_torch.parallel import (  # noqa: E402
    collectives,
    extract_params,
    make_mesh,
    make_train_step,
    multihost,
    render_scene_sharded,
)
from raytracing_gpu_tpu_torch.parallel.checkpoint import (  # noqa: E402
    restore_train_state,
    save_train_state,
)
from raytracing_gpu_tpu_torch.parallel.render import shard_geometry, split_scene  # noqa: E402
from raytracing_gpu_tpu_torch.parallel.train import PARAM_KEYS  # noqa: E402

W = 16
RENDER_MESHES = ((4, 1), (2, 2), (1, 4))
GRAD_MESHES = ((2, 1), (1, 2), (2, 2))
MATCH = dict(mode="cpu", quantize="match", ray_chunk=512)
SMOOTH = dict(mode="cpu", quantize="smooth", ray_chunk=512, diff_max_depth=2)
GPU_MODE = dict(mode="gpu", quantize="match", ray_chunk=512, aliasing=2,
                backend="cuda", any_hit_min_tris=0)
WRONG_KD = [0.9, 0.9, 0.1]


def sphere_scene():
    return make_sphere_scene(W, W, n_lat=8, n_lon=12)


def all_coords():
    return camera_ops.cpu_subpixel_coords_traced(W, W, torch.arange(W * W * 4))


def zero_step(p):
    """SGD at rate 0 over every group: a step that leaves the gradients."""
    return torch.optim.SGD(list(p.values()), lr=0.0)


def gradients(mesh, backend, scene):
    """(loss, this rank's gradient of every group) of one step of the
    smooth loss against a flat grey target."""
    cfg = RenderConfig(backend=backend, **SMOOTH)
    init, step = make_train_step(mesh, cfg, scene, optimizer=zero_step, device="cpu")
    state = init(extract_params(scene))
    geo, rest = split_scene(scene)
    state, loss = step(state, geo, rest, all_coords(), torch.full((W * W, 3), 0.25))
    return float(loss), {k: state.params[k].grad.numpy() for k in PARAM_KEYS}


# ---- suite "parallel" ------------------------------------------------------


def case_renders(out, rank):
    """`match` renders of the sphere scene on every mesh and backend, the
    matmul backend and GPU mode on (2, 2), and the jittered scene the test
    wrote on (2, 2): {label: image} on every rank."""
    scene = sphere_scene()
    images = {}
    for backend in ("torch", "cuda"):
        cfg = RenderConfig(backend=backend, **MATCH)
        for t, s in RENDER_MESHES:
            images[f"{backend}_{t}x{s}"] = render_scene_sharded(
                scene, cfg, make_mesh(t, s), device="cpu")
    mesh = make_mesh(2, 2)
    images["cuda_matmul_2x2"] = render_scene_sharded(
        scene, RenderConfig(backend="cuda_matmul", **MATCH), mesh, device="cpu")
    images["gpu_mode_2x2"] = render_scene_sharded(
        scene, RenderConfig(**GPU_MODE), mesh, device="cpu")
    jittered = torch.load(os.path.join(out, "jittered_scene.pt"), weights_only=False)
    images["jittered_cuda_2x2"] = render_scene_sharded(
        jittered, RenderConfig(backend="cuda", **MATCH), mesh, device="cpu")
    return images


def case_too_few_ranks(out, rank):
    try:
        make_mesh(4, 2)
    except ValueError as e:
        return {"message": np.array(str(e))}
    return {"message": np.array("")}


def case_gather_backward(out, rank):
    """all_gather over the 4 ranks and its backward under a loss that every
    rank computes alike: each rank's gradient is its own slice, once."""
    group = make_mesh(4, 1).tiles_group
    x = (torch.arange(3.0) + 10.0 * rank).requires_grad_()
    y = collectives.all_gather(x, group)
    weight = torch.arange(12.0) + 1.0
    (y * weight).sum().backward()
    return {"gathered": y.detach().numpy(), "grad": x.grad.numpy()}


def case_collide_scene_group(out, rank):
    """Nearest hits of a ray batch with the triangles split over 4 shards
    (a 32-wide winner table, which carries materials on one process)."""
    scene = sphere_scene()
    mesh = make_mesh(1, 4)
    geo = shard_geometry(scene.geometry, mesh)
    pack = ck.pack_geometry(geo.vertices, geo.valid, geo.normals, geo.tri_obj,
                            scene.materials)
    u, v, C = camera_ops.camera_basis(scene.camera)
    o, d = camera_ops.make_rays(u, v, C, scene.camera.position, all_coords())
    res = {}
    for backend in ("cuda", "torch"):
        hit = collide(o, d, geo, backend=backend, pack=pack,
                      scene_group=mesh.scene_group)
        res.update({f"{backend}_{k}": getattr(hit, k).numpy()
                    for k in ("point", "normal", "obj", "dist", "mask")})
        res[f"{backend}_mat_is_none"] = np.array(hit.mat is None)
    return res


def case_gradients(out, rank):
    """Loss and gradients on each gradient mesh, backends torch and cuda."""
    scene = sphere_scene()
    res = {}
    for backend in ("torch", "cuda"):
        for t, s in GRAD_MESHES:
            mesh = make_mesh(t, s)
            if mesh.tile is None:
                continue
            loss, grads = gradients(mesh, backend, scene)
            label = f"{backend}_{t}x{s}"
            res[f"{label}_loss"] = np.array(loss)
            res[f"{label}_place"] = np.array([mesh.tile, mesh.shard])
            res.update({f"{label}_{k}": g for k, g in grads.items()})
    return res


def case_sgd_kd(out, rank):
    """Four SGD steps recovering a perturbed kd on the jittered scene,
    backend torch, mesh (4, 1): the JAX package's `_train_on_mesh` recipe."""
    from raytracing_gpu_tpu_torch import render_scene

    scene = torch.load(os.path.join(out, "jittered_scene.pt"), weights_only=False)
    cfg = RenderConfig(backend="torch", **SMOOTH)
    target = torch.from_numpy(render_scene(scene, cfg, device="cpu") / 255.0).reshape(-1, 3)
    params = dict(extract_params(scene))
    params["kd"] = params["kd"].clone()
    params["kd"][0] = torch.tensor(WRONG_KD)
    init, step = make_train_step(
        make_mesh(4, 1), cfg, scene, device="cpu",
        optimizer=lambda p: torch.optim.SGD([p["kd"]], lr=2.0))
    state = init(params)
    geo, rest = split_scene(scene)
    losses = []
    for _ in range(4):
        state, loss = step(state, geo, rest, all_coords(), target)
        losses.append(float(loss))
    return {"losses": np.array(losses), "kd": state.params["kd"].detach().numpy()}


# ---- suite "multihost" -----------------------------------------------------


def case_multihost_render(out, rank):
    scene = sphere_scene()
    cfg = RenderConfig(backend="cuda", **MATCH)
    return {f"{t}x{s}": multihost.render_scene_multihost(
                scene, cfg, multihost.global_mesh(t, s), device="cpu")
            for t, s in ((-1, 1), (1, 2))}


def case_checkpoint(out, rank):
    """One Adam step on mesh (1, 2), backend torch, saved; then restored
    into a fresh sharded state. The test holds the file against the
    one-device checkpoint of the same step."""
    scene = sphere_scene()
    cfg = RenderConfig(backend="torch", **SMOOTH)
    init, step = make_train_step(make_mesh(1, 2), cfg, scene, device="cpu")
    state = init(extract_params(scene))
    geo, rest = split_scene(scene)
    state, _ = step(state, geo, rest, all_coords(), torch.full((W * W, 3), 0.25))
    path = save_train_state(os.path.join(out, "ckpt"), state)
    restored = restore_train_state(path, like=init(extract_params(scene)))
    same = restored.step == state.step and all(
        torch.equal(restored.params[k], state.params[k]) for k in PARAM_KEYS)
    a, b = state.opt_state.state_dict()["state"], restored.opt_state.state_dict()["state"]
    same = same and all(torch.equal(v, b[i][name]) for i, slot in a.items()
                        for name, v in slot.items())
    return {"restored_equal": np.array(same), "path": np.array(path),
            "local_vertices": state.params["vertices"].detach().numpy()}


def case_cli(out, rank):
    """The CLI inside the group: --tiles 2, --tiles 1 --scene-shards 2, and
    --tiles 2 with --profile (each rank writes its own trace); rank 0 writes
    each image."""
    from raytracing_gpu_tpu_torch.__main__ import main

    scene_file = os.path.join(out, "scene.svati")
    for name, flags in (("tiles2", ["--tiles", "2"]),
                        ("shards2", ["--tiles", "1", "--scene-shards", "2"]),
                        ("tiles2_profiled", ["--tiles", "2", "--profile",
                                             os.path.join(out, "traces")])):
        code = main([scene_file, os.path.join(out, f"{name}.ppm"), "--device", "cpu",
                     *flags])
        if code != 0:
            raise RuntimeError(f"CLI {flags} exited {code}")
    return {}


SUITES = {
    "parallel": (case_renders, case_too_few_ranks, case_gather_backward,
                 case_collide_scene_group, case_gradients, case_sgd_kd),
    "multihost": (case_multihost_render, case_checkpoint, case_cli),
}


class Launch:
    """The ranks of one suite, started as subprocesses of the test;
    `load` waits for all of them once, then reads a case's results."""

    def __init__(self, suite: str, world: int, out, timeout: float = 600.0):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                            "MASTER_PORT")}
        env["OMP_NUM_THREADS"] = "1"
        self.out, self.timeout, self.logs = str(out), timeout, None
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(port), str(r),
             str(world), self.out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]

    def wait(self) -> None:
        if self.logs is None:
            try:
                self.logs = [p.communicate(timeout=self.timeout)[0].decode(errors="replace")
                             for p in self.procs]
            finally:
                self.close()
        failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            errors = []
            for r in failed:
                path = os.path.join(self.out, f"error.{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f.read())
            raise AssertionError(f"ranks {failed} failed:\n" + "\n---\n".join(
                errors + self.logs))

    def load(self, case: str, rank: int) -> dict:
        self.wait()
        with np.load(os.path.join(self.out, f"{case}.{rank}.npz")) as f:
            return dict(f)

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main() -> int:
    suite, port, rank, world, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=60))
    try:
        for case in SUITES[suite]:
            np.savez(os.path.join(out, f"{case.__name__[5:]}.{rank}.npz"),
                     **case(out, rank))
    except Exception:
        with open(os.path.join(out, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
