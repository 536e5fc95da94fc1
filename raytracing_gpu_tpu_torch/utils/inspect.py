"""Scene and acceleration-structure dumps: the JAX package's
`utils/inspect.py` (the reference's `gpu/test.cu` display_* dumpers as a
library and a command line), with the same text.

    python -m raytracing_gpu_tpu_torch.utils.inspect scene.svati \
        [--aabbs] [--keys] [--octree] [--memory] [--device cuda|cpu]

The scene and the structures are built on `--device` (default cuda, which
raises without a card); every dump reads them back through the host.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def describe_scene(scene) -> str:
    """display_scene analog (gpu/test.cu:44-100)."""
    g = scene.geometry
    m = scene.materials
    lines = [
        f"camera {scene.camera.width}x{scene.camera.height} "
        f"pos={_np(scene.camera.position).tolist()} "
        f"fov={float(scene.camera.fov)}",
        f"lights: {scene.lights.count} (kinds={list(scene.lights.kind)})",
        f"objects: {scene.n_objects} (padded {m.padded_count}); "
        f"triangles: {scene.n_triangles} (padded {g.padded_count})",
    ]
    owner = _np(g.tri_obj)[_np(g.valid)]
    for i in range(scene.n_objects):
        lines.append(
            f"  obj {i}: {int(np.sum(owner == i))} tris  ka={_np(m.ka[i]).tolist()} "
            f"kd={_np(m.kd[i]).tolist()} ks={_np(m.ks[i]).tolist()} "
            f"ns={float(m.ns[i])} nr={float(m.nr[i])}"
        )
    return "\n".join(lines)


def describe_aabbs(aabbs, obj_valid) -> str:
    """display_aabbs analog (gpu/test.cu)."""
    a, ok = _np(aabbs), _np(obj_valid)
    return "\n".join(f"  aabb {i}: min={a[i, 0].tolist()} max={a[i, 1].tolist()}"
                     for i in range(a.shape[0]) if ok[i])


def describe_keys(keys, levels) -> str:
    """Position keys: the 24-bit cell path (3-bit groups) and the level. The
    keys are int64 holding uint32 values, 0xFFFFFFFF for invalid objects."""
    k, lv = _np(keys), _np(levels)
    lines = []
    for i in range(k.shape[0]):
        if k[i] == 0xFFFFFFFF:
            continue
        path = int(k[i]) >> 8
        groups = [(path >> (3 * (7 - d))) & 7 for d in range(8)]
        lines.append(f"  key[{i}] = {int(k[i]):#010x} path={''.join(map(str, groups))} "
                     f"level={int(lv[i])}")
    return "\n".join(lines)


def describe_octree(tree) -> str:
    """display_octree_rec analog (gpu/test.cu:150-219): indented tree walk
    over the flat node tables. Boxes are rounded as float32 numpy arrays, as
    the JAX text rounds them."""
    nv, lvl = _np(tree.node_valid), _np(tree.node_level)
    start, end = _np(tree.node_start), _np(tree.node_end)
    sub_s, sub_e = _np(tree.node_sub_start), _np(tree.node_sub_end)
    kids, perm = _np(tree.node_children), _np(tree.perm)
    box = _np(tree.node_box).astype(np.float32)
    roots = [r for r in np.flatnonzero(nv) if lvl[r] == 0]
    out = [f"octree: {int(tree.n_nodes)} nodes"]

    def walk(r, indent):
        owned = [int(perm[s]) for s in range(start[r], end[r])]
        out.append(
            f"{'  ' * indent}node[{r}] d={lvl[r]} "
            f"box=[{box[r, 0].round(3).tolist()}, {box[r, 1].round(3).tolist()}] "
            f"objs={owned} subtree=[{sub_s[r]},{sub_e[r]})"
        )
        for c in kids[r]:
            if c >= 0:
                walk(int(c), indent + 1)

    for r in roots:
        walk(int(r), 1)
    return "\n".join(out)


def describe_device_memory(device="cuda") -> str:
    """display_GPU_memory analog (gpu/test.cu:35-42, cudaMemGetInfo): for a
    CUDA device, each visible card's memory in use (`mem_get_info`) and the
    part PyTorch has allocated; a CPU device reports nothing."""
    if torch.device(device).type != "cuda":
        return "cpu: memory stats unavailable"
    lines = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        lines.append(f"cuda:{i} {torch.cuda.get_device_name(i)}: "
                     f"{(total - free) / 1e6:.1f} MB in use / {total / 1e6:.1f} MB, "
                     f"{torch.cuda.memory_allocated(i) / 1e6:.1f} MB allocated by torch")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    from raytracing_gpu_tpu_torch.models.parser import parse_scene
    from raytracing_gpu_tpu_torch.partition.aabb import (
        compute_object_aabbs,
        compute_scene_aabb,
        objects_valid,
    )
    from raytracing_gpu_tpu_torch.partition.octree import build_octree, position_keys
    from raytracing_gpu_tpu_torch.render import resolve_device

    ap = argparse.ArgumentParser(prog="raytracing_gpu_tpu_torch.utils.inspect")
    ap.add_argument("scene")
    ap.add_argument("--aabbs", action="store_true")
    ap.add_argument("--keys", action="store_true")
    ap.add_argument("--octree", action="store_true")
    ap.add_argument("--memory", action="store_true",
                    help="device memory usage (display_GPU_memory analog)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to build on (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scene = parse_scene(args.scene).to(device)
    print(describe_scene(scene))
    if args.memory:
        print(describe_device_memory(device))
    if args.aabbs or args.keys or args.octree:
        g = scene.geometry
        n_obj = scene.materials.padded_count
        obj_valid = objects_valid(g.tri_obj, g.valid, n_obj)
        aabbs = compute_object_aabbs(g.vertices, g.tri_obj, g.valid, n_obj)
        scene_box = compute_scene_aabb(aabbs, obj_valid)
        if args.aabbs:
            print("aabbs:")
            print(describe_aabbs(aabbs, obj_valid))
            print(f"scene box: {_np(scene_box).tolist()}")
        if args.keys:
            keys, levels, _ = position_keys(aabbs, scene_box, obj_valid)
            print("position keys:")
            print(describe_keys(keys, levels))
        if args.octree:
            print(describe_octree(build_octree(aabbs, scene_box, obj_valid)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
