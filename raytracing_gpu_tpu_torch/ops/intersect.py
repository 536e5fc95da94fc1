"""Nearest-hit and shadow intersection on three backends.

The JAX package's `ops/intersect.py`: `collide` is the reference's `collide`
(cpu/hit.c:72-91), nearest accepted hit with first-occurrence ties;
`collide_dist` its distance-only twin for shadow rays (cpu/hit.c:93-109),
0.0 on a miss; `collide_any` the boolean the shadow test actually reads.

- backend "torch": all-pairs Möller–Trumbore over the scene in file order
  (`_mt_core`), in ray blocks so memory stays bounded, less the (ray,
  object) pairs that the scene's acceleration data culls (`_cull_mask`:
  `Geometry.obj_aabb` / `octree`). With `partitioning="none"` it is the
  port's brute-force reference.
- backend "cuda": the kernel path of `ops/cuda_intersect.py` — tile culling,
  the K1/K2 sweeps and the K3 winner-row fetch — then u/v/t, hit point and
  normal recomputed on the winner with plain tensor ops. Winners are in
  clustered order, the JAX "pallas" backend's tie-break. `f2b_tiles > 0`
  takes the two-round front-to-back sweep over K1 on scenes with more than
  2*f2b_tiles triangle tiles; `any_hit_min_tris` at or below the triangle
  count sends `collide_any` through the any-hit sweep K4.
- backend "cuda_matmul": the same path with the matmul-form sweeps K5/K6
  (the JAX "mxu" backend): rays recentred on the centroid of the live rays,
  the four determinants as 16-feature dot products. Their association
  differs from the scalar form, so winners may flip on exact geometry edges.

Differentiability: a sweep only selects (a winner slot and a hit mask, both
piecewise constant), so every sweep runs under `no_grad` on any backend, the
port's form of the JAX package's `stop_gradient` barrier. u/v/t, distance,
point and normal are recomputed on each ray's winner from the fetched rows
(`FetchRows` on the card) or the gathered triangle, and carry the gradient
to rays, vertices, normals and, on 32-wide tables, materials. On an exact
tie the first winner alone gets it. A `SweepTape` lets a checkpointed bounce
step run its sweeps once: recorded in the forward pass, replayed when the
step is recomputed in the backward pass.

Scene sharding (`scene_group`, the JAX package's `scene_axis`): each rank of
the group holds a contiguous, ascending range of the triangles and sweeps
only those (on the kernel backends it packs only those). `collide` gathers
every shard's winning sweep distance and winner row over the group and
keeps the first shard attaining the minimum, which with ascending ranges is
the lowest-index tie-break; u/v/t, point, normal and distance are computed
once, after the combine, alike on every rank. The gather's backward hands
each rank the cotangent of its own rows only, so the gradient reaches the
owning shard's triangles once and the rays' gradient is whole on every
rank. `Hit.mat` stays None there: materials are replicated, and shading
takes them from the combined object id. `collide_dist` takes the minimum
over the group, `collide_any` the OR. The combines sit outside the taped
sweeps, so a recomputed bounce step runs the same collectives in the same
order on every rank.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_gpu_tpu_torch.config import ANY_HIT_OFF
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.fp import f32, sqrt_rn
from raytracing_gpu_tpu_torch.utils.profiling import annotate, count

INF = float("inf")
KERNEL_BACKENDS = ("cuda", "cuda_matmul")

# pairs per block of the all-pairs "torch" backend: bounds its memory
_PAIRS_PER_BLOCK = 1 << 22


@dataclasses.dataclass
class Hit:
    """Nearest-hit result for a batch of R rays."""

    point: torch.Tensor  # (R,3) hit point (garbage where ~mask)
    normal: torch.Tensor  # (R,3) interpolated, NOT renormalized
    obj: torch.Tensor  # (R,) int32 owning object
    dist: torch.Tensor  # (R,) |point - origin|, inf where ~mask
    mask: torch.Tensor  # (R,) bool, True where the ray hit
    mat: torch.Tensor | None = None  # (R,11) [ka kd ks ns nr] of the winner
    # (cuda backend: fetched with the winner row)


class SweepTape:
    """The results of one bounce step's sweeps, in call order: recorded the
    first time the step runs and, after `rewind()`, handed back when the step
    is recomputed, so that rematerialization does not sweep again. Each
    recomputation takes every item in order, so a second one (a backward
    pass with `retain_graph=True`, run again) starts over at the first."""

    def __init__(self):
        self._items = []
        self._next = None  # None: recording

    def rewind(self) -> None:
        self._next = 0

    def take(self, sweep):
        if self._next is None:
            self._items.append(sweep())
            return self._items[-1]
        item = self._items[self._next]
        self._next = (self._next + 1) % len(self._items)
        return item


def _swept(tape, sweep):
    return sweep() if tape is None else tape.take(sweep)


def _cull_mask(origins, dirs, geometry):
    """(R,T) bool pair mask from the scene's acceleration data, or None:
    the per-object slab test (gpu/hit.cu:96-101) and, with an octree, the
    top-down walk of its node graph (`octree_object_reach`). Meant to be
    conservative (a culled object holds no accepted hit), and equal to the
    JAX package's mask; the slab test rounds, though, so a hit that lies
    exactly on its object's box can be culled, there as here."""
    if geometry.obj_aabb is None:
        return None
    from raytracing_gpu_tpu_torch.partition.aabb import hit_aabb

    ohit = hit_aabb(origins, dirs, geometry.obj_aabb)  # (R,O)
    if geometry.octree is not None:
        from raytracing_gpu_tpu_torch.partition.octree import octree_object_reach

        ohit &= octree_object_reach(origins, dirs, geometry.octree)
    return ohit[:, geometry.tri_obj.long()]


def _mt_core(origins, dirs, geometry, mt_eps, self_hit_eps):
    """All-pairs Möller–Trumbore over the scene's (T,3,3) soup in file
    order: (R,T) distances, +inf where the pair is rejected, invalid or
    culled."""
    vertices = geometry.vertices
    v0 = vertices[:, 0]
    dist = ck.mt_pairs(origins, dirs, v0, vertices[:, 1] - v0,
                       vertices[:, 2] - v0, mt_eps, self_hit_eps)[0]
    keep = geometry.valid[None, :]
    pair_mask = _cull_mask(origins, dirs, geometry)
    if pair_mask is not None:
        keep = keep & pair_mask
    return torch.where(keep, dist, INF)


def _ray_blocks(R: int, T: int):
    rb = max(1, _PAIRS_PER_BLOCK // max(T, 1))
    return [(r0, min(r0 + rb, R)) for r0 in range(0, R, rb)]


def _winner_uvt_from(origins, dirs, v0, edge1, edge2, mt_eps):
    """Möller–Trumbore on each ray's winning triangle only, with the same
    rounding order as the sweeps, so u/v/t are bit-identical to theirs."""
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    e1x, e1y, e1z = edge1[:, 0], edge1[:, 1], edge1[:, 2]
    e2x, e2y, e2z = edge2[:, 0], edge2[:, 1], edge2[:, 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = (e1x * hx + e1y * hy) + e1z * hz
    f = 1.0 / torch.where(a.abs() >= f32(mt_eps), a, 1.0)
    sx = origins[:, 0] - v0[:, 0]
    sy = origins[:, 1] - v0[:, 1]
    sz = origins[:, 2] - v0[:, 2]
    u = f * ((sx * hx + sy * hy) + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * ((dx * qx + dy * qy) + dz * qz)
    t = f * ((e2x * qx + e2y * qy) + e2z * qz)
    return u, v, t


def _dir_length(dirs):
    """(R,) |d| with left-associated squares, 1 for zero-length dirs."""
    d2 = (dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1]) + dirs[:, 2] * dirs[:, 2]
    return sqrt_rn(torch.where(d2 > 0.0, d2, 1.0))


def _count_tiles(tmask) -> None:
    """Into the recorder's counters: the (triangle tile, ray tile) pairs
    that a cull keeps for the sweep, and all of its pairs."""
    count("tile_pairs_kept", tmask)
    count("tile_pairs", tmask.numel())


@torch.no_grad()  # a sweep only selects
def _kernel_sweep(origins, dirs, pack, mt_eps, self_hit_eps, backend,
                  partitioning, want_idx: bool, f2b_tiles: int = 0):
    """Pack and cull a ray batch and sweep it on a kernel backend: (dist
    (Rp,) +inf on a miss, idx (Rp,) int32 clustered slots or None). On the
    card K1's and K5's pair has stride 2 (`ck.key_halves`), on the CPU it is
    contiguous: callers slice, test and pass them to `ck.fetch_rows`, which
    hold for either. Spans "cull" (the tile cull) and "sweep" (the listing
    and sweep kernels), the counters of the kept pair tiles
    (`_count_tiles`) and K1's and K2's of their (warp, unit) scans, inside
    the taped call: a tape's replay stamps and counts nothing."""
    op, dp, _ = ck.pack_rays(origins, dirs)
    if backend == "cuda_matmul":
        # Möller–Trumbore is translation invariant, and the expanded triple
        # products cancel badly when |o| is large against the local geometry:
        # recentre rays, boxes and triangles on the live rays' centroid. The
        # sweeps build their features from these themselves.
        c = ck.live_centroid(origins)
        oc = op - c[:, None]
        with annotate("cull"):
            tmask = ck.tile_cull_mask_hierarchical(
                oc, dp, pack._replace(tile_aabb=pack.tile_aabb - c), partitioning)
        _count_tiles(tmask)
        sweep = (oc, dp, pack.v0 - c, pack.e1, pack.e2, tmask, mt_eps,
                 self_hit_eps)
        with annotate("sweep"):
            if want_idx:
                return ck.nearest_hit_matmul(*sweep)
            return ck.nearest_dist_matmul(*sweep), None
    with annotate("cull"):
        tmask = ck.tile_cull_mask_hierarchical(op, dp, pack, partitioning)
    _count_tiles(tmask)
    sweep = (op, dp, pack.v0, pack.e1, pack.e2, tmask, mt_eps, self_hit_eps,
             pack.unit_aabb, pack.group_aabb)
    with annotate("sweep"):
        if not want_idx:
            return ck.nearest_dist(*sweep), None
        if (f2b_tiles > 0 and partitioning != "none"
                and tmask.shape[0] > 2 * f2b_tiles):
            return ck.nearest_hit_front_to_back(op, dp, pack, tmask, mt_eps,
                                                self_hit_eps, f2b_tiles)
        return ck.nearest_hit(*sweep)


@torch.no_grad()  # a sweep only selects
def _all_pairs_sweep(origins, dirs, geometry, mt_eps, self_hit_eps,
                     want_idx: bool):
    """Backend "torch"'s sweep: (minimum accepted distance (R,), +inf on a
    miss; its first triangle in file order (R,) int64, 0 on a miss, or
    None)."""
    dmin, win = [], []
    for r0, r1 in _ray_blocks(origins.shape[0], geometry.vertices.shape[0]):
        dist = _mt_core(origins[r0:r1], dirs[r0:r1], geometry, mt_eps,
                        self_hit_eps)
        if want_idx:
            d, w = ck.first_argmin(dist)
            win.append(w.long())
        else:
            d = dist.amin(1)
        dmin.append(d)
    return torch.cat(dmin), torch.cat(win) if want_idx else None


def _combine_shards(dist, rows, scene_group):
    """The nearest of every shard's winners: (distance (R,), row (R, C)) of
    the first shard attaining the minimum distance, from one gather whose
    backward returns each rank its own rows' cotangent."""
    from raytracing_gpu_tpu_torch.parallel import collectives

    R = dist.shape[0]
    g = collectives.all_gather(torch.cat([dist.detach()[:, None], rows], 1),
                               scene_group).reshape(-1, R, rows.shape[1] + 1)
    dmin, shard = ck.first_argmin(g[:, :, 0].detach().t())
    return dmin, g[shard.long(), torch.arange(R, device=rows.device), 1:]


def collide(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
            backend: str = "torch", pack=None,
            partitioning: str = "octree", f2b_tiles: int = 0,
            tape: SweepTape | None = None, scene_group=None) -> Hit:
    """Nearest hit over all triangles (cpu/hit.c:72-91). Differentiable:
    the winner is discrete, its point, normal and distance carry gradient
    to the rays and to the winner's geometry (and materials, `Hit.mat`,
    when no `scene_group` shards the triangles)."""
    R = origins.shape[0]
    mat = None
    if backend in KERNEL_BACKENDS:
        if pack is None or pack.table is None:  # collide needs the winner table
            pack = ck.pack_geometry(geometry.vertices, geometry.valid,
                                    geometry.normals, geometry.tri_obj)
        sweep_dist, idx = _swept(tape, lambda: _kernel_sweep(
            origins, dirs, pack, mt_eps, self_hit_eps, backend, partitioning,
            True, f2b_tiles))
        with annotate("sweep"):  # K3's fetch of the winners' rows
            rows = ck.fetch_rows(pack.table, idx[:R])
        sweep_dist = sweep_dist[:R]
        if scene_group is not None:
            sweep_dist, rows = _combine_shards(sweep_dist, rows, scene_group)
        elif rows.shape[1] == ck.TABLE_WIDTH_MAT:
            mat = rows[:, ck.COL_MAT]
        v0, e1, e2 = rows[:, ck.COL_V0], rows[:, ck.COL_E1], rows[:, ck.COL_E2]
        tri_n = rows[:, ck.COL_N].reshape(R, 3, 3)
        obj = rows[:, ck.COL_OBJ].to(torch.int32)
        # acceptance comes from the sweep (a miss leaves slot 0 and +inf)
        mask = torch.isfinite(sweep_dist)
    elif backend == "torch":
        dmin, win = _swept(tape, lambda: _all_pairs_sweep(
            origins, dirs, geometry, mt_eps, self_hit_eps, True))
        tri = geometry.vertices[win]
        tri_n = geometry.normals[win]
        obj = geometry.tri_obj[win]
        if scene_group is not None:
            rows = torch.cat([tri.reshape(R, 9), tri_n.reshape(R, 9),
                              obj.to(torch.float32)[:, None]], 1)
            dmin, rows = _combine_shards(dmin, rows, scene_group)
            tri, tri_n = rows[:, :9].reshape(R, 3, 3), rows[:, 9:18].reshape(R, 3, 3)
            obj = rows[:, 18].to(torch.int32)
        v0 = tri[:, 0]
        e1, e2 = tri[:, 1] - v0, tri[:, 2] - v0
        mask = torch.isfinite(dmin)
    else:
        raise ValueError(f"bad backend {backend!r}")

    wu, wv, wt = _winner_uvt_from(origins, dirs, v0, e1, e2, mt_eps)
    # reference distance |fl(o + nd*(t*|d|)) - o| (cpu/hit.c:36-38,57), the
    # sweep's own chain, so a winner's distance is the one it won by
    dlen = _dir_length(dirs)
    td = wt * dlen
    p = [(origins[:, k] + (dirs[:, k] / dlen) * td) - origins[:, k]
         for k in range(3)]
    wdist = sqrt_rn((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2])

    # hit point: origin + normalize(dir) * (t*|dir|)  (cpu/hit.c:36-38)
    point = origins + (dirs / dlen[:, None]) * (wt[:, None] * dlen[:, None])
    # smooth normal: per-vertex normalize, then barycentric interpolation,
    # never renormalized (cpu/hit.c:10-12, 38-40)
    n2 = ((tri_n[..., 0] * tri_n[..., 0] + tri_n[..., 1] * tri_n[..., 1])
          + tri_n[..., 2] * tri_n[..., 2])[..., None]
    nn = tri_n / sqrt_rn(torch.where(n2 > 0.0, n2, 1.0))
    normal = ((nn[:, 0] * (1.0 - wu - wv)[:, None] + nn[:, 1] * wu[:, None])
              + nn[:, 2] * wv[:, None])
    # a zero interpolated normal counts as a miss (cpu/hit.c:79)
    mask = mask & (normal != 0.0).any(-1)
    return Hit(point=point, normal=normal, obj=obj,
               dist=torch.where(mask, wdist, INF), mask=mask, mat=mat)


def collide_dist(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
                 backend: str = "torch", pack=None, partitioning: str = "octree",
                 tape: SweepTape | None = None, scene_group=None):
    """Nearest accepted distance per ray, 0.0 on a miss (cpu/hit.c:93-109),
    the minimum over the shards of `scene_group`. The kernel backends'
    K2/K6 return t*|d|; shadows read only `!= 0`, so no gradient flows
    through it."""
    R = origins.shape[0]
    if backend in KERNEL_BACKENDS:
        if pack is None:
            pack = ck.pack_geometry(geometry.vertices, geometry.valid)
        m = _swept(tape, lambda: _kernel_sweep(
            origins, dirs, pack, mt_eps, self_hit_eps, backend, partitioning,
            False)[0])[:R]
    elif backend == "torch":
        m = _swept(tape, lambda: _all_pairs_sweep(
            origins, dirs, geometry, mt_eps, self_hit_eps, False)[0])
    else:
        raise ValueError(f"bad backend {backend!r}")
    if scene_group is not None:
        from raytracing_gpu_tpu_torch.parallel import collectives

        m = collectives.all_reduce(m, collectives.MIN, scene_group)
    return torch.where(torch.isfinite(m), m, 0.0)


@torch.no_grad()
def _any_hit_sweep(origins, dirs, pack, mt_eps, self_hit_eps, partitioning):
    op, dp, R = ck.pack_rays(origins, dirs)
    with annotate("cull"):
        tmask = ck.tile_cull_mask_hierarchical(op, dp, pack, partitioning)
    _count_tiles(tmask)
    with annotate("sweep"):
        return ck.any_hit(op, dp, pack.v0, pack.e1, pack.e2, tmask, mt_eps,
                          self_hit_eps, pack.unit_aabb, pack.group_aabb)[:R]


def collide_any(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
                backend: str = "torch", pack=None, partitioning: str = "octree",
                any_hit_min_tris: int = ANY_HIT_OFF,
                tape: SweepTape | None = None, scene_group=None):
    """(R,) bool: any accepted hit — what the shadow test reads
    (`has_direct_hit`, cpu/light.c:24-31, occludes on any hit; its distance
    comparison is dead code). On backend "cuda", a scene of at least
    `any_hit_min_tris` (padded) triangles goes through the any-hit sweep K4,
    whose ray tiles stop once every live lane is occluded; everything else
    is `collide_dist != 0`, the same boolean by construction. The default
    threshold keeps K4 off, as the JAX package's ANY_HIT_MIN_TRIS does.
    Under a `scene_group` a ray is occluded if it is on some shard."""
    if backend == "cuda" and geometry.vertices.shape[0] >= any_hit_min_tris:
        if pack is None:
            pack = ck.pack_geometry(geometry.vertices, geometry.valid)
        occ = _swept(tape, lambda: _any_hit_sweep(
            origins, dirs, pack, mt_eps, self_hit_eps, partitioning))
        if scene_group is not None:
            from raytracing_gpu_tpu_torch.parallel import collectives

            occ = collectives.all_reduce(occ, collectives.MAX, scene_group)
        return occ
    return collide_dist(origins, dirs, geometry, mt_eps, self_hit_eps,
                        backend, pack, partitioning, tape, scene_group) != 0.0
