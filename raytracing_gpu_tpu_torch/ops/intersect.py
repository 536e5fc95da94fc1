"""Nearest-hit and shadow intersection on three backends.

The JAX package's `ops/intersect.py`: `collide` is the reference's `collide`
(cpu/hit.c:72-91), nearest accepted hit with first-occurrence ties;
`collide_dist` its distance-only twin for shadow rays (cpu/hit.c:93-109),
0.0 on a miss; `collide_any` the boolean the shadow test actually reads.

- backend "torch": all-pairs Möller–Trumbore over the scene in file order
  (`_mt_core`), in ray blocks so memory stays bounded. It is the port's
  CPU-runnable reference; the JAX package's object-level cull feeds only its
  jnp path and is conservative, so this backend is brute force.
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
"""

from __future__ import annotations

import dataclasses

import torch

from raytracing_gpu_tpu_torch.config import ANY_HIT_OFF
from raytracing_gpu_tpu_torch.ops import cuda_intersect as ck
from raytracing_gpu_tpu_torch.ops.fp import f32, sqrt_rn

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


def _mt_core(origins, dirs, vertices, valid, mt_eps, self_hit_eps):
    """All-pairs Möller–Trumbore over a (T,3,3) soup in file order:
    (dist, u, v, t), each (R,T), dist +inf where rejected or invalid."""
    v0 = vertices[:, 0]
    dist, u, v, t = ck.mt_pairs(origins, dirs, v0, vertices[:, 1] - v0,
                                vertices[:, 2] - v0, mt_eps, self_hit_eps)
    return torch.where(valid[None, :], dist, INF), u, v, t


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


@torch.no_grad()  # a sweep only selects
def _kernel_sweep(origins, dirs, pack, mt_eps, self_hit_eps, backend,
                  partitioning, want_idx: bool, f2b_tiles: int = 0):
    """Pack and cull a ray batch and sweep it on a kernel backend: (dist
    (Rp,) +inf on a miss, idx (Rp,) int32 clustered slots or None). K1's
    pair on the card has stride 2 (`ck.key_halves`), the matmul backend's is
    contiguous: callers slice, test and pass them to `ck.fetch_rows`, which
    hold for either."""
    op, dp, _ = ck.pack_rays(origins, dirs)
    if backend == "cuda_matmul":
        # Möller–Trumbore is translation invariant, and the expanded triple
        # products cancel badly when |o| is large against the local geometry:
        # recentre rays, boxes and triangles on the live rays' centroid
        c = ck.live_centroid(origins)
        oc = op - c[:, None]
        tmask = ck.tile_cull_mask_hierarchical(
            oc, dp, pack._replace(tile_aabb=pack.tile_aabb - c), partitioning)
        rayf = ck.ray_features(oc, dp)
        g = ck.pack_tri_features(pack.v0 - c, pack.e1, pack.e2)
        if want_idx:
            return ck.nearest_hit_matmul(rayf, g, tmask, mt_eps, self_hit_eps)
        return ck.nearest_dist_matmul(rayf, g, tmask, mt_eps, self_hit_eps), None
    tmask = ck.tile_cull_mask_hierarchical(op, dp, pack, partitioning)
    sweep = (op, dp, pack.v0, pack.e1, pack.e2, tmask, mt_eps, self_hit_eps)
    if not want_idx:
        return ck.nearest_dist(*sweep), None
    if (f2b_tiles > 0 and partitioning != "none"
            and tmask.shape[0] > 2 * f2b_tiles):
        return ck.nearest_hit_front_to_back(op, dp, pack, tmask, mt_eps,
                                            self_hit_eps, f2b_tiles)
    return ck.nearest_hit(*sweep)


def collide(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
            backend: str = "torch", pack=None,
            partitioning: str = "octree", f2b_tiles: int = 0) -> Hit:
    """Nearest hit over all triangles (cpu/hit.c:72-91)."""
    R = origins.shape[0]
    dlen = _dir_length(dirs)
    mat = None
    if backend in KERNEL_BACKENDS:
        if pack is None or pack.table is None:  # collide needs the winner table
            pack = ck.pack_geometry(geometry.vertices, geometry.valid,
                                    geometry.normals, geometry.tri_obj)
        sweep_dist, idx = _kernel_sweep(origins, dirs, pack, mt_eps,
                                        self_hit_eps, backend, partitioning,
                                        True, f2b_tiles)
        rows = ck.fetch_rows(pack.table, idx[:R])
        tri_n = rows[:, ck.COL_N].reshape(R, 3, 3)
        obj = rows[:, ck.COL_OBJ].to(torch.int32)
        if rows.shape[1] == ck.TABLE_WIDTH_MAT:
            mat = rows[:, ck.COL_MAT]
        wu, wv, wt = _winner_uvt_from(origins, dirs, rows[:, ck.COL_V0],
                                      rows[:, ck.COL_E1], rows[:, ck.COL_E2],
                                      mt_eps)
        # reference distance |fl(o + nd*(t*|d|)) - o| (cpu/hit.c:36-38,57),
        # the sweep's own chain, so a winner's distance is the one it won by
        td = wt * dlen
        p = [(origins[:, k] + (dirs[:, k] / dlen) * td) - origins[:, k]
             for k in range(3)]
        wdist = sqrt_rn((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2])
        # acceptance comes from the sweep (a miss leaves slot 0 and +inf)
        mask = torch.isfinite(sweep_dist[:R])
    elif backend == "torch":
        wdist, wu, wv, wt = (origins.new_empty((R,)) for _k in range(4))
        win = torch.empty((R,), dtype=torch.int64, device=origins.device)
        for r0, r1 in _ray_blocks(R, geometry.vertices.shape[0]):
            dist, u, v, t = _mt_core(origins[r0:r1], dirs[r0:r1],
                                     geometry.vertices, geometry.valid,
                                     mt_eps, self_hit_eps)
            wd, w = ck.first_argmin(dist)
            w = w.long()[:, None]
            wdist[r0:r1] = wd
            win[r0:r1] = w[:, 0]
            wu[r0:r1] = u.gather(1, w)[:, 0]
            wv[r0:r1] = v.gather(1, w)[:, 0]
            wt[r0:r1] = t.gather(1, w)[:, 0]
        mask = torch.isfinite(wdist)
        tri_n = geometry.normals[win]
        obj = geometry.tri_obj[win]
    else:
        raise ValueError(f"bad backend {backend!r}")

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
                 backend: str = "torch", pack=None, partitioning: str = "octree"):
    """Nearest accepted distance per ray, 0.0 on a miss (cpu/hit.c:93-109).
    The kernel backends' K2/K6 return t*|d|; shadows read only `!= 0`."""
    R = origins.shape[0]
    with torch.no_grad():
        if backend in KERNEL_BACKENDS:
            if pack is None:
                pack = ck.pack_geometry(geometry.vertices, geometry.valid)
            m = _kernel_sweep(origins, dirs, pack, mt_eps, self_hit_eps,
                              backend, partitioning, False)[0][:R]
        elif backend == "torch":
            m = origins.new_empty((R,))
            for r0, r1 in _ray_blocks(R, geometry.vertices.shape[0]):
                m[r0:r1] = _mt_core(origins[r0:r1], dirs[r0:r1],
                                    geometry.vertices, geometry.valid,
                                    mt_eps, self_hit_eps)[0].amin(1)
        else:
            raise ValueError(f"bad backend {backend!r}")
    return torch.where(torch.isfinite(m), m, 0.0)


def collide_any(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
                backend: str = "torch", pack=None, partitioning: str = "octree",
                any_hit_min_tris: int = ANY_HIT_OFF):
    """(R,) bool: any accepted hit — what the shadow test reads
    (`has_direct_hit`, cpu/light.c:24-31, occludes on any hit; its distance
    comparison is dead code). On backend "cuda", a scene of at least
    `any_hit_min_tris` (padded) triangles goes through the any-hit sweep K4,
    whose ray tiles stop once every live lane is occluded; everything else
    is `collide_dist != 0`, the same boolean by construction. The default
    threshold keeps K4 off, as the JAX package's ANY_HIT_MIN_TRIS does."""
    if backend == "cuda" and geometry.vertices.shape[0] >= any_hit_min_tris:
        if pack is None:
            pack = ck.pack_geometry(geometry.vertices, geometry.valid)
        with torch.no_grad():
            op, dp, R = ck.pack_rays(origins, dirs)
            tmask = ck.tile_cull_mask_hierarchical(op, dp, pack, partitioning)
            return ck.any_hit(op, dp, pack.v0, pack.e1, pack.e2, tmask,
                              mt_eps, self_hit_eps)[:R]
    return collide_dist(origins, dirs, geometry, mt_eps, self_hit_eps,
                        backend, pack, partitioning) != 0.0
