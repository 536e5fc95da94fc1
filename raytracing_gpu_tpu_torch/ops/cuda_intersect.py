"""Kernel path of the intersection: packing, tile culling and the six
hand-written CUDA kernels, each beside its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_intersect.py`:

- `pack_geometry` clusters the triangles into 256-triangle tiles in morton
  order of their centroids (`cluster_triangles`) and builds the v0/e1/e2
  planes and the 24/32-wide winner table, once per render;
- `tile_cull_mask_hierarchical` turns a batch of rays (packed in 256-ray
  tiles by `pack_rays`) into an (nT, nR) mask of (triangle tile, ray tile)
  pairs that may hold a hit: brute force, flat per-ray slab tests, or the
  coarse-to-fine union-box hierarchy with interval tests below the top;
- `nearest_hit` (K1), `nearest_dist` (K2), `fetch_rows` (K3), `any_hit` (K4),
  `nearest_hit_matmul` (K5) and `nearest_dist_matmul` (K6) launch the
  kernels of `csrc/intersect.cu` on CUDA tensors. On CPU tensors they run
  their plain versions, so every step around the kernels runs in the CPU
  tests; on a CUDA tensor a wrapper launches its kernel or raises. K1/K2
  read the pair-tile mask themselves, spread the kept pair tiles over the
  whole card and combine the pieces by the minimum of `sweep_key`; K4-K6
  walk an ordered `tile_worklist` per ray tile;
- `nearest_hit_front_to_back` is the two-round composite over K1 (nearest
  triangle tiles first, then only those a hit so far cannot rule out);
- `ray_features` / `pack_tri_features` pack rays and triangles for the
  matmul-form sweeps K5/K6, which compute the four Möller–Trumbore
  determinants as dot products of 16 features.

Every integer result (perm, masks, worklists, winner slots) equals the JAX
package's. The distances equal the JAX package's eager (op-by-op)
evaluation bit for bit, since both evaluate the same unfused float32
operations in the same order; under jit XLA:CPU contracts multiply-adds into
FMAs, so the Pallas kernels in interpret mode differ by a few ulp. The
matmul-form sweeps are the exception: their dot products are summed in a
fixed left-to-right order that no XLA matmul promises, so against the JAX
package they are held to a tolerance (as that package holds its own matmul
backend to one); kernel and plain version still agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from raytracing_gpu_tpu_torch.ops.fp import f32, sqrt_rn

TILE_R = 256
TILE_T = 256
INF = float("inf")
_THIRD = float(np.float32(1.0 / 3.0))  # XLA's mean divides by 3 as * f32(1/3)

# Launch counts of the kernels, by wrapper name. A wrapper adds one exactly
# where it launches its kernel (never on its plain path), so a run can show
# that the main path went through the kernels.
LAUNCHES = {"nearest_hit": 0, "nearest_dist": 0, "fetch_rows": 0,
            "any_hit": 0, "nearest_hit_matmul": 0, "nearest_dist_matmul": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


class KernelPack(NamedTuple):
    """Per-scene packing for the kernel path, built once per render."""

    perm: torch.Tensor           # (T,) int32 clustered slot -> original triangle
    tile_aabb: torch.Tensor      # (nT, 2, 3) per-tile box (clustered order)
    tile_nonempty: torch.Tensor  # (nT,) bool
    v0: torch.Tensor             # (Tp, 3) clustered, padded
    e1: torch.Tensor             # (Tp, 3)
    e2: torch.Tensor             # (Tp, 3)
    table: torch.Tensor | None   # (Tp, 24|32) winner rows: v0 e1 e2 n0 n1 n2
    #                              obj [ka kd ks ns nr] (see COL_*)


COL_V0 = slice(0, 3)
COL_E1 = slice(3, 6)
COL_E2 = slice(6, 9)
COL_N = slice(9, 18)
COL_OBJ = 18
COL_MAT = slice(19, 30)  # ka(3) kd(3) ks(3) ns(1) nr(1) — 32-wide tables only
TABLE_WIDTH_MAT = 32
TABLE_WIDTH_NOMAT = 24


def pack_triangles(vertices, valid):
    """(T,3,3) soup -> (Tp,3) v0/e1/e2 padded to TILE_T; invalid and padding
    rows get zero edges, which the determinant test rejects."""
    T = vertices.shape[0]
    pad = (-T) % TILE_T
    v0 = vertices[:, 0]
    e1 = torch.where(valid[:, None], vertices[:, 1] - v0, 0.0)
    e2 = torch.where(valid[:, None], vertices[:, 2] - v0, 0.0)
    if pad:
        z = v0.new_zeros((pad, 3))
        v0, e1, e2 = (torch.cat([a, z]) for a in (v0, e1, e2))
    return v0.contiguous(), e1.contiguous(), e2.contiguous()


def pack_rays(origins, dirs):
    """(R,3) -> (3,Rp) planes padded to TILE_R; padded rays start far outside
    any scene with direction (0,0,1) and miss everything."""
    R = origins.shape[0]
    pad = (-R) % TILE_R
    if pad:
        origins = torch.cat([origins, origins.new_full((pad, 3), 1e30)])
        tail = dirs.new_zeros((pad, 3))
        tail[:, 2] = 1.0
        dirs = torch.cat([dirs, tail])
    return origins.t().contiguous(), dirs.t().contiguous(), R


def centroids(vertices):
    """(T,3,3) -> (T,3) triangle centroids, rounded as the JAX package's
    `vertices.mean(axis=1)`: ((v0 + v1) + v2) * f32(1/3)."""
    return ((vertices[:, 0] + vertices[:, 1]) + vertices[:, 2]) * _THIRD


def cluster_triangles(vertices, valid):
    """Morton-cluster the triangles into TILE_T-sized tiles.

    Returns (perm (T,) int32 — clustered slot -> original triangle, invalid
    triangles last; tile_aabb (nT,2,3); tile_nonempty (nT,) bool). One ulp
    of a centroid can move a morton cell and change perm, and with it the
    kernels' tie-break order, hence `centroids`. Keys are int64 with
    0xFFFFFFFF for invalid triangles, sorted stably like JAX's uint32 keys.
    """
    T = vertices.shape[0]
    centroid = centroids(vertices)
    vmin = torch.where(valid[:, None],
                       torch.where(valid[:, None, None], vertices, INF).amin(1), INF)
    vmax = torch.where(valid[:, None],
                       torch.where(valid[:, None, None], vertices, -INF).amax(1), -INF)
    smin = vmin.amin(0)
    smax = vmax.amax(0)
    size = torch.where(smax - smin > 0.0, smax - smin, 1.0)
    q = torch.clamp(torch.floor((centroid - smin) / size * 256.0), 0, 255).to(torch.int64)
    morton = torch.zeros((T,), dtype=torch.int64, device=vertices.device)
    for b in range(8):
        grp = ((((q[:, 0] >> b) & 1) << 2) | (((q[:, 1] >> b) & 1) << 1)
               | ((q[:, 2] >> b) & 1))
        morton = morton | (grp << (3 * b))
    keys = torch.where(valid, morton, 0xFFFFFFFF)
    perm = torch.argsort(keys, stable=True)

    pad = (-T) % TILE_T
    nT = (T + pad) // TILE_T
    svmin, svmax, sval = vmin[perm], vmax[perm], valid[perm]
    if pad:
        svmin = torch.cat([svmin, svmin.new_full((pad, 3), INF)])
        svmax = torch.cat([svmax, svmax.new_full((pad, 3), -INF)])
        sval = torch.cat([sval, sval.new_zeros((pad,))])
    tmin = svmin.reshape(nT, TILE_T, 3).amin(1)
    tmax = svmax.reshape(nT, TILE_T, 3).amax(1)
    tile_nonempty = sval.reshape(nT, TILE_T).any(1)
    # empty tiles: a point box keeps the slab test NaN-free; they are masked
    # off through tile_nonempty anyway
    tmin = torch.where(tile_nonempty[:, None], tmin, 0.0)
    tmax = torch.where(tile_nonempty[:, None], tmax, 0.0)
    return perm.to(torch.int32), torch.stack([tmin, tmax], 1), tile_nonempty


def pack_geometry(vertices, valid, normals=None, tri_obj=None,
                  materials=None) -> KernelPack:
    """Cluster and pack a triangle soup for the kernels. With normals and
    tri_obj the winner table is built too (collide needs it); with
    `materials` the owning object's ka/kd/ks/ns/nr ride along in columns
    19-29, so collide returns them with the same fetch."""
    perm, tile_aabb, tile_nonempty = cluster_triangles(vertices, valid)
    p = perm.long()
    v0, e1, e2 = pack_triangles(vertices[p], valid[p])
    table = None
    if normals is not None and tri_obj is not None:
        Tp, T = v0.shape[0], normals.shape[0]
        cols = [normals[p].reshape(T, 9), tri_obj[p].to(torch.float32)[:, None]]
        width = TABLE_WIDTH_NOMAT
        if materials is not None:
            mat = torch.cat([materials.ka, materials.kd, materials.ks,
                             materials.ns[:, None], materials.nr[:, None]], 1)
            cols.append(mat[tri_obj[p].long()])
            width = TABLE_WIDTH_MAT
        body = torch.cat(cols, 1)
        if Tp > T:
            body = torch.cat([body, body.new_zeros((Tp - T, body.shape[1]))])
        table = torch.cat([v0, e1, e2, body], 1)
        table = torch.cat([table, table.new_zeros((Tp, width - table.shape[1]))], 1)
    return KernelPack(perm, tile_aabb, tile_nonempty, v0, e1, e2,
                      None if table is None else table.contiguous())


# ---------------------------------------------------------------------------
# Tile culling
# ---------------------------------------------------------------------------


def _slab_hits_packed(op, dp, boxes):
    """(nB, Rp) bool forward-only slab test of packed rays against boxes.
    Zero direction components use a 1e-30 stand-in; parked rays (origin
    3e29) miss every box."""
    inv = 1.0 / torch.where(dp == 0.0, 1e-30, dp)  # (3, Rp)
    tmin = op.new_full((boxes.shape[0], op.shape[1]), -INF)
    tmax = op.new_full((boxes.shape[0], op.shape[1]), INF)
    for k in range(3):
        t1 = (boxes[:, 0, k][:, None] - op[k][None, :]) * inv[k][None, :]
        t2 = (boxes[:, 1, k][:, None] - op[k][None, :]) * inv[k][None, :]
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return (tmax >= tmin) & (tmax >= 0.0)


def tile_cull_mask_packed(op, dp, tile_aabb, tile_nonempty):
    """(nB, nR) int32 pair-tile mask from exact per-ray slab tests."""
    nr = op.shape[1] // TILE_R
    hit = _slab_hits_packed(op, dp, tile_aabb) & tile_nonempty[:, None]
    return hit.reshape(tile_aabb.shape[0], nr, TILE_R).any(2).to(torch.int32)


def ray_tile_intervals(op, dp):
    """Per-ray-tile bounds over live rays: (olo, ohi, dlo, dhi) each (3, nR),
    and any_live (nR,). Parked rays (|origin| >= 1e20) are left out; a tile
    of parked rays only reports any_live False."""
    nr = op.shape[1] // TILE_R
    o = op.reshape(3, nr, TILE_R)
    d = dp.reshape(3, nr, TILE_R)
    live = (o.abs() < 1e20).all(0)[None]  # (1, nr, TILE_R)
    olo = torch.where(live, o, INF).amin(2)
    ohi = torch.where(live, o, -INF).amax(2)
    dlo = torch.where(live, d, INF).amin(2)
    dhi = torch.where(live, d, -INF).amax(2)
    return olo, ohi, dlo, dhi, live[0].any(1)


def _interval_slab(op, dp, boxes, nonempty):
    """((nB, nR) bool hit, (nB, nR) float32 tlo). hit: could SOME live ray of
    the ray tile hit the box? An interval slab test of the tile's origin box
    x direction box, with sound division (a direction interval spanning 0
    leaves its axis open). tlo: a sound lower bound (>= 0) on the slab-entry
    parameter of any live ray of the tile, in units of the unnormalised
    direction."""
    olo, ohi, dlo, dhi, any_live = ray_tile_intervals(op, dp)
    nB, nr = boxes.shape[0], olo.shape[1]
    tlo = op.new_full((nB, nr), -INF)
    thi = op.new_full((nB, nr), INF)
    for k in range(3):
        spans0 = ((dlo[k] <= 0.0) & (dhi[k] >= 0.0))[None, :]
        ilo = (1.0 / torch.where(dhi[k] == 0.0, -1e-30, dhi[k]))[None, :]
        ihi = (1.0 / torch.where(dlo[k] == 0.0, 1e-30, dlo[k]))[None, :]
        lo_b = boxes[:, 0, k][:, None]
        hi_b = boxes[:, 1, k][:, None]
        nums = (lo_b - ohi[k][None, :], lo_b - olo[k][None, :],
                hi_b - ohi[k][None, :], hi_b - olo[k][None, :])
        cand = [n * i for n in nums for i in (ilo, ihi)]
        lo_k = functools.reduce(torch.minimum, cand)
        hi_k = functools.reduce(torch.maximum, cand)
        tlo = torch.maximum(tlo, torch.where(spans0, -INF, lo_k))
        thi = torch.minimum(thi, torch.where(spans0, INF, hi_k))
    hit = (thi >= tlo) & (thi >= 0.0)
    return hit & nonempty[:, None] & any_live[None, :], tlo.clamp(min=0.0)


def tile_entry_lower(op, dp, boxes, nonempty):
    """(nB, nR) float32 sound lower bound on the distance (t*|d|) at which
    any live ray of a ray tile can first touch a box; +inf where the pair is
    culled. The slab bound times the tile's smallest |d|, with a 1e-3
    relative slack against the rounding differences between the slab
    arithmetic and the sweeps' distance chain."""
    hit, tlo = _interval_slab(op, dp, boxes, nonempty)
    nr = op.shape[1] // TILE_R
    d2 = ((dp[0] * dp[0] + dp[1] * dp[1]) + dp[2] * dp[2]).reshape(nr, TILE_R)
    live = live_rays(op).reshape(nr, TILE_R)
    dmin = sqrt_rn(torch.where(live, d2, INF).amin(1))
    dmin = torch.where(torch.isfinite(dmin), dmin, 1.0)
    return torch.where(hit, tlo * dmin[None, :] * 0.999, INF)


def build_tile_levels(tile_aabb, tile_nonempty, branching: int = 8,
                      top_max: int = 64):
    """Union-box hierarchy over the morton-ordered leaf tiles, coarse to
    fine, leaf level excluded; empty when nT <= top_max."""
    levels = []
    boxes, nonempty = tile_aabb, tile_nonempty
    while boxes.shape[0] > top_max:
        pad = (-boxes.shape[0]) % branching
        if pad:
            empty = boxes.new_tensor([[INF] * 3, [-INF] * 3])  # union-neutral
            boxes = torch.cat([boxes, empty.expand(pad, 2, 3)])
            nonempty = torch.cat([nonempty, nonempty.new_zeros((pad,))])
        g = boxes.reshape(-1, branching, 2, 3)
        boxes = torch.stack([g[:, :, 0].amin(1), g[:, :, 1].amax(1)], 1)
        nonempty = nonempty.reshape(-1, branching).any(1)
        boxes = torch.where(nonempty[:, None, None], boxes, 0.0)
        levels.append((boxes, nonempty))
    return levels[::-1]


def tile_cull_mask_hierarchical(op, dp, pack: KernelPack, partitioning: str):
    """(nT, nR) int32 pair-tile mask for a partitioning mode: "none" all
    ones; "aabb" exact per-ray tests against every leaf box; "octree" exact
    tests against the top level (<= 64 union boxes) and interval tests below,
    each level ANDed with its parent. Conservative in every mode."""
    nT = pack.tile_aabb.shape[0]
    nr = op.shape[1] // TILE_R
    if partitioning == "none":
        return torch.ones((nT, nr), dtype=torch.int32, device=op.device)
    if partitioning == "aabb" or nT <= 64:
        return tile_cull_mask_packed(op, dp, pack.tile_aabb, pack.tile_nonempty)
    levels = build_tile_levels(pack.tile_aabb, pack.tile_nonempty)
    mask = tile_cull_mask_packed(op, dp, *levels[0])
    for boxes, nonempty in levels[1:] + [(pack.tile_aabb, pack.tile_nonempty)]:
        child = _interval_slab(op, dp, boxes, nonempty)[0].to(torch.int32)
        mask = child * torch.repeat_interleave(mask, 8, dim=0)[:boxes.shape[0]]
    return mask


def tile_worklist(tile_mask):
    """(n, m) pair-tile mask -> (order (n, m) int32, count (n,) int32): per
    row, the active column indices in ascending order, the tail filled with
    the last active one (column 0 when none)."""
    active = tile_mask > 0
    count = active.sum(1, dtype=torch.int32)
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    last = torch.gather(order, 1, (count.long() - 1).clamp(min=0)[:, None])
    k = torch.arange(order.shape[1], device=order.device)[None, :]
    order = torch.where(k < count.clamp(min=1)[:, None].long(), order, last)
    return order.to(torch.int32), count


# ---------------------------------------------------------------------------
# Möller–Trumbore (the arithmetic of the kernels and of their plain versions)
# ---------------------------------------------------------------------------


def mt_pairs(o, d, v0, e1, e2, mt_eps, self_hit_eps, ref_dist: bool = True):
    """All (ray, triangle) pairs: o, d (R,3); v0, e1, e2 (T,3) ->
    (dist, u, v, t), each (R,T), dist +inf where the pair is rejected.

    The JAX package's `_mt_core` / `_mt_tile` operation for operation, with
    left-associated dots (cpu/hit.c:4-70). ref_dist=True selects the
    reference's winner distance |fl(o + nd*(t*|d|)) - o|; False t*|d|."""
    mt_eps, self_hit_eps = f32(mt_eps), f32(self_hit_eps)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # (R,1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]  # (T,)
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = (e1x * hx + e1y * hy) + e1z * hz
    ok = a.abs() >= mt_eps
    f = 1.0 / torch.where(ok, a, 1.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * ((sx * hx + sy * hy) + sz * hz)
    ok &= (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * ((dx * qx + dy * qy) + dz * qz)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * ((e2x * qx + e2y * qy) + e2z * qz)
    ok &= t > mt_eps
    dlen2 = (dx * dx + dy * dy) + dz * dz
    dlen = sqrt_rn(torch.where(dlen2 > 0.0, dlen2, 1.0))
    if ref_dist:
        td = t * dlen
        ddx = (ox + (dx / dlen) * td) - ox
        ddy = (oy + (dy / dlen) * td) - oy
        ddz = (oz + (dz / dlen) * td) - oz
        dist = sqrt_rn((ddx * ddx + ddy * ddy) + ddz * ddz)
    else:
        dist = t * dlen
    ok &= dist > self_hit_eps
    return torch.where(ok, dist, INF), u, v, t


def first_argmin(dist):
    """(R,T) -> (min (R,), lowest column index attaining it (R,) int32);
    column 0 where a row is all +inf."""
    dmin = dist.amin(1)
    cols = torch.arange(dist.shape[1], device=dist.device)
    idx = torch.where(dist == dmin[:, None], cols, dist.shape[1]).amin(1)
    return dmin, idx.to(torch.int32)


def sweep_key(dist, slot):
    """(dist float32 > 0 or +inf, slot int32 >= 0) -> int64 key
    (bits(dist) << 32) | slot. The bits of a positive float order as an
    integer, so the minimum key is (minimum distance, lowest slot among its
    ties): the combine K1 applies across blocks with one atomicMin per ray.
    A ray that never hit keeps `sweep_key(+inf, 0)`."""
    return (dist.view(torch.int32).to(torch.int64) << 32) | slot.to(torch.int64)


def split_key(key):
    """int64 key of `sweep_key` -> (dist float32, slot int32)."""
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


# pairs per block of the plain sweeps: bounds their (rays x triangles) memory
_PLAIN_PAIRS = 1 << 24


def _plain_sweep(pair_dist, Rp: int, Tp: int, tile_mask, fold: str):
    """Fold `pair_dist(r0, r1)` -- the (r1-r0, Tp) distances of a block of
    rays against every triangle, +inf where rejected -- over the pair tiles
    tile_mask keeps. fold "argmin": (min (Rp,), lowest slot (Rp,) int32);
    "min": the minimum; "any": (Rp,) bool, some pair accepted."""
    rb = max(TILE_R, (_PLAIN_PAIRS // Tp) // TILE_R * TILE_R)
    dev = tile_mask.device
    dist_out = torch.empty((Rp,), dtype=torch.float32, device=dev)
    idx_out = torch.empty((Rp,), dtype=torch.int32, device=dev)
    for r0 in range(0, Rp, rb):
        r1 = min(r0 + rb, Rp)
        keep = (tile_mask[:, r0 // TILE_R:r1 // TILE_R] > 0).t()
        keep = keep.repeat_interleave(TILE_R, 0).repeat_interleave(TILE_T, 1)
        dist = torch.where(keep, pair_dist(r0, r1), INF)
        if fold == "argmin":
            dist_out[r0:r1], idx_out[r0:r1] = first_argmin(dist)
        else:
            dist_out[r0:r1] = dist.amin(1)
    if fold == "argmin":
        return dist_out, idx_out
    return dist_out < INF if fold == "any" else dist_out


def _mt_sweep(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps, fold):
    def pair_dist(r0, r1):
        return mt_pairs(op[:, r0:r1].t(), dp[:, r0:r1].t(), v0, e1, e2,
                        mt_eps, self_hit_eps, ref_dist=fold == "argmin")[0]
    return _plain_sweep(pair_dist, op.shape[1], v0.shape[0], tile_mask, fold)


def nearest_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """Plain version of K1: all pairs of the masked tiles in ray blocks;
    (dist (Rp,) +inf on a miss, idx (Rp,) int32 clustered slot, 0 on a miss)."""
    return _mt_sweep(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
                     "argmin")


def nearest_dist_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """Plain version of K2: the masked minimum of t*|d| per ray."""
    return _mt_sweep(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps, "min")


def live_rays(op):
    """(Rp,) bool: rays that are neither parked nor padding (every origin
    component below 1e20 in magnitude)."""
    return (op.abs() < 1e20).all(0)


def any_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """Plain version of K4: (Rp,) bool, some pair of the masked tiles is
    accepted (K2's acceptance chain); False for dead rays."""
    return _mt_sweep(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
                     "any") & live_rays(op)


def fetch_rows_plain(table, idx):
    """Plain version of K3: table[idx]."""
    return table[idx.long()]


# ---------------------------------------------------------------------------
# Matmul form (K5/K6): Möller–Trumbore as dot products of 16 features
# ---------------------------------------------------------------------------

N_FEATURES = 16  # feature rows; 14 (rays) and 10 (triangles) are used


def ray_features(op, dp):
    """Packed (3, Rp) rays -> (16, Rp) feature planes: rows 0-2 d, 3-5
    m = o x d, 6-8 o, 9 ones, 10 |d|, 11-13 d/|d|, 14-15 zero."""
    ox, oy, oz = op[0], op[1], op[2]
    dx, dy, dz = dp[0], dp[1], dp[2]
    m = torch.stack([oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx])
    dlen2 = (dx * dx + dy * dy) + dz * dz
    dlen = sqrt_rn(torch.where(dlen2 > 0.0, dlen2, 1.0))[None, :]
    return torch.cat([dp, m, op, torch.ones_like(dlen), dlen, dp / dlen,
                      op.new_zeros((N_FEATURES - 14, op.shape[1]))]).contiguous()


def _cross(a, b):
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], 1)


def pack_tri_features(v0, e1, e2):
    """Padded (Tp,3) v0/e1/e2 -> (4, 16, Tp) feature planes [a; u_num; v_num;
    t_num], so that plane . ray features gives the four determinants:
    a = -n.d; u_num = -(e2 x v0).d + e2.m; v_num = -(v0 x e1).d - e1.m;
    t_num = n.o - v0.n, with n = e1 x e2. Rows 3-15 of plane 0, 6-15 of planes
    1-2 and 0-5, 10-15 of plane 3 are zero by construction; degenerate
    triangles (e1 = e2 = 0) give a = 0 and are rejected."""
    n = _cross(e1, e2)
    Tp = v0.shape[0]
    g = v0.new_zeros((4, Tp, N_FEATURES))
    g[0, :, 0:3] = -n
    g[1, :, 0:3] = -_cross(e2, v0)
    g[1, :, 3:6] = e2
    g[2, :, 0:3] = -_cross(v0, e1)
    g[2, :, 3:6] = -e1
    g[3, :, 6:9] = n
    vn = v0 * n
    g[3, :, 9] = -((vn[:, 0] + vn[:, 1]) + vn[:, 2])
    return g.permute(0, 2, 1).contiguous()


def live_centroid(origins):
    """(3,) mean origin of the live rays of an (R,3) batch (|o| < 1e20 on
    every axis; parked rays would blow it up), zero when none is live."""
    live = (origins.abs() < 1e20).all(-1)
    n_live = live.sum().to(origins.dtype).clamp(min=1.0)
    return torch.where(live[:, None], origins, 0.0).sum(0) / n_live


def _chain(g, f, rows):
    """Left-to-right sum over feature rows of g[row] (Tp,) * f[row] (R,1):
    the kernels' dot product, each multiply and add rounded on its own."""
    acc = g[rows[0]][None, :] * f[rows[0]][:, None]
    for k in rows[1:]:
        acc = acc + g[k][None, :] * f[k][:, None]
    return acc


def _matmul_pairs(f, g, mt_eps, self_hit_eps, ref_dist: bool):
    """All (ray, triangle) pairs in matmul form: f (16,R) ray features, g
    (4,16,Tp) triangle features -> (R,Tp) distances, +inf where rejected.
    The four products run over the rows that are not zero by construction,
    then the JAX package's `_mxu_tile` epilogue operation for operation."""
    mt_eps, self_hit_eps = f32(mt_eps), f32(self_hit_eps)
    a = _chain(g[0], f, (0, 1, 2))
    ok = a.abs() >= mt_eps
    inv = 1.0 / torch.where(ok, a, 1.0)
    u = _chain(g[1], f, (0, 1, 2, 3, 4, 5)) * inv
    ok &= (u >= 0.0) & (u <= 1.0)
    v = _chain(g[2], f, (0, 1, 2, 3, 4, 5)) * inv
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = _chain(g[3], f, (6, 7, 8, 9)) * inv
    ok &= t > mt_eps
    td = t * f[10][:, None]
    if ref_dist:  # |fl(o + nd*(t*|d|)) - o| from the recentred origin
        dd = [(f[6 + k][:, None] + f[11 + k][:, None] * td) - f[6 + k][:, None]
              for k in range(3)]
        dist = sqrt_rn((dd[0] * dd[0] + dd[1] * dd[1]) + dd[2] * dd[2])
    else:
        dist = td
    ok &= dist > self_hit_eps
    return torch.where(ok, dist, INF)


def _matmul_sweep(rayf, g, tile_mask, mt_eps, self_hit_eps, fold):
    def pair_dist(r0, r1):
        return _matmul_pairs(rayf[:, r0:r1], g, mt_eps, self_hit_eps,
                             ref_dist=fold == "argmin")
    return _plain_sweep(pair_dist, rayf.shape[1], g.shape[2], tile_mask, fold)


def nearest_hit_matmul_plain(rayf, g, tile_mask, mt_eps, self_hit_eps):
    """Plain version of K5: (dist (Rp,), idx (Rp,) int32) as K1's."""
    return _matmul_sweep(rayf, g, tile_mask, mt_eps, self_hit_eps, "argmin")


def nearest_dist_matmul_plain(rayf, g, tile_mask, mt_eps, self_hit_eps):
    """Plain version of K6: the masked minimum of t*|d| per ray."""
    return _matmul_sweep(rayf, g, tile_mask, mt_eps, self_hit_eps, "min")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    """The kernels' library, built from csrc/ at first use and loaded."""
    from raytracing_gpu_tpu_torch.csrc.build import library_path

    lib = ctypes.CDLL(str(library_path()))
    rays_tris = [_P, _P, _I, _P, _P, _P]
    # K1/K2 read the pair-tile mask; K4 an ordered worklist
    lib.rgt_nearest_hit.argtypes = rays_tris + [_P, _I, _F, _F, _P, _P, _P]
    lib.rgt_nearest_dist.argtypes = rays_tris + [_P, _I, _F, _F, _P, _P, _P]
    lib.rgt_any_hit.argtypes = rays_tris + [_P, _P, _I, _F, _F, _P, _P, _P]
    lib.rgt_fetch_rows.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P]
    matmul = [_P, _I, _P, _I, _P, _P, _I, _F, _F, _P]
    lib.rgt_nearest_hit_matmul.argtypes = matmul + [_P, _P]
    lib.rgt_nearest_dist_matmul.argtypes = matmul + [_P]
    for fn in (lib.rgt_nearest_hit, lib.rgt_nearest_dist, lib.rgt_fetch_rows,
               lib.rgt_any_hit, lib.rgt_nearest_hit_matmul,
               lib.rgt_nearest_dist_matmul):
        fn.restype = _I
    lib.rgt_error_string.argtypes = [_I]
    lib.rgt_error_string.restype = ctypes.c_char_p
    return lib


def build_kernels() -> None:
    """Build (or reuse) and load the kernels' library now."""
    _lib()


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU (take the plain version), False
    when every one is on one CUDA device (launch the kernel); raises
    otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on several devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev) -> int:
    """Handle of the current CUDA stream on `dev`, asked anew at every launch
    (a graph capture or a stream context changes it). torch's raw getter
    skips building a `torch.cuda.Stream` object, which costs several
    microseconds per call; without it the public call serves."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return raw(torch.cuda.current_device() if dev.index is None else dev.index)


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().rgt_error_string(code).decode()} ({code})")


def _tile_counts(tile_mask, Rp: int, Tp: int) -> tuple[int, int]:
    """(ray tiles, triangle tiles) of a sweep, after checking the padding
    and the (Tp/256, Rp/256) shape of its pair-tile mask."""
    if Rp % TILE_R or Tp % TILE_T:
        raise ValueError(f"rays ({Rp}) and triangles ({Tp}) must be padded "
                         f"to multiples of {TILE_R}/{TILE_T}")
    nR, nT = Rp // TILE_R, Tp // TILE_T
    if tuple(tile_mask.shape) != (nT, nR):
        raise ValueError(f"tile_mask: expected shape {(nT, nR)}, got "
                         f"{tuple(tile_mask.shape)}")
    return nR, nT


def _ray_worklist(tile_mask, Rp: int, Tp: int):
    """Checked (order, count) of a (Tp/256, Rp/256) tile mask: per ray tile,
    its surviving triangle tiles in ascending order."""
    _tile_counts(tile_mask, Rp, Tp)
    return tuple(t.contiguous() for t in tile_worklist(tile_mask.t()))


def _require_rays_tris(op, dp, v0, e1, e2) -> tuple[int, int]:
    Rp, Tp = op.shape[1], v0.shape[0]
    for what, t, shape in (("op", op, (3, Rp)), ("dp", dp, (3, Rp)),
                           ("v0", v0, (Tp, 3)), ("e1", e1, (Tp, 3)),
                           ("e2", e2, (Tp, 3))):
        _require(t, what, torch.float32, shape)
    return Rp, Tp


def _require_key_order(self_hit_eps) -> None:
    """K1/K2 combine their blocks by the integer order of the distances'
    bits, which holds for positive floats only: every accepted distance
    exceeds self_hit_eps, so that must not be negative."""
    if self_hit_eps < 0:
        raise ValueError(f"self_hit_eps must be >= 0, got {self_hit_eps}")


def key_halves(key):
    """(Rp,) int64 keys of `sweep_key` -> (dist float32, slot int32) as views
    of the keys' two 32-bit halves (little endian: slot first). No kernel
    runs, and both views have stride 2."""
    halves = key.view(torch.int32).view(-1, 2)
    return halves[:, 1].view(torch.float32), halves[:, 0]


def _launch_sweep(name: str, op, dp, v0, e1, e2, tile_mask, mt_eps,
                  self_hit_eps):
    """Launch K1 ("nearest_hit") or K2 ("nearest_dist") on the pair-tile
    mask itself: (dist, idx or None). K1 writes one int64 key per ray
    (`sweep_key`) and returns its `key_halves`."""
    Rp, Tp = _require_rays_tris(op, dp, v0, e1, e2)
    nR, nT = _tile_counts(tile_mask, Rp, Tp)
    _require(tile_mask, "tile_mask", torch.int32, (nT, nR))
    want_idx = name == "nearest_hit"
    dev = op.device
    out = torch.empty((Rp,), dtype=torch.int64 if want_idx else torch.float32,
                      device=dev)
    if Rp:
        # the kernel's queue of kept pair tiles, freed when this call returns
        work = torch.empty((2 + nT * nR,), dtype=torch.int32, device=dev)
        _check(getattr(_lib(), "rgt_" + name)(
            op.data_ptr(), dp.data_ptr(), Rp, v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), tile_mask.data_ptr(), nT, f32(mt_eps),
            f32(self_hit_eps), out.data_ptr(), work.data_ptr(),
            _stream(dev)), name)
        LAUNCHES[name] += 1
    return key_halves(out) if want_idx else (out, None)


def _launch_any_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """Launch K4: (occluded (Rp,) bool, walked (Rp/256,) int32)."""
    Rp, Tp = _require_rays_tris(op, dp, v0, e1, e2)
    order, count = _ray_worklist(tile_mask, Rp, Tp)
    occ = torch.empty((Rp,), dtype=torch.bool, device=op.device)
    walked = torch.empty((Rp // TILE_R,), dtype=torch.int32, device=op.device)
    if Rp == 0:
        return occ, walked
    _check(_lib().rgt_any_hit(
        op.data_ptr(), dp.data_ptr(), Rp, v0.data_ptr(), e1.data_ptr(),
        e2.data_ptr(), order.data_ptr(), count.data_ptr(), Tp // TILE_T,
        f32(mt_eps), f32(self_hit_eps), occ.data_ptr(), walked.data_ptr(),
        _stream(op.device)), "any_hit")
    LAUNCHES["any_hit"] += 1
    return occ, walked


def _launch_matmul_sweep(name: str, rayf, g, tile_mask, mt_eps, self_hit_eps):
    """Launch K5 ("nearest_hit_matmul") or K6 ("nearest_dist_matmul")."""
    Rp, Tp = rayf.shape[1], g.shape[2]
    _require(rayf, "rayf", torch.float32, (N_FEATURES, Rp))
    _require(g, "g", torch.float32, (4, N_FEATURES, Tp))
    order, count = _ray_worklist(tile_mask, Rp, Tp)
    dev = rayf.device
    dist = torch.empty((Rp,), dtype=torch.float32, device=dev)
    idx = (torch.empty((Rp,), dtype=torch.int32, device=dev)
           if name == "nearest_hit_matmul" else None)
    if Rp == 0:
        return dist, idx
    args = [rayf.data_ptr(), Rp, g.data_ptr(), Tp, order.data_ptr(),
            count.data_ptr(), Tp // TILE_T, f32(mt_eps), f32(self_hit_eps),
            dist.data_ptr()]
    if idx is not None:
        args.append(idx.data_ptr())
    _check(getattr(_lib(), "rgt_" + name)(
        *args, _stream(dev)), name)
    LAUNCHES[name] += 1
    return dist, idx


def nearest_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K1: nearest accepted hit per ray over the pair tiles tile_mask keeps.

    op/dp (3,Rp) float32 with Rp % 256 == 0; v0/e1/e2 (Tp,3) float32 with
    Tp % 256 == 0 (invalid triangles degenerate); tile_mask (Tp/256, Rp/256).
    Returns (dist (Rp,) +inf on a miss, idx (Rp,) int32 clustered slot — the
    lowest on a tie, 0 on a miss). On the card both are views with stride 2
    (`key_halves` of the kernel's int64 keys): index, slice and combine them
    freely, `fetch_rows` reads idx in place, but `.view` to another shape or
    a raw pointer needs `.contiguous()` first. Replaces nearest_hit_pallas."""
    _require_key_order(self_hit_eps)
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        return nearest_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return _launch_sweep("nearest_hit", op, dp, v0, e1, e2, tile_mask, mt_eps,
                         self_hit_eps)


def nearest_dist(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K2: minimum accepted t*|d| per ray ((Rp,), +inf on a miss) — the
    shadow path, which reads only whether it is finite. Replaces
    nearest_dist_pallas."""
    _require_key_order(self_hit_eps)
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        return nearest_dist_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return _launch_sweep("nearest_dist", op, dp, v0, e1, e2, tile_mask, mt_eps,
                         self_hit_eps)[0]


def any_hit_walked(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K4 with its work count: (occluded (Rp,) bool, walked (Rp/256,) int32
    -- the triangle tiles each ray tile scanned before every live lane was
    occluded or its worklist ended). CUDA tensors only."""
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        raise ValueError("any_hit_walked reports the kernel's work: CUDA "
                         "tensors only")
    return _launch_any_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)


def any_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K4: (Rp,) bool, the ray has some accepted hit over the pair tiles
    tile_mask keeps -- exactly `nearest_dist(...) < inf`, without the minimum,
    and a ray tile stops walking once every live lane is occluded. Dead rays
    (parked or padding, |origin| >= 1e20) report False. Replaces
    any_hit_pallas."""
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        return any_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return any_hit_walked(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)[0]


def nearest_hit_matmul(rayf, g, tile_mask, mt_eps, self_hit_eps):
    """K5: K1's result from the matmul form. rayf (16,Rp) from ray_features
    (of recentred rays), g (4,16,Tp) from pack_tri_features, tile_mask as
    K1's. Returns (dist (Rp,) from the recentred origin, +inf on a miss; idx
    (Rp,) int32 clustered slot). Replaces nearest_hit_mxu."""
    if _on_cpu(rayf, g, tile_mask):
        return nearest_hit_matmul_plain(rayf, g, tile_mask, mt_eps, self_hit_eps)
    return _launch_matmul_sweep("nearest_hit_matmul", rayf, g, tile_mask,
                                mt_eps, self_hit_eps)


def nearest_dist_matmul(rayf, g, tile_mask, mt_eps, self_hit_eps):
    """K6: minimum accepted t*|d| per ray from the matmul form ((Rp,), +inf
    on a miss). Replaces nearest_dist_mxu."""
    if _on_cpu(rayf, g, tile_mask):
        return nearest_dist_matmul_plain(rayf, g, tile_mask, mt_eps, self_hit_eps)
    return _launch_matmul_sweep("nearest_dist_matmul", rayf, g, tile_mask,
                                mt_eps, self_hit_eps)[0]


def nearest_hit_front_to_back(op, dp, pack: KernelPack, tile_mask, mt_eps,
                              self_hit_eps, k_near: int):
    """K1's result in two rounds: first each ray tile's k_near nearest
    surviving triangle tiles (by `tile_entry_lower`), then only the remaining
    tiles whose entry bound does not exceed the farthest hit the ray tile
    has so far (+inf as soon as one of its rays missed). A skipped tile
    starts beyond every ray's current winner, so it can neither beat nor tie
    one: the result equals a single sweep of tile_mask exactly. Replaces
    nearest_hit_front_to_back of the JAX package."""
    keep = tile_mask > 0
    nt = tile_mask.shape[0]
    tent = torch.where(keep, tile_entry_lower(op, dp, pack.tile_aabb,
                                              pack.tile_nonempty), INF)
    kth = torch.sort(tent, dim=0).values[min(k_near, nt) - 1]
    near = tent <= kth[None, :]
    sweep = (op, dp, pack.v0, pack.e1, pack.e2)
    dist_a, idx_a = nearest_hit(*sweep, (keep & near).to(torch.int32),
                                mt_eps, self_hit_eps)
    cut = dist_a.reshape(-1, TILE_R).amax(1)
    mask_b = keep & ~near & (tent <= cut[None, :] * 1.0001)
    dist_b, idx_b = nearest_hit(*sweep, mask_b.to(torch.int32), mt_eps,
                                self_hit_eps)
    # the winner across rounds: lexicographic (distance, slot) minimum
    better = (dist_b < dist_a) | ((dist_b == dist_a) & (idx_b < idx_a))
    return torch.where(better, dist_b, dist_a), torch.where(better, idx_b, idx_a)


def fetch_rows(table, idx):
    """K3: rows = table[idx] for a (Tp, 24|32) float32 winner table and (n,)
    int32 slots (any stride); a slot outside the table gives a NaN row on
    the card. Replaces the fetch kernels of _fetch_rows_impl."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"fetch_rows: table must be 2-D and idx 1-D, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    Tp, C = table.shape
    if C not in (TABLE_WIDTH_NOMAT, TABLE_WIDTH_MAT):
        raise ValueError(f"fetch_rows: a winner row is {TABLE_WIDTH_NOMAT} or "
                         f"{TABLE_WIDTH_MAT} floats wide, got {C}")
    if _on_cpu(table, idx):
        return fetch_rows_plain(table, idx)
    n = idx.shape[0]
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"fetch_rows: expected a float32 table and int32 "
                        f"slots, got {table.dtype} and {idx.dtype}")
    # the kernel moves 16-byte pieces with 32-bit offsets
    if (not table.is_contiguous() or table.data_ptr() % 16
            or max(Tp, n) * C >= 1 << 31):
        raise ValueError("fetch_rows: the table must be contiguous, 16-byte "
                         "aligned and, like the result, under 2**31 elements")
    out = torch.empty((n, C), dtype=torch.float32, device=table.device)
    if n:
        _check(_lib().rgt_fetch_rows(
            table.data_ptr(), Tp, C, idx.data_ptr(), idx.stride(0), n,
            out.data_ptr(),
            _stream(table.device)), "fetch_rows")
        LAUNCHES["fetch_rows"] += 1
    return out
