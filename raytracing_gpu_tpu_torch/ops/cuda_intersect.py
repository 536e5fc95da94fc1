"""Kernel path of the intersection: packing, tile culling and the seven
hand-written CUDA kernels, each beside its plain PyTorch version.

The counterpart of the JAX package's `ops/pallas_intersect.py`:

- `pack_geometry` clusters the triangles into 256-triangle tiles in morton
  order of their centroids (`cluster_triangles`) and builds the v0/e1/e2
  planes, the 24/32-wide winner table and the padded boxes of the sweeps'
  64-triangle units (`unit_boxes`), once per render;
- `tile_cull_mask_hierarchical` turns a batch of rays (packed in 256-ray
  tiles by `pack_rays`) into an (nT, nR) mask of (triangle tile, ray tile)
  pairs that may hold a hit: brute force, flat per-ray slab tests, or the
  same per-ray tests down the coarse-to-fine union-box hierarchy. On CUDA
  tensors the flat tests (`tile_cull_mask_packed`) launch
  `tile_cull_kernel`, the hierarchy (`tile_cull_mask_levels`)
  `tile_cull_levels_kernel`: kernels with no Pallas counterpart;
- `nearest_hit` (K1), `nearest_dist` (K2), `fetch_rows` (K3, differentiable
  with respect to its table: `FetchRows`), `any_hit` (K4),
  `nearest_hit_matmul` (K5) and `nearest_dist_matmul` (K6) launch the
  kernels of `csrc/intersect.cu` on CUDA tensors. On CPU tensors they run
  their plain versions, so every step around the kernels runs in the CPU
  tests; on a CUDA tensor a wrapper launches its kernel or raises. The five
  sweeps read the pair-tile mask themselves and spread the kept pair tiles
  over the whole card in units of 64 triangles; K1/K2 and K5/K6 combine the
  units by the minimum of `sweep_key`, K4 by an OR (`tile_worklist`, the
  JAX package's ordered list, is on no launch path). In K1, K2 and K4 a
  warp skips a unit whose box none of its 32 rays enters; K1 and K2 count
  the (warp, unit) scans they are offered and make (`sweep_units_plain`
  states the count) into the recorder's `sweep_units` and
  `sweep_units_scanned`;
- `nearest_hit_front_to_back` is the two-round composite over K1 (nearest
  triangle tiles first, then only those a hit so far cannot rule out);
- `ray_features` / `pack_tri_features` state the features of the
  matmul-form sweeps K5/K6, which compute the four Möller–Trumbore
  determinants as dot products of 16 features. The kernels build the same
  features themselves from the recentred rays and triangles; the plain
  versions go through these two functions.

Every integer result (perm, masks, worklists, winner slots) equals the JAX
package's, but for a ray with a subnormal direction component: XLA:CPU
treats it as zero (the 1e-30 stand-in), PyTorch and the kernels divide by
it, and a slab test that meets 0 * inf culls the pair here. The one mask
that is not the JAX package's is the hierarchy's beyond 64 tiles: that
package tests the levels below the top with interval bounds of whole ray
tiles, the port tests each ray, so the port's "octree" mask equals the JAX
package's "aabb" mask and lies inside its "octree" mask. Every mask keeps
each pair tile that holds an accepted pair, so the winners, distances and
flags do not depend on it. The distances
equal the JAX package's eager (op-by-op) evaluation bit for bit, since both
evaluate the same unfused float32 operations in the same order; under jit
XLA:CPU contracts multiply-adds into FMAs, so the Pallas kernels in
interpret mode differ by a few ulp. The matmul-form sweeps are the
exception: their dot products are summed in a fixed left-to-right order
that no XLA matmul promises, so against the JAX package they are held to a
tolerance (as that package holds its own matmul backend to one); kernel and
plain version still agree bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from raytracing_gpu_tpu_torch.ops.fp import f32, sqrt_rn
from raytracing_gpu_tpu_torch.utils import profiling
from raytracing_gpu_tpu_torch.utils.profiling import annotate

TILE_R = 256
TILE_T = 256
UNIT_T = 64  # triangles of one unit of a sweep's queue (SWEEP_SUB)
WARP = 32
INF = float("inf")
_THIRD = float(np.float32(1.0 / 3.0))  # XLA's mean divides by 3 as * f32(1/3)
_CULL_LEVELS = 8  # levels `tile_cull_levels_kernel` takes (CULL_LEVELS)
_CULL_LEAVES = 46 * 1024 * 8  # leaf tiles whose bitmap fits its block's 48 KB of shared memory

# Launch counts of the kernels, by wrapper name. A wrapper adds one exactly
# where it launches its kernel (never on its plain path), so a run can show
# that the main path went through the kernels. The launches inside a CUDA
# graph are counted at each replay of the graph, not at its capture.
LAUNCHES = {"nearest_hit": 0, "nearest_dist": 0, "fetch_rows": 0,
            "any_hit": 0, "nearest_hit_matmul": 0, "nearest_dist_matmul": 0,
            "tile_cull": 0, "tile_cull_levels": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Yields a dict that, when the block ends, holds the launches the
    wrappers counted inside it, and takes them back out of `LAUNCHES`: for a
    block that captures a CUDA graph, which launches nothing. Each replay of
    the graph adds them again (`add_launches`)."""
    before = dict(LAUNCHES)
    recorded = {}
    try:
        yield recorded
    finally:
        recorded.update({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        LAUNCHES.update(before)


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a captured graph."""
    for k, n in counts.items():
        LAUNCHES[k] += n


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
    unit_aabb: torch.Tensor      # (Tp/64, 2, 3) padded box per sweep unit
    #                              (`unit_boxes`)


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
        # made on the device, not by assigning a Python float (which a CUDA
        # graph capture may refuse)
        tail = torch.cat([dirs.new_zeros((pad, 2)), dirs.new_ones((pad, 1))], 1)
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


# the pad of a unit's box, outward on each side: shares of the box's largest
# side and of its largest coordinate's magnitude (see `unit_boxes`)
UNIT_PAD_SIDE = 2.0 ** -8
UNIT_PAD_MAG = 2.0 ** -16


def unit_boxes(v0, e1, e2):
    """(Tp/64, 2, 3) float32 boxes (lo, hi) of the 64-triangle units of the
    sweeps, in the planes' clustered order: the union of the corners v0,
    v0 + e1 and v0 + e2 of the unit's triangles whose edges are both nonzero
    (Möller–Trumbore rejects the others: a = 0; padding and invalid
    triangles have zero edges), padded outward on every side by
    UNIT_PAD_SIDE of the union's largest side plus UNIT_PAD_MAG of its
    largest coordinate's magnitude; NaN where no triangle of the unit
    counts, which no slab test enters (its min / max propagate NaN). K1, K2
    and K4 skip a unit for a warp none of whose rays enters its box.

    Why the pad covers what Möller–Trumbore accepts: it solves o + t d =
    v0 + u e1 + v e2 by Cramer's rule in float32, and the u, v of an
    accepted pair lie in the triangle. The ray's exact crossing of the
    triangle's plane lies off that point by (1) the relative error of a,
    which scales u, v and t alike and so moves the crossing within the plane
    by that share of its distance from v0, at most the unit's side: a's
    error is a few units of 2**-24 of |e1| |d| |e2|, under 2**-8 of a where
    |a| >= mt_eps and |e1| |d| |e2| < 2**14 mt_eps, or where a is more than
    2**-14 of |e1| |d| |e2| (the ray meets the plane steeply enough); and
    (2) the rounding of the dot products with o - v0, a few units of 2**-24
    of |o - v0|, and of the corners, half a unit in the last place. The slab
    test rounds its entry and exit by 2**-24 of their size. The side term
    covers (1); the magnitude term, 128 units in the last place of the
    box's largest coordinate, covers (2) and the slab test's rounding for
    rays that start within about 16 times that magnitude of the origin, and
    the side term beyond. Outside these bounds -- a large triangle met at a
    grazing angle, where a is mostly rounding and so are u, v and t -- an
    accepted pair's ray may miss the box. With no pad some pairs of
    ordinary rays do (tests/test_torch_sweep_units.py)."""
    live = (e1 != 0).any(1) & (e2 != 0).any(1)
    corners = torch.stack([v0, v0 + e1, v0 + e2], 1)
    lo = torch.where(live[:, None], corners.amin(1), INF).reshape(-1, UNIT_T, 3).amin(1)
    hi = torch.where(live[:, None], corners.amax(1), -INF).reshape(-1, UNIT_T, 3).amax(1)
    filled = live.reshape(-1, UNIT_T).any(1)
    lo = torch.where(filled[:, None], lo, 0.0)
    hi = torch.where(filled[:, None], hi, 0.0)
    side = (hi - lo).amax(1, keepdim=True)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    pad = side * UNIT_PAD_SIDE + mag * UNIT_PAD_MAG
    box = torch.stack([lo - pad, hi + pad], 1)
    return torch.where(filled[:, None, None], box, float("nan")).contiguous()


def pack_geometry(vertices, valid, normals=None, tri_obj=None,
                  materials=None) -> KernelPack:
    """Cluster and pack a triangle soup for the kernels. With normals and
    tri_obj the winner table is built too (collide needs it); with
    `materials` the owning object's ka/kd/ks/ns/nr ride along in columns
    19-29, so collide returns them with the same fetch.

    Only the table carries gradient (to vertices, normals and materials):
    the clustering and the v0/e1/e2 planes feed the sweeps, which only
    select, so they are cut from the graph here."""
    with torch.no_grad():
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
    if table is not None:
        table = check_winner_table(table.contiguous())
    v0, e1, e2 = v0.detach(), e1.detach(), e2.detach()
    with torch.no_grad():
        units = unit_boxes(v0, e1, e2)
    return KernelPack(perm, tile_aabb, tile_nonempty, v0, e1, e2, table, units)


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


def tile_cull_mask_packed_plain(op, dp, tile_aabb, tile_nonempty):
    """Plain version of `tile_cull_kernel`: (nB, nR) int32 pair-tile mask
    from exact per-ray slab tests."""
    nr = op.shape[1] // TILE_R
    hit = _slab_hits_packed(op, dp, tile_aabb) & tile_nonempty[:, None]
    return hit.reshape(tile_aabb.shape[0], nr, TILE_R).any(2).to(torch.int32)


def tile_cull_mask_packed(op, dp, tile_aabb, tile_nonempty):
    """(nB, nR) int32 pair-tile mask from exact per-ray slab tests: entry
    (b, rt) is 1 when box b is nonempty and some ray of ray tile rt enters
    it at or ahead of its origin. op/dp (3, Rp) float32 with Rp % 256 == 0,
    tile_aabb (nB, 2, 3) float32, tile_nonempty (nB,) bool. On the card
    `tile_cull_kernel` (each ray read once, only the mask written), equal to
    the plain version bit for bit; on CPU tensors the plain version. No
    Pallas kernel stands behind it: the JAX package's cull is jnp."""
    if _on_cpu(op, dp, tile_aabb, tile_nonempty):
        return tile_cull_mask_packed_plain(op, dp, tile_aabb, tile_nonempty)
    Rp, nB = op.shape[1], tile_aabb.shape[0]
    if Rp % TILE_R:
        raise ValueError(f"rays ({Rp}) must be padded to a multiple of {TILE_R}")
    if 3 * Rp >= 1 << 31:
        raise ValueError("tile_cull: the rays must stay under 2**31 elements")
    for what, t, shape in (("op", op, (3, Rp)), ("dp", dp, (3, Rp)),
                           ("tile_aabb", tile_aabb, (nB, 2, 3))):
        _require(t, what, torch.float32, shape)
    _require(tile_nonempty, "tile_nonempty", torch.bool, (nB,))
    mask = torch.empty((nB, Rp // TILE_R), dtype=torch.int32, device=op.device)
    if Rp and nB:
        _check(_kernels()["tile_cull"](
            op.data_ptr(), dp.data_ptr(), Rp, tile_aabb.data_ptr(),
            tile_nonempty.data_ptr(), nB, mask.data_ptr(), _stream(op.device)),
            "tile_cull")
        LAUNCHES["tile_cull"] += 1
    return mask


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
            # union-neutral; made on the device (no host data: capturable)
            empty = torch.stack([boxes.new_full((3,), INF),
                                 boxes.new_full((3,), -INF)])
            boxes = torch.cat([boxes, empty.expand(pad, 2, 3)])
            nonempty = torch.cat([nonempty, nonempty.new_zeros((pad,))])
        g = boxes.reshape(-1, branching, 2, 3)
        boxes = torch.stack([g[:, :, 0].amin(1), g[:, :, 1].amax(1)], 1)
        nonempty = nonempty.reshape(-1, branching).any(1)
        boxes = torch.where(nonempty[:, None, None], boxes, 0.0)
        levels.append((boxes, nonempty))
    return levels[::-1]


def tile_cull_mask_levels_plain(op, dp, levels):
    """Plain version of `tile_cull_levels_kernel`: the (nT, nR) int32
    pair-tile mask of per-ray slab tests down the levels, each box's test
    ANDed with the ray's own verdict on its parent (box i // 8 of the level
    above), the leaves' mask kept. Dense: every box is tested on every ray,
    in blocks of whole ray tiles that bound the (boxes x rays) tensors."""
    nT, Rp = levels[-1][0].shape[0], op.shape[1]
    rb = max(TILE_R, (_PLAIN_PAIRS // nT) // TILE_R * TILE_R)
    cols = [op.new_zeros((nT, 0), dtype=torch.bool)]
    for r0 in range(0, Rp, rb):
        o, d = op[:, r0:r0 + rb], dp[:, r0:r0 + rb]
        hit = None
        for boxes, nonempty in levels:
            h = _slab_hits_packed(o, d, boxes) & nonempty[:, None]
            if hit is not None:
                h &= hit.repeat_interleave(8, 0)[:boxes.shape[0]]
            hit = h
        cols.append(hit.reshape(nT, -1, TILE_R).any(2))
    return torch.cat(cols, 1).to(torch.int32)


def tile_cull_mask_levels(op, dp, levels):
    """(nT, nR) int32 pair-tile mask from exact per-ray slab tests down a
    union-box hierarchy: entry (b, rt) is 1 when some ray of ray tile rt
    passes the slab test of leaf b and of every ancestor of b, each of them
    nonempty. `levels` is `build_tile_levels`' list (coarse to fine, at most
    64 boxes on top, box i of a level the union of boxes 8i..8i+7 below)
    followed by the leaves: (boxes (n, 2, 3) float32, nonempty (n,) bool)
    each. A parent's box holds its children's, so this is the flat per-ray
    mask of the leaves (`tile_cull_mask_packed`) but where a subnormal
    direction component makes a NaN in one box of the chain and not in
    another. On the card `tile_cull_levels_kernel` (each ray read once, only
    the boxes below the ones it entered tested, only the mask written),
    equal to the plain version bit for bit; on CPU tensors the plain
    version. The JAX package's hierarchy is jnp."""
    flat = [t for level in levels for t in level]
    if _on_cpu(op, dp, *flat):
        return tile_cull_mask_levels_plain(op, dp, levels)
    Rp, sizes = op.shape[1], [boxes.shape[0] for boxes, _ in levels]
    if Rp % TILE_R:
        raise ValueError(f"rays ({Rp}) must be padded to a multiple of {TILE_R}")
    if 3 * Rp >= 1 << 31:
        raise ValueError("tile_cull_levels: the rays must stay under 2**31 elements")
    if not 2 <= len(levels) <= _CULL_LEVELS or sizes[0] > 64:
        raise ValueError(f"tile_cull_levels: 2 to {_CULL_LEVELS} levels under a "
                         f"top of at most 64 boxes, got sizes {sizes}")
    if any(a != -(-b // 8) for a, b in zip(sizes, sizes[1:])):
        raise ValueError(f"tile_cull_levels: each level must group the next by 8, "
                         f"got sizes {sizes}")
    if sizes[-1] > _CULL_LEAVES:
        raise ValueError(f"tile_cull_levels: {sizes[-1]} leaf tiles, more than "
                         f"{_CULL_LEAVES}")
    for what, t, shape in (("op", op, (3, Rp)), ("dp", dp, (3, Rp))):
        _require(t, what, torch.float32, shape)
    for k, (boxes, nonempty) in enumerate(levels):
        _require(boxes, f"levels[{k}] boxes", torch.float32, (sizes[k], 2, 3))
        _require(nonempty, f"levels[{k}] nonempty", torch.bool, (sizes[k],))
        if boxes.data_ptr() % 8 or nonempty.data_ptr() % 8:
            raise ValueError(f"levels[{k}] must be 8-byte aligned")
    mask = torch.empty((sizes[-1], Rp // TILE_R), dtype=torch.int32, device=op.device)
    if Rp and sizes[-1]:
        n = len(levels)
        _check(_kernels()["tile_cull_levels"](
            op.data_ptr(), dp.data_ptr(), Rp, n,
            (_P * n)(*(b.data_ptr() for b, _ in levels)),
            (_P * n)(*(f.data_ptr() for _, f in levels)),
            (_I * n)(*sizes), mask.data_ptr(), _stream(op.device)),
            "tile_cull_levels")
        LAUNCHES["tile_cull_levels"] += 1
    return mask


def tile_cull_mask_hierarchical(op, dp, pack: KernelPack, partitioning: str):
    """(nT, nR) int32 pair-tile mask for a partitioning mode: "none" all
    ones; "aabb" exact per-ray tests against every leaf box; "octree" exact
    per-ray tests down the union-box levels above the leaves when there are
    more than 64 (`tile_cull_mask_levels`), else the flat test. Conservative
    in every mode; "aabb" and "octree" keep the same pair tiles but where a
    subnormal direction component meets a box face. Span "levels": the
    union boxes' build and the cull down them (the octree mode on more than
    64 tiles)."""
    nT = pack.tile_aabb.shape[0]
    nr = op.shape[1] // TILE_R
    if partitioning == "none":
        return torch.ones((nT, nr), dtype=torch.int32, device=op.device)
    if partitioning == "aabb" or nT <= 64:
        return tile_cull_mask_packed(op, dp, pack.tile_aabb, pack.tile_nonempty)
    with annotate("levels"):
        levels = build_tile_levels(pack.tile_aabb, pack.tile_nonempty)
        return tile_cull_mask_levels(
            op, dp, levels + [(pack.tile_aabb, pack.tile_nonempty)])


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


def sweep_units_plain(op, dp, tile_mask, unit_aabb):
    """What K1 and K2 count, as int64 scalars: (offered, scanned). Offered:
    the (warp, unit) pairs of the kept pair tiles, 4 units a tile times 8
    warps of 32 rays a ray tile; scanned: those in which some ray of the
    warp enters the unit's box (`_slab_hits_packed`, the kernels' slab test
    bit for bit), the scans the kernels make. In ray blocks that bound the
    (units x rays) tensors."""
    Rp, nU = op.shape[1], unit_aabb.shape[0]
    parts, warps = nU // max(tile_mask.shape[0], 1), TILE_R // WARP
    keep = tile_mask > 0
    offered = keep.sum(dtype=torch.int64) * (parts * warps)
    scanned = torch.zeros((), dtype=torch.int64, device=op.device)
    rb = max(TILE_R, (_PLAIN_PAIRS // max(nU, 1)) // TILE_R * TILE_R)
    for r0 in range(0, Rp, rb):
        r1 = min(r0 + rb, Rp)
        enter = _slab_hits_packed(op[:, r0:r1], dp[:, r0:r1], unit_aabb)
        enter = enter.reshape(nU, -1, WARP).any(2)
        kept = keep[:, r0 // TILE_R:r1 // TILE_R].repeat_interleave(parts, 0)
        scanned += (kept.repeat_interleave(warps, 1) & enter).sum()
    return offered, scanned


def _count_units(counts) -> None:
    """Into the recorder's counters, when it is on: K1's or K2's (warp,
    unit) scans offered and made, a pair of int64 scalars."""
    if profiling.active() is not None:
        profiling.count("sweep_units", counts[0])
        profiling.count("sweep_units_scanned", counts[1])


def _count_units_plain(op, dp, v0, e1, e2, tile_mask, unit_aabb) -> None:
    """The counts of K1 or K2 where its plain twin runs, from
    `sweep_units_plain`, when the recorder is on."""
    if profiling.active() is not None:
        if unit_aabb is None:
            unit_aabb = unit_boxes(v0, e1, e2)
        _count_units(sweep_units_plain(op, dp, tile_mask, unit_aabb))


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


def _matmul_sweep(oc, dp, v0c, e1, e2, tile_mask, mt_eps, self_hit_eps, fold):
    rayf = ray_features(oc, dp)
    g = pack_tri_features(v0c, e1, e2)

    def pair_dist(r0, r1):
        return _matmul_pairs(rayf[:, r0:r1], g, mt_eps, self_hit_eps,
                             ref_dist=fold == "argmin")
    return _plain_sweep(pair_dist, oc.shape[1], v0c.shape[0], tile_mask, fold)


def nearest_hit_matmul_plain(oc, dp, v0c, e1, e2, tile_mask, mt_eps,
                             self_hit_eps):
    """Plain version of K5: (dist (Rp,), idx (Rp,) int32) as K1's, from the
    features of recentred rays and triangles."""
    return _matmul_sweep(oc, dp, v0c, e1, e2, tile_mask, mt_eps, self_hit_eps,
                         "argmin")


def nearest_dist_matmul_plain(oc, dp, v0c, e1, e2, tile_mask, mt_eps,
                              self_hit_eps):
    """Plain version of K6: the masked minimum of t*|d| per ray."""
    return _matmul_sweep(oc, dp, v0c, e1, e2, tile_mask, mt_eps, self_hit_eps,
                         "min")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# the five sweeps share one C signature; the result's dtype and the extra
# scratch ints per ray tile differ. The scratch starts with _SWEEP_HEAD ints:
# the queue's two counters and K1's and K2's two unsigned 64-bit counts
_SWEEP_HEAD = 6
_SWEEP_OUT = {"nearest_hit": (torch.int64, 0), "nearest_dist": (torch.float32, 0),
              "any_hit": (torch.bool, 2), "nearest_hit_matmul": (torch.int64, 0),
              "nearest_dist_matmul": (torch.float32, 0)}


@functools.cache
def _kernels() -> dict:
    """The kernels' entry points by wrapper name, each bound once to its
    ctypes prototype; the library is built from csrc/ at first use."""
    from raytracing_gpu_tpu_torch.csrc.build import load_library

    lib = load_library()
    sweep = ctypes.CFUNCTYPE(_I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _F, _F, _P, _P,
                             _P)
    fns = {name: sweep((f"rgt_{name}", lib)) for name in _SWEEP_OUT}
    fns["fetch_rows"] = ctypes.CFUNCTYPE(_I, _P, _I, _I, _P, _I, _I, _P, _P)(
        ("rgt_fetch_rows", lib))
    fns["tile_cull"] = ctypes.CFUNCTYPE(_I, _P, _P, _I, _P, _P, _I, _P, _P)(
        ("rgt_tile_cull", lib))
    fns["tile_cull_levels"] = ctypes.CFUNCTYPE(
        _I, _P, _P, _I, _I, _P, _P, _P, _P, _P)(("rgt_tile_cull_levels", lib))
    fns["error_string"] = ctypes.CFUNCTYPE(ctypes.c_char_p, _I)(
        ("rgt_error_string", lib))
    return fns


def build_kernels() -> None:
    """Build (or reuse) and load the kernels' library now."""
    _kernels()


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


# torch's raw getter skips building a `torch.cuda.Stream` object, which costs
# several microseconds per call; without it the public call serves
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev) -> int:
    """Handle of the current CUDA stream on `dev`, asked anew at every launch
    (a graph capture or a stream context changes it)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return _RAW_STREAM(torch.cuda.current_device() if dev.index is None
                       else dev.index)


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_kernels()['error_string'](code).decode()} ({code})")


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


def _require_rays_tris(op, dp, v0, e1, e2) -> tuple[int, int]:
    Rp, Tp = op.shape[1], v0.shape[0]
    for what, t, shape in (("op", op, (3, Rp)), ("dp", dp, (3, Rp)),
                           ("v0", v0, (Tp, 3)), ("e1", e1, (Tp, 3)),
                           ("e2", e2, (Tp, 3))):
        _require(t, what, torch.float32, shape)
    return Rp, Tp


def _require_key_order(self_hit_eps) -> None:
    """K1/K2 and K5/K6 combine their units by the integer order of the
    distances' bits, which holds for positive floats only: every accepted
    distance exceeds self_hit_eps, so that must not be negative."""
    if self_hit_eps < 0:
        raise ValueError(f"self_hit_eps must be >= 0, got {self_hit_eps}")


def key_halves(key):
    """(Rp,) int64 keys of `sweep_key` -> (dist float32, slot int32) as views
    of the keys' two 32-bit halves (little endian: slot first). No kernel
    runs, and both views have stride 2."""
    halves = key.view(torch.int32).view(-1, 2)
    return halves[:, 1].view(torch.float32), halves[:, 0]


def _launch_sweep(name: str, op, dp, v0, e1, e2, tile_mask, mt_eps,
                  self_hit_eps, unit_aabb=None):
    """Launch one of the five sweeps (a key of `_SWEEP_OUT`) on the
    pair-tile mask itself: (one result per ray -- int64 keys of `sweep_key`,
    float32 distances or bools -- and the queue's scratch, whose last
    2 * Rp/256 ints are K4's live and walked counts). K1, K2 and K4 take the
    unit boxes (`unit_boxes` of the planes where `unit_aabb` is None); K1
    and K2 add their counts of (warp, unit) scans into the recorder."""
    Rp, Tp = _require_rays_tris(op, dp, v0, e1, e2)
    nR, nT = _tile_counts(tile_mask, Rp, Tp)
    _require(tile_mask, "tile_mask", torch.int32, (nT, nR))
    dtype, per_ray_tile = _SWEEP_OUT[name]
    dev = op.device
    units = 0  # K5 and K6 read none
    if name in ("nearest_hit", "nearest_dist", "any_hit"):
        if unit_aabb is None:
            unit_aabb = unit_boxes(v0, e1, e2)
        _require(unit_aabb, "unit_aabb", torch.float32, (Tp // UNIT_T, 2, 3))
        units = unit_aabb.data_ptr()
    out = torch.empty((Rp,), dtype=dtype, device=dev)
    # its own allocation, so that a result does not keep the scratch alive
    work = torch.empty((_SWEEP_HEAD + (nT + per_ray_tile) * nR,),
                       dtype=torch.int32, device=dev)
    if Rp:
        _check(_kernels()[name](
            op.data_ptr(), dp.data_ptr(), Rp, v0.data_ptr(), e1.data_ptr(),
            e2.data_ptr(), units, tile_mask.data_ptr(), nT, f32(mt_eps),
            f32(self_hit_eps), out.data_ptr(), work.data_ptr(),
            _stream(dev)), name)
        LAUNCHES[name] += 1
        if name in ("nearest_hit", "nearest_dist"):
            _count_units(work[2:_SWEEP_HEAD].view(torch.int64))
    return out, work


def nearest_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
                unit_aabb=None):
    """K1: nearest accepted hit per ray over the pair tiles tile_mask keeps.

    op/dp (3,Rp) float32 with Rp % 256 == 0; v0/e1/e2 (Tp,3) float32 with
    Tp % 256 == 0 (invalid triangles degenerate); tile_mask (Tp/256, Rp/256);
    unit_aabb the planes' `unit_boxes` (the pack's; made here when None),
    which only spare the card the scans of units no ray of a warp enters.
    Returns (dist (Rp,) +inf on a miss, idx (Rp,) int32 clustered slot — the
    lowest on a tie, 0 on a miss). On the card both are views with stride 2
    (`key_halves` of the kernel's int64 keys): index, slice and combine them
    freely, `fetch_rows` reads idx in place, but `.view` to another shape or
    a raw pointer needs `.contiguous()` first. Replaces nearest_hit_pallas."""
    _require_key_order(self_hit_eps)
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        _count_units_plain(op, dp, v0, e1, e2, tile_mask, unit_aabb)
        return nearest_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return key_halves(_launch_sweep("nearest_hit", op, dp, v0, e1, e2,
                                    tile_mask, mt_eps, self_hit_eps,
                                    unit_aabb)[0])


def nearest_dist(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
                 unit_aabb=None):
    """K2: minimum accepted t*|d| per ray ((Rp,), +inf on a miss) — the
    shadow path, which reads only whether it is finite; arguments as K1's.
    Replaces nearest_dist_pallas."""
    _require_key_order(self_hit_eps)
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        _count_units_plain(op, dp, v0, e1, e2, tile_mask, unit_aabb)
        return nearest_dist_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return _launch_sweep("nearest_dist", op, dp, v0, e1, e2, tile_mask, mt_eps,
                         self_hit_eps, unit_aabb)[0]


def any_hit_walked(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
                   unit_aabb=None):
    """K4 with its work count: (occluded (Rp,) bool, walked (Rp/256,) int32
    -- the units (a kept pair tile's 64-triangle quarters) of each ray tile
    that were scanned; the rest were dropped because every live lane of the
    ray tile was occluded by then). walked depends on how the blocks overlap
    in time: it is at most 4 x the ray tile's kept pair tiles and differs
    from run to run, the answer does not. A unit that no ray of a warp
    enters is walked but not scanned by that warp. CUDA tensors only."""
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        raise ValueError("any_hit_walked reports the kernel's work: CUDA "
                         "tensors only")
    occ, work = _launch_sweep("any_hit", op, dp, v0, e1, e2, tile_mask, mt_eps,
                              self_hit_eps, unit_aabb)
    return occ, work[work.shape[0] - op.shape[1] // TILE_R:]


def any_hit(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps,
            unit_aabb=None):
    """K4: (Rp,) bool, the ray has some accepted hit over the pair tiles
    tile_mask keeps -- exactly `nearest_dist(...) < inf`, without the minimum:
    a ray stops at its first hit, and the rest of a ray tile's work is
    dropped once every live lane is occluded. Dead rays (parked or padding,
    |origin| >= 1e20) report False. Arguments as K1's. Replaces
    any_hit_pallas."""
    if _on_cpu(op, dp, v0, e1, e2, tile_mask):
        return any_hit_plain(op, dp, v0, e1, e2, tile_mask, mt_eps, self_hit_eps)
    return _launch_sweep("any_hit", op, dp, v0, e1, e2, tile_mask, mt_eps,
                         self_hit_eps, unit_aabb)[0]


def nearest_hit_matmul(oc, dp, v0c, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K5: K1's result from the matmul form. Takes what K1 takes, with the
    rays' origins oc (3,Rp) and the triangles' v0c (Tp,3) recentred on the
    live rays' centroid (`live_centroid`); the features of `ray_features`
    and `pack_tri_features` are built inside the kernel. Returns (dist (Rp,)
    from the recentred origin, +inf on a miss; idx (Rp,) int32 clustered
    slot), on the card as `key_halves` like K1's. Replaces nearest_hit_mxu."""
    _require_key_order(self_hit_eps)
    if _on_cpu(oc, dp, v0c, e1, e2, tile_mask):
        return nearest_hit_matmul_plain(oc, dp, v0c, e1, e2, tile_mask, mt_eps,
                                        self_hit_eps)
    return key_halves(_launch_sweep("nearest_hit_matmul", oc, dp, v0c, e1, e2,
                                    tile_mask, mt_eps, self_hit_eps)[0])


def nearest_dist_matmul(oc, dp, v0c, e1, e2, tile_mask, mt_eps, self_hit_eps):
    """K6: minimum accepted t*|d| per ray from the matmul form ((Rp,), +inf
    on a miss); arguments as K5's. Replaces nearest_dist_mxu."""
    _require_key_order(self_hit_eps)
    if _on_cpu(oc, dp, v0c, e1, e2, tile_mask):
        return nearest_dist_matmul_plain(oc, dp, v0c, e1, e2, tile_mask, mt_eps,
                                         self_hit_eps)
    return _launch_sweep("nearest_dist_matmul", oc, dp, v0c, e1, e2, tile_mask,
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
                                mt_eps, self_hit_eps, pack.unit_aabb)
    cut = dist_a.reshape(-1, TILE_R).amax(1)
    mask_b = keep & ~near & (tent <= cut[None, :] * 1.0001)
    dist_b, idx_b = nearest_hit(*sweep, mask_b.to(torch.int32), mt_eps,
                                self_hit_eps, pack.unit_aabb)
    # the winner across rounds: lexicographic (distance, slot) minimum
    better = (dist_b < dist_a) | ((dist_b == dist_a) & (idx_b < idx_a))
    return torch.where(better, dist_b, dist_a), torch.where(better, idx_b, idx_a)


def check_winner_table(table):
    """Raise unless `table` is a winner table `fetch_rows` takes: 2-D, 24 or
    32 floats wide and, on the card, float32, contiguous, 16-byte aligned
    and under 2**31 elements (the kernel moves 16-byte pieces with 32-bit
    offsets). Made once, where the table is made (`pack_geometry`): the
    table is marked, and `fetch_rows` checks only a table it has not seen."""
    if table.dim() != 2 or table.shape[1] not in (TABLE_WIDTH_NOMAT,
                                                  TABLE_WIDTH_MAT):
        raise ValueError(f"a winner table is 2-D with rows {TABLE_WIDTH_NOMAT} "
                         f"or {TABLE_WIDTH_MAT} floats wide, got "
                         f"{tuple(table.shape)}")
    if table.is_cuda:
        if table.dtype != torch.float32:
            raise TypeError(f"a winner table is float32, got {table.dtype}")
        if (not table.is_contiguous() or table.data_ptr() % 16
                or table.numel() >= 1 << 31):
            raise ValueError("a winner table must be contiguous, 16-byte "
                             "aligned and under 2**31 elements")
    table.winner_table_checked = True
    return table


def _launch_fetch_rows(table, idx):
    """Launch `fetch_rows_kernel` on arguments `fetch_rows` has checked."""
    n = idx.shape[0]
    Tp, C = table.shape
    out = torch.empty((n, C), dtype=torch.float32, device=table.device)
    if n:
        _check(_kernels()["fetch_rows"](
            table.data_ptr(), Tp, C, idx.data_ptr(), idx.stride(0), n,
            out.data_ptr(), _stream(table.device)), "fetch_rows")
        LAUNCHES["fetch_rows"] += 1
    return out


class FetchRows(torch.autograd.Function):
    """K3 with its gradient. Forward launches `fetch_rows_kernel`; backward
    is the gather's exact adjoint, the row cotangents scatter-added into a
    zero table of the table's shape. The JAX package computes that adjoint
    outside any Pallas kernel (`jnp.zeros(shape).at[idx].add(g)`), so
    `index_add_` is its port and no kernel stands behind it. On the card
    `index_add_` sums with atomics: rows fetched more than once are summed in
    an order that changes from run to run, and so do the gradient's last
    bits. Arguments are checked by `fetch_rows`, the only caller."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = tuple(table.shape)
        return _launch_fetch_rows(table, idx)

    @staticmethod
    def backward(ctx, grad_rows):
        (idx,) = ctx.saved_tensors
        # idx may be a stride-2 view of K1's keys: .long() makes the
        # contiguous int64 copy index_add_ wants
        grad_table = grad_rows.new_zeros(ctx.table_shape)
        grad_table.index_add_(0, idx.long(), grad_rows.contiguous())
        return grad_table, None


def fetch_rows(table, idx):
    """K3: rows = table[idx] for a (Tp, 24|32) float32 winner table and (n,)
    int32 slots (any stride); a slot outside the table gives a NaN row on
    the card. Differentiable with respect to the table on either device (on
    the card through `FetchRows`). Replaces the fetch kernels of
    _fetch_rows_impl and the custom VJP of fetch_winner_rows."""
    if not getattr(table, "winner_table_checked", False):
        check_winner_table(table)
    if idx.dim() != 1:
        raise ValueError(f"fetch_rows: idx must be 1-D, got {tuple(idx.shape)}")
    if not table.is_cuda or idx.device != table.device:
        _on_cpu(table, idx)  # raises unless both are on the CPU
        return fetch_rows_plain(table, idx)
    if idx.dtype != torch.int32:
        raise TypeError(f"fetch_rows: expected int32 slots, got {idx.dtype}")
    if idx.shape[0] * table.shape[1] >= 1 << 31:
        raise ValueError("fetch_rows: the result must stay under 2**31 elements")
    if table.requires_grad and torch.is_grad_enabled():
        return FetchRows.apply(table, idx)
    return _launch_fetch_rows(table, idx)  # no autograd node on the render path
