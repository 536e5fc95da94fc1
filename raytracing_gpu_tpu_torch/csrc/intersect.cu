// Hand-written Hopper kernels for the render's intersection hot path.
//
// Six kernels that replace Pallas kernels, and the two tile culls, which
// replace none (tile_cull_kernel, tile_cull_levels_kernel, below); one
// translation unit, one build
// (csrc/build.py):
//   sweep_kernel<NEAREST_HIT>  (K1) replaces raytracing_gpu_tpu/ops/
//                              pallas_intersect.py _nearest_kernel /
//                              nearest_hit_pallas
//   sweep_kernel<NEAREST_DIST> (K2) replaces _dist_kernel / nearest_dist_pallas
//   fetch_rows_kernel<L>       (K3) replaces _fetch_small_kernel and
//                              _fetch_kernel (_fetch_rows_impl)
//   sweep_kernel<ANY_HIT>      (K4) replaces _any_kernel / any_hit_pallas
//   sweep_kernel<MATMUL_HIT>   (K5) replaces _mxu_kernel / nearest_hit_mxu
//   sweep_kernel<MATMUL_DIST>  (K6) replaces _mxu_dist_kernel / nearest_dist_mxu
//   tile_cull_kernel           the exact per-ray tile cull (jnp in the JAX
//                              package: tile_cull_mask_packed)
//   tile_cull_levels_kernel    the same test down the union-box levels (jnp
//                              there: tile_cull_mask_hierarchical)
// The five sweeps are one persistent kernel over one queue of work units
// (see K1 / K2 below); they differ in what a thread keeps of its ray, in what
// a unit stages and in how a unit's result joins the others.
// Each has a plain PyTorch twin in ops/cuda_intersect.py that must agree with
// it bit for bit. That holds because this file is compiled with -fmad=false
// and without --use_fast_math: every multiply and add rounds on its own, the
// sums below are written left-associated, and '/' and sqrtf are IEEE
// round-to-nearest, exactly as PyTorch's eager elementwise ops evaluate them.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#define TILE_R 256
#define TILE_T 256

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, dlen, ndx, ndy, ndz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ op,
                                        const float* __restrict__ dp, int Rp,
                                        int r) {
  Ray ray;
  ray.ox = op[r];
  ray.oy = op[Rp + r];
  ray.oz = op[2 * Rp + r];
  ray.dx = dp[r];
  ray.dy = dp[Rp + r];
  ray.dz = dp[2 * Rp + r];
  float dlen2 = (ray.dx * ray.dx + ray.dy * ray.dy) + ray.dz * ray.dz;
  ray.dlen = sqrtf(dlen2 > 0.0f ? dlen2 : 1.0f);
  ray.ndx = ray.dx / ray.dlen;
  ray.ndy = ray.dy / ray.dlen;
  ray.ndz = ray.dz / ray.dlen;
  return ray;
}

// One triangle's nine floats, in registers.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Möller–Trumbore for one (ray, triangle) pair, operation for operation the
// arithmetic of pallas_intersect._mt_tile and of the plain twin
// (ops/cuda_intersect.mt_pairs). Returns +inf when the pair is rejected.
// REF_DIST selects the reference's winner distance |fl(o + nd*(t*|d|)) - o|
// (cpu/hit.c:36-38,57); otherwise t*|d|.
template <bool REF_DIST>
__device__ __forceinline__ float mt_pair(const Ray& r, const Tri& T,
                                         float mt_eps, float self_hit_eps) {
  const float hx = r.dy * T.e2z - r.dz * T.e2y;
  const float hy = r.dz * T.e2x - r.dx * T.e2z;
  const float hz = r.dx * T.e2y - r.dy * T.e2x;
  const float a = (T.e1x * hx + T.e1y * hy) + T.e1z * hz;
  if (!(fabsf(a) >= mt_eps)) return CUDART_INF_F;
  const float f = 1.0f / a;
  const float sx = r.ox - T.v0x;
  const float sy = r.oy - T.v0y;
  const float sz = r.oz - T.v0z;
  const float u = f * ((sx * hx + sy * hy) + sz * hz);
  if (!(u >= 0.0f && u <= 1.0f)) return CUDART_INF_F;
  const float qx = sy * T.e1z - sz * T.e1y;
  const float qy = sz * T.e1x - sx * T.e1z;
  const float qz = sx * T.e1y - sy * T.e1x;
  const float v = f * ((r.dx * qx + r.dy * qy) + r.dz * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return CUDART_INF_F;
  const float t = f * ((T.e2x * qx + T.e2y * qy) + T.e2z * qz);
  if (!(t > mt_eps)) return CUDART_INF_F;
  float dist;
  if (REF_DIST) {
    const float td = t * r.dlen;
    const float ddx = (r.ox + r.ndx * td) - r.ox;
    const float ddy = (r.oy + r.ndy * td) - r.oy;
    const float ddz = (r.oz + r.ndz * td) - r.oz;
    dist = sqrtf((ddx * ddx + ddy * ddy) + ddz * ddz);
  } else {
    dist = t * r.dlen;
  }
  return dist > self_hit_eps ? dist : CUDART_INF_F;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 1 / d for the slab test, 1e-30 standing in for a zero component
// (torch.where(d == 0, 1e-30, d) in the twins): rcp.rn, the correctly rounded
// reciprocal, equal to the IEEE division 1.0f / d and shorter.
__device__ __forceinline__ float inv_dir(float d) {
  return __frcp_rn(d == 0.0f ? 1e-30f : d);
}

// The slab test of one (ray, box) pair: t1 = (lo - o) * inv and t2 = (hi -
// o) * inv per axis, tmin = max(tmin, min(t1, t2)) and tmax = min(tmax,
// max(t1, t2)) from -inf / +inf, kept when tmax >= tmin and tmax >= 0, with
// inv = inv_dir(d). The max /
// min are those of torch.maximum / torch.minimum, which return NaN when
// either side is NaN (see tile_cull_kernel): a box with a NaN bound is
// entered by no ray.
__device__ __forceinline__ bool slab_pass(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz) {
  // max.NaN(-inf, x) and min.NaN(+inf, x) are x for every x, NaN too: the
  // first axis starts the chain without them
  float t1 = (lx - ox) * ix, t2 = (hx - ox) * ix;
  float tmin = min_nan(t1, t2);
  float tmax = max_nan(t1, t2);
  t1 = (ly - oy) * iy;
  t2 = (hy - oy) * iy;
  tmin = max_nan(tmin, min_nan(t1, t2));
  tmax = min_nan(tmax, max_nan(t1, t2));
  t1 = (lz - oz) * iz;
  t2 = (hz - oz) * iz;
  tmin = max_nan(tmin, min_nan(t1, t2));
  tmax = min_nan(tmax, max_nan(t1, t2));
  return tmax >= tmin && tmax >= 0.0f;
}

// A live ray (every origin component under 1e20 in magnitude) whose origin's
// largest component is more than UNIT_REACH times the unit box B's largest
// coordinate magnitude: the box's pad does not cover what Möller–Trumbore
// accepts for it (ops/cuda_intersect.sweep_boxes), so its lane enters the
// unit whatever the slab test says. max_nan as torch's amax: a box of NaN
// gives NaN, which no comparison passes.
constexpr float UNIT_REACH = 16.0f;

__device__ __forceinline__ bool beyond_reach(const float* B, float ox,
                                             float oy, float oz) {
  const float m = max_nan(max_nan(fabsf(ox), fabsf(oy)), fabsf(oz));
  float mag = fabsf(__ldg(B));
  for (int k = 1; k < 6; ++k) mag = max_nan(mag, fabsf(__ldg(B + k)));
  return m < 1e20f && m > UNIT_REACH * mag;
}

// K1 / K2. What the TPU kernel did: a (triangle tile, worklisted ray tile)
// grid running in order on one core, folding each 256x256 pair tile into a
// running (min, argmin) row in VMEM; the ordered, scalar-prefetched worklist
// existed because that grid is sequential.
//
// What bounds it here: ~60 FP32 operations per pair and almost no device
// memory traffic, so the time is instruction throughput -- once the pair tiles are
// spread over all 132 SMs. The first port ran one block per ray tile over its
// whole list and lasted as long as its longest list: 0.275 ms per launch on a
// 65,536-ray chunk of the 4,962-triangle sphere scene (536 kept pair tiles),
// 3.6 ms on 4,096 rays of the 96,000-triangle grid (16 blocks for 132 SMs).
//
// The design: the work unit is (kept pair tile, SWEEP_SUB of its 256
// triangles), and the blocks take units from a queue.
// - sweep_list_kernel, launched first in the same stream, sets every ray's
//   result to the miss value and appends each kept entry of the pair-tile
//   mask to a list in scratch memory (one atomicAdd per kept entry). No
//   ordered worklist is built and nothing is read back by the host.
// - sweep_kernel is persistent: as many blocks as fit on the card at once,
//   each drawing the next unit with one atomicAdd until the list is done, so
//   the card stays full whatever the shape of the mask. A unit stages its
//   triangles as rows of 12 floats (9 used) and reads each back as two
//   16-byte and one 4-byte broadcast; a thread scans them for its one ray in
//   ascending slots with a strict '<'.
// - Units combine by one atomicMin per ray, made only by a thread that
//   accepted a pair: every accepted distance is > self_hit_eps >= 0, so its
//   float bits order as an unsigned integer, and the minimum of the 64-bit
//   key (bits(dist) << 32) | slot is (min distance, lowest slot on a tie)
//   in whatever order the units ran -- the Pallas result, bit-equal from run
//   to run although the list's order is not. K2 takes the 32-bit minimum of
//   the bits alone. The miss value is (bits(+inf) << 32) | 0: distance +inf,
//   slot 0. The wrapper views the key as (slot, distance) halves; no unpack
//   kernel runs.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time per launch, `python3
// chip_smoke.py`): sphere chunk K1 0.075 ms, K2 0.044 ms (131,072 shadow
// rays, 287 tiles); grid, 4,096 rays 0.14 ms; one full grid chunk (7,741
// tiles) 0.91 ms. That is 0.12-0.14 us per pair tile = 63-71 scheduler
// slots per (warp, triangle) at 1.755-1.98 GHz where the loop executes ~50
// instructions up to the `u` reject and ~85 when a pair is accepted: the
// scan runs at the card's instruction rate, and at 2.0-2.6x the bound, which
// counts two operations per lane and cycle (FMA) where -fmad=false leaves
// one. Shapes that were built and measured slower before this one was kept:
// a grid of (ray tiles) x (triangle tiles x parts) blocks that each read
// their mask entry and leave at once when it is not kept (the blocks that
// leave cost ~0.5 ns each: K2 0.057 instead of 0.044 ms, the grid chunk 1.01
// instead of 0.90); units of 256 triangles or of 4 triangle tiles (fewer,
// longer blocks: 1.1-1.5x slower on the spheres); two rays per thread with a
// joint reject chain (within 3% on K1, 20% slower on K2); launch bounds for
// 6 or 8 resident blocks (within 3%, 5-10% slower).
//
// The unit's own box (K1, K2, K4). A pair tile is kept when any one of its
// 256 rays enters the box of its 256 triangles; on a scene of many small
// objects most warps of a kept tile miss most of its units (the SPD
// sphereflake: a level-4 sphere is one unit, a warp is 8 pixels of one row).
// So each thread runs the slab test of its ray against the box of the unit
// it was handed (units[unit], built by ops/cuda_intersect.sweep_boxes: the
// union of the unit's triangles that Möller–Trumbore can accept, padded
// outward so that it holds whatever that arithmetic accepts, NaN where
// there is none) with the tile cull's arithmetic (slab_pass, inv_dir), a
// lane whose ray starts beyond the pad's reach entering every unit
// (beyond_reach: the camera rays of a narrow view start on an image plane
// hundreds of units out), and a warp in which no lane enters skips the
// unit's scan (__any_sync). In K1
// and K2 a block none of whose threads enters skips the staging too: one
// __syncthreads_or before it. K4 stages every unit, as its early exit reads
// its count while the unit is staged. A lane that misses in a warp that
// scans scans as before: the answer is the plain twin's, which scans every
// pair of the kept tiles, and the boxes are only a bound. The ray's inverse
// direction is computed at each unit, not kept with the ray: a block's next
// unit is of another ray tile nearly always, and three registers more
// across the scan took K1 from 48 to 60 (4 resident blocks instead of 5).
// K1 and K2 count the (warp, unit) scans they are offered (8 a unit) and
// those they make, per block, added into the queue's scratch as the block
// leaves (work[2..3] and work[4..5], unsigned 64-bit); K4 counts nothing
// more (what it scans depends on timing).
// Measured (NVIDIA H100 80GB HBM3, 700 W, device ms per launch, parent ->
// this, the benchmark's sphereflake): its 65,536-ray camera chunk (K1,
// 26.8% of the (warp, unit) scans made) 1.439 -> 0.512, the chunk's
// 196,608 shadow rays (K2, 28.3%) 3.787 -> 1.442, K4 on them 3.107 ->
// 1.189, the chunk's mirror rays (K1, 12.3%) 7.44 -> 2.33, their shadow
// rays (K2, 16.4%) 10.74 -> 3.78. Where every warp enters every unit
// (65,536 rays straight down onto a 16,384-triangle grid whose units each
// span it) the test costs nothing measurable: K1 2.030 -> 2.009, K2 1.843
// -> 1.851. Built and measured slower: the ray's inverse direction kept
// in registers (K1 at 60 registers: dense grid K1 +5.9%), no vote of the
// block (the sphereflake's mirror rays 2.70 instead of 2.38), the vote
// with the staging's reads after it (dense grid K2 +3.7%).
//
// The groups' boxes (K1, K2, K4). A warp that enters a unit's box enters
// few of its triangles' boxes: on the sphereflake its shadow and mirror
// rays enter 1.4-1.5 of a unit's eight 8-triangle groups a scan, and every
// lane paid 64 Möller–Trumbore tests a scan all the same. So each group of
// SWEEP_GROUP triangles has a box too (groups[unit * SWEEP_GROUPS + g],
// the union of its triangles padded by its unit's pad, so that it is sound
// for the rays the unit's box is sound for: sweep_boxes), staged with the
// rows by the threads that store_rows leaves idle. In a warp that scans,
// each lane forms the mask of the groups its ray enters (group_bits: eight
// slab tests from shared memory, a tenth of the unit's scan; all of them
// when the ray starts beyond the unit's reach), the warp ORs the masks
// (__reduce_or_sync), and the lanes test only the triangles of the groups
// in it, in ascending slots: the answer is the plain twin's, as above. K1
// and K2 also count the groups in the warps' masks (work[6..7]); the
// groups of the scans they make are SWEEP_GROUPS times their scans.
// Measured (NVIDIA H100 80GB HBM3, 700 W, device ms per launch, parent ->
// this, in turns; groups entered a scan in brackets): the benchmark's
// sphereflake chunk's mirror rays (K1, 1.60) 2.387 -> 1.278, its 3-light
// shadow batch (K2, 1.49) 1.481 -> 0.727 and K4 on it 1.205 -> 0.629, the
// mirror hits' shadow rays (K2, 2.80) 4.457 -> 2.876; its camera rays, all
// beyond the reach (K1, 8) 1.410 -> 1.454; the spheres' CPU-mode chunk (K1,
// 6.88) 0.0765 -> 0.0685 and its shadow rays (K2, 1.88) 0.0283 -> 0.0211;
// a grid chunk (8) K1 0.298 -> 0.306, K2 0.284 -> 0.280.
#define SWEEP_SUB 64  // triangles of a pair tile in one unit of work
#define SWEEP_PARTS (TILE_T / SWEEP_SUB)
#define SWEEP_WARPS (TILE_R / 32)
#define SWEEP_GROUP 8  // triangles of a unit under one group box
#define SWEEP_GROUPS (SWEEP_SUB / SWEEP_GROUP)
#define SWEEP_ALL_GROUPS ((1u << SWEEP_GROUPS) - 1u)
// the queue's scratch: work[0] kept pair tiles, work[1] the next unit,
// work[2..7] K1's and K2's three counts, then the list
#define SWEEP_HEAD 8
#define KEY_MISS 0x7F80000000000000ull  // bits(+inf) << 32 | slot 0
#define BITS_MISS 0x7F800000u           // bits(+inf)

static_assert(TILE_T % SWEEP_SUB == 0, "a triangle tile must split evenly");
static_assert(SWEEP_SUB % SWEEP_GROUP == 0 && SWEEP_GROUPS < 32,
              "a unit must split evenly into fewer than 32 groups");

// SWEEP_SUB triangles as rows:
// q[i] = {v0x v0y v0z e1x | e1y e1z e2x e2y | e2z - - -},
// and the boxes of their SWEEP_GROUPS groups: box[g] = {lo x y z, hi x y z}.
struct TriRows {
  float4 q[SWEEP_SUB][3];
  float box[SWEEP_GROUPS][6];
};

// A thread's part of staging the SWEEP_SUB triangles from clustered slot
// `first` on: float e = threadIdx.x of their v0, e1 and e2 planes, or,
// for the next SWEEP_GROUPS * 6 threads, float e - SWEEP_SUB * 3 of their
// group boxes (in v0), read by load_rows into registers and written into
// shared memory by store_rows. The sweep issues the reads before the
// block's vote on the unit's box, so that their latency overlaps the box
// test; a unit no thread enters wastes them.
struct RowPart {
  float v0, e1, e2;
};

static_assert(SWEEP_SUB * 3 + SWEEP_GROUPS * 6 <= TILE_R,
              "one float of each plane, or of the group boxes, a thread");

__device__ __forceinline__ RowPart load_rows(const float* __restrict__ v0,
                                             const float* __restrict__ e1,
                                             const float* __restrict__ e2,
                                             const float* __restrict__ groups,
                                             int first) {
  RowPart p = {0.0f, 0.0f, 0.0f};
  const int e = threadIdx.x;
  if (e < SWEEP_SUB * 3) {
    const long at = (long)first * 3 + e;
    p = {v0[at], e1[at], e2[at]};
  } else if (e < SWEEP_SUB * 3 + SWEEP_GROUPS * 6) {
    p.v0 = __ldg(groups + (long)(first / SWEEP_GROUP) * 6 + (e - SWEEP_SUB * 3));
  }
  return p;
}

__device__ __forceinline__ void store_rows(TriRows& s, const RowPart& p) {
  const int e = threadIdx.x;
  if (e >= SWEEP_SUB * 3) {
    if (e < SWEEP_SUB * 3 + SWEEP_GROUPS * 6)
      (&s.box[0][0])[e - SWEEP_SUB * 3] = p.v0;
    return;
  }
  float* dst = reinterpret_cast<float*>(s.q);
  const int tri = e / 3, c = e - tri * 3;
  dst[tri * 12 + c] = p.v0;
  dst[tri * 12 + 3 + c] = p.e1;
  dst[tri * 12 + 6 + c] = p.e2;
}

// The groups of the staged unit whose boxes the ray enters (slab_pass, the
// boxes read as broadcasts): bit g for group g.
__device__ __forceinline__ unsigned group_bits(const TriRows& s, const Ray& ray,
                                               float ix, float iy, float iz) {
  unsigned bits = 0u;
#pragma unroll
  for (int g = 0; g < SWEEP_GROUPS; ++g) {
    const float* B = s.box[g];
    bits |= (unsigned)slab_pass(B[0], B[1], B[2], B[3], B[4], B[5], ray.ox,
                                ray.oy, ray.oz, ix, iy, iz)
            << g;
  }
  return bits;
}

// Test ray `ray` against the staged triangles i0 <= i < i1 (clustered slots
// first + i), in ascending slots with a strict '<'.
template <bool WANT_IDX>
__device__ __forceinline__ void scan_span(const TriRows& s, const Ray& ray,
                                          int first, int i0, int i1,
                                          float mt_eps, float self_hit_eps,
                                          float& best, int& best_idx) {
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float4 A = s.q[i][0], B = s.q[i][1];
    const float C = s.q[i][2].x;
    const Tri T = {A.x, A.y, A.z, A.w, B.x, B.y, B.z, B.w, C};
    const float d = mt_pair<WANT_IDX>(ray, T, mt_eps, self_hit_eps);
    if (d < best) {
      best = d;
      if (WANT_IDX) best_idx = first + i;
    }
  }
}

// Scan the triangles of the staged groups in the warp-uniform mask
// `groups` (clustered slots `first` on) for ray `r`, in ascending slots, and
// fold what it accepted into the per-ray minimum. A mask of every group
// (rays beyond the reach) is one loop over the unit: group by group it took
// 4-5% longer.
template <bool WANT_IDX>
__device__ __forceinline__ void scan_rows(
    const TriRows& s, unsigned groups, const Ray& ray, int r, int first,
    float mt_eps, float self_hit_eps, unsigned long long* __restrict__ key_out,
    unsigned int* __restrict__ bits_out) {
  float best = CUDART_INF_F;
  int best_idx = 0;
  if (groups == SWEEP_ALL_GROUPS) {
    scan_span<WANT_IDX>(s, ray, first, 0, SWEEP_SUB, mt_eps, self_hit_eps, best,
                        best_idx);
  } else {
    for (; groups; groups &= groups - 1u) {
      const int g0 = (__ffs(groups) - 1) * SWEEP_GROUP;
      scan_span<WANT_IDX>(s, ray, first, g0, g0 + SWEEP_GROUP, mt_eps,
                          self_hit_eps, best, best_idx);
    }
  }
  if (!(best < CUDART_INF_F)) return;  // a miss leaves the init value
  const unsigned bits = __float_as_uint(best);
  if (WANT_IDX)
    atomicMin(&key_out[r], ((unsigned long long)bits << 32) | (unsigned)best_idx);
  else
    atomicMin(&bits_out[r], bits);
}

// K4. What the TPU kernel did: the K2 grid with an int32 "occluded" row per
// ray tile in VMEM; a cell is skipped once its ray tile's row is all ones, and
// dead lanes (parked or padded rays, |origin| >= 1e20) are seeded occluded so
// they cannot pin a tile that is otherwise saturated.
//
// What bounds it: as K2, instruction throughput over the scanned pairs; the
// work depends on the data (a saturated ray tile drops the rest of its units).
// The first port walked one block per ray tile over an ordered worklist and
// voted with __syncthreads_and before each triangle tile: 0.32-0.37 ms on a
// GPU-mode chunk's shadow rays where K2 took 0.09, 3.65 ms on 4,096 rays of
// the grid (16 blocks for 132 SMs).
//
// The design: K1/K2's queue of (kept pair tile, SWEEP_SUB triangles) units.
// The result is an OR, so it needs neither key nor order. A thread that
// accepts a pair sets its ray's byte of the result and stops; the byte is set
// by an atomicOr on its 32-bit word, so exactly one of the blocks that may be
// scanning the same ray sees it flip, and that one takes the ray off its ray
// tile's count of live, not yet occluded lanes (scratch memory, set by the
// listing kernel, where dead lanes do not count). A thread whose ray is dead
// or already flagged skips its scan (it still helps stage). A unit whose ray
// tile's count has reached 0 is not scanned at all: the early exit, across
// units, and block-uniform because one thread reads the count and the
// staging barrier hands its verdict to the block. The count is read while
// the unit is staged, so a unit that is dropped was staged for nothing, and
// no unit waits for the count: read by the drawing thread before staging,
// one more round trip to L2 stood in front of every unit, which cost 1.5-2%
// wherever nothing saturates (GPU-mode chunk's shadow rays 0.0766 against
// 0.0755 ms) and saved 3-10% where much does (65,536 rays onto the ground:
// 0.43-0.47 against 0.48 ms); the renders' rays are of the first kind.
// walked[ray tile] counts the units that were scanned; it depends on how the
// blocks happened to overlap in time. For a live ray the result equals
// `nearest_dist < inf`, for a dead one it is false.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time per launch, `python3
// chip_smoke.py`, K2 on the same rays beside it): GPU-mode chunk's 131,072
// shadow rays (682 pair tiles) 0.0755 / 0.0851 ms; CPU-mode chunk's 0.0417 /
// 0.0438; grid, 4,096 primary rays 0.1337 / 0.1323 (nothing saturates: K2's
// work plus the counts); its shadow rays 0.0182 / 0.0235; one full grid
// chunk 0.63 / 0.83 (25,036 of 30,964 units scanned); 65,536 rays straight
// down onto the ground 0.48 / 0.60 (14,351 of 20,480).
__device__ __forceinline__ bool live_origin(const Ray& r) {
  return fabsf(r.ox) < 1e20f && fabsf(r.oy) < 1e20f && fabsf(r.oz) < 1e20f;
}

__device__ __forceinline__ void scan_rows_any(const TriRows& s, unsigned groups,
                                              const Ray& ray, int r,
                                              float mt_eps, float self_hit_eps,
                                              unsigned char* __restrict__ occ,
                                              int* __restrict__ live_count) {
  if (!live_origin(ray) || ((volatile unsigned char*)occ)[r]) return;
  for (; groups; groups &= groups - 1u) {
    const int g0 = (__ffs(groups) - 1) * SWEEP_GROUP;
#pragma unroll 2
    for (int i = g0; i < g0 + SWEEP_GROUP; ++i) {
      const float4 A = s.q[i][0], B = s.q[i][1];
      const float C = s.q[i][2].x;
      const Tri T = {A.x, A.y, A.z, A.w, B.x, B.y, B.z, B.w, C};
      if (mt_pair<false>(ray, T, mt_eps, self_hit_eps) < CUDART_INF_F) {
        const unsigned bit = 1u << (8 * (r & 3));  // byte r of a bool array
        if (!(atomicOr((unsigned*)occ + (r >> 2), bit) & bit))
          atomicSub(live_count, 1);  // once per ray: only the flip counts
        return;
      }
    }
  }
}

// K5 / K6. What the TPU kernel did: the four Möller–Trumbore determinants of
// a 256x256 pair tile as four (16 x 256)^T (16 x 256) products on the MXU --
// ray features F = [d, m = o x d, o, 1, |d|, nd, 0, 0] against triangle
// features G = [a; u_num; v_num; t_num] -- then a short elementwise epilogue
// (divide, the acceptance chain, distance, min/argmin). Rays are recentred on
// the centroid of the live rays by the caller, since the expanded triple
// products cancel badly far from the origin.
//
// What bounds it: ~54 FP32 operations per pair (34 in the products) and
// almost no device-memory traffic: instruction throughput, as K1. The first
// port ran one block per ray tile over an ordered worklist (0.30 / 0.27 ms on
// the sphere chunk, 4.5 / 4.2 ms on 4,096 rays of the grid), and its caller
// packed a (16, Rp) and a (4, 16, Tp) feature tensor with a dozen PyTorch ops
// on every call (24.6 MB for the grid).
//
// The design: K1/K2's queue and units, and the features are made here. The
// kernel takes what K1 takes -- recentred rays and (v0 - c, e1, e2). A thread
// computes its ray's 13 features once per ray tile; a unit's 64 triangles
// are turned into their 19 feature rows (those that are not zero by
// construction: ga 0-2, gu 0-5, gv 0-5, gt 6-9) while they are staged, ~40
// operations per triangle against 256 x 54 in its scan. Both follow
// ops/cuda_intersect.ray_features and pack_tri_features operation for
// operation, and each product is one left-to-right chain of separately
// rounded multiplies and adds over exactly those rows -- the chain of the
// plain twin (_matmul_pairs) -- so kernel and twin agree bit for bit. Units
// combine as K1's and K2's do: atomicMin on (bits(dist) << 32) | slot, or on
// the bits. The products are computed in this body; no library GEMM is called.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time per launch, `python3
// chip_smoke.py`): sphere chunk K5 0.060 ms (536 pair tiles), K6 0.037 ms
// (131,072 shadow rays, 287 tiles); grid, 4,096 rays 0.112 / 0.108 ms; one
// full grid chunk (7,741 tiles) 0.70 / 0.68 ms: 1.7-2.4x the bound, and
// 0.8x K1's and K2's times on the same rays (the chain to the `u` reject is
// shorter than theirs).
//
// The tensor-core form was built and measured, and lost. Each unit's four
// products ran as mma.sync.aligned.m16n8k8 TF32 from registers (the simple
// route: a warp owns 32 rays, B fragments from shared memory, no descriptors
// or warpgroup protocol), with the 3xTF32 split that float32 accuracy needs
// (big = tf32(x), small = tf32(x - big); small x big + big x small + big x
// big): 12 mma per 16 x 8 pairs, then divide and acceptance chain for every
// pair from the accumulators. Against this scalar form in the same call it
// took 0.0755 against 0.0597 ms (K5, sphere chunk), 0.0427 / 0.0366 (K6),
// 0.146 / 0.112 and 0.143 / 0.108 (grid, 4,096 rays), 0.94 / 0.69 and 0.91 /
// 0.66 (grid chunk): 1.17-1.37x slower everywhere. Its answers were usable
// (4, 1 and 32 of 65,536 / 4,096 / 65,536 winners differed from the plain
// version's, common winners' distances within 1.1e-6 relative, repeats
// bit-equal), but every pair pays the epilogue the scalar chain skips after
// a reject, and the 3 mma per pair and thread occupy the tensor pipe for
// about as long as the whole scalar chain to the `u` reject takes. wgmma
// would shorten only the mma share (at its full rate about a fifth of this
// kernel's time); with no early reject left to gain, it was not built.
struct RayFeat {
  Ray ray;           // d (features 0-2), o (6-8), |d| (10), d/|d| (11-13)
  float mx, my, mz;  // m = o x d (3-5); feature 9 is the constant 1
};

__device__ __forceinline__ RayFeat load_ray_features(
    const float* __restrict__ op, const float* __restrict__ dp, int Rp, int r) {
  RayFeat f;
  f.ray = load_ray(op, dp, Rp, r);
  const Ray& a = f.ray;
  f.mx = a.oy * a.dz - a.oz * a.dy;
  f.my = a.oz * a.dx - a.ox * a.dz;
  f.mz = a.ox * a.dy - a.oy * a.dx;
  return f;
}

// SWEEP_SUB triangles as feature rows:
// q[i] = {ga0 ga1 ga2 gu0 | gu1 gu2 gu3 gu4 | gu5 gv0 gv1 gv2 |
//         gv3 gv4 gv5 gt6 | gt7 gt8 gt9 -}.
struct FeatRows {
  float4 q[SWEEP_SUB][5];
};

// Stage the features of the SWEEP_SUB triangles from clustered slot `first`
// on: n = e1 x e2; ga = -n; gu = [-(e2 x v0), e2]; gv = [-(v0 x e1), -e1];
// gt = [n, -(v0 . n)] with the dot product left-associated.
__device__ __forceinline__ void stage_features(FeatRows& s,
                                               const float* __restrict__ v0,
                                               const float* __restrict__ e1,
                                               const float* __restrict__ e2,
                                               int first) {
  if (threadIdx.x >= SWEEP_SUB) return;
  const long base = (long)(first + threadIdx.x) * 3;
  const float v0x = v0[base], v0y = v0[base + 1], v0z = v0[base + 2];
  const float e1x = e1[base], e1y = e1[base + 1], e1z = e1[base + 2];
  const float e2x = e2[base], e2y = e2[base + 1], e2z = e2[base + 2];
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float ax = e2y * v0z - e2z * v0y;  // e2 x v0
  const float ay = e2z * v0x - e2x * v0z;
  const float az = e2x * v0y - e2y * v0x;
  const float bx = v0y * e1z - v0z * e1y;  // v0 x e1
  const float by = v0z * e1x - v0x * e1z;
  const float bz = v0x * e1y - v0y * e1x;
  const float g9 = -((v0x * nx + v0y * ny) + v0z * nz);
  float4* q = s.q[threadIdx.x];
  q[0] = make_float4(-nx, -ny, -nz, -ax);
  q[1] = make_float4(-ay, -az, e2x, e2y);
  q[2] = make_float4(e2z, -bx, -by, -bz);
  q[3] = make_float4(-e1x, -e1y, -e1z, nx);
  q[4] = make_float4(ny, nz, g9, 0.0f);
}

template <bool WANT_IDX>
__device__ __forceinline__ void scan_features(
    const FeatRows& s, const RayFeat& f, int r, int first, float mt_eps,
    float self_hit_eps, unsigned long long* __restrict__ key_out,
    unsigned int* __restrict__ bits_out) {
  const Ray& y = f.ray;
  float best = CUDART_INF_F;
  int best_idx = 0;
#pragma unroll 2
  for (int i = 0; i < SWEEP_SUB; ++i) {
    const float4 A = s.q[i][0];
    const float a = (A.x * y.dx + A.y * y.dy) + A.z * y.dz;
    if (!(fabsf(a) >= mt_eps)) continue;
    const float inv = 1.0f / a;
    const float4 B = s.q[i][1], C = s.q[i][2];
    const float un = ((((A.w * y.dx + B.x * y.dy) + B.y * y.dz) + B.z * f.mx) +
                      B.w * f.my) + C.x * f.mz;
    const float u = un * inv;
    if (!(u >= 0.0f && u <= 1.0f)) continue;
    const float4 D = s.q[i][3];
    const float vn = ((((C.y * y.dx + C.z * y.dy) + C.w * y.dz) + D.x * f.mx) +
                      D.y * f.my) + D.z * f.mz;
    const float v = vn * inv;
    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
    const float4 E = s.q[i][4];
    // the last term is gt9 * feature 9, and feature 9 is exactly 1
    const float tn = ((D.w * y.ox + E.x * y.oy) + E.y * y.oz) + E.z;
    const float t = tn * inv;
    if (!(t > mt_eps)) continue;
    const float td = t * y.dlen;
    float dist;
    if (WANT_IDX) {  // reference distance from the recentred origin
      const float ddx = (y.ox + y.ndx * td) - y.ox;
      const float ddy = (y.oy + y.ndy * td) - y.oy;
      const float ddz = (y.oz + y.ndz * td) - y.oz;
      dist = sqrtf((ddx * ddx + ddy * ddy) + ddz * ddz);
    } else {
      dist = td;
    }
    if (dist > self_hit_eps && dist < best) {
      best = dist;
      if (WANT_IDX) best_idx = first + i;
    }
  }
  if (!(best < CUDART_INF_F)) return;  // a miss leaves the init value
  const unsigned bits = __float_as_uint(best);
  if (WANT_IDX)
    atomicMin(&key_out[r], ((unsigned long long)bits << 32) | (unsigned)best_idx);
  else
    atomicMin(&bits_out[r], bits);
}

enum SweepKind { NEAREST_HIT, NEAREST_DIST, ANY_HIT, MATMUL_HIT, MATMUL_DIST };

// The queue, in scratch memory. work[0]: kept pair tiles, work[1]: the next
// unit to hand out, work[2..7]: the counts of K1 and K2 (all zeroed before),
// work[SWEEP_HEAD + k]: the k-th kept pair tile as j * nR + rt, in no fixed
// order. K4 only: live[rt] is the ray tile's count of live rays (all of them
// still unoccluded), walked[rt] its units scanned. One block of the listing
// is one ray tile (TILE_R threads).
template <typename T>
__global__ void __launch_bounds__(TILE_R)
    sweep_list_kernel(T* __restrict__ out, T value, int n,
                      const int* __restrict__ mask, int n_pairs,
                      int* __restrict__ work, const float* __restrict__ op,
                      int* __restrict__ live, int* __restrict__ walked) {
  const int i = blockIdx.x * TILE_R + threadIdx.x;
  if (i < n) out[i] = value;
  if (i < n_pairs && mask[i] > 0) work[SWEEP_HEAD + atomicAdd(&work[0], 1)] = i;
  if (live == nullptr) return;  // the same for every thread
  const bool alive = i < n && fabsf(op[i]) < 1e20f &&
                     fabsf(op[n + i]) < 1e20f && fabsf(op[2 * n + i]) < 1e20f;
  const int n_alive = __syncthreads_count(alive);
  if (threadIdx.x == 0 && i < n) {
    live[blockIdx.x] = n_alive;
    walked[blockIdx.x] = 0;
  }
}

// `out` is K1's and K5's int64 keys, K2's and K6's distance bits or K4's
// bytes; `units` the (Tp / SWEEP_SUB, 2, 3) unit boxes and `groups` the
// (Tp / SWEEP_GROUP, 2, 3) group boxes of K1, K2 and K4; `live` and
// `walked` are K4's alone. K1 is held to 5 resident blocks (48 registers):
// the group tests took it to 51-52 and 4 blocks, 2-16% slower. The others
// take no minimum (0): at 40-47 registers they fit 5 or 6 blocks, and a
// minimum of 1 or 5 took K4 from 40 to 46 registers, 7-11% slower.
template <int KIND>
__global__ void __launch_bounds__(TILE_R, KIND == NEAREST_HIT ? 5 : 0)
    sweep_kernel(const float* __restrict__ op, const float* __restrict__ dp,
                 int Rp, const float* __restrict__ v0,
                 const float* __restrict__ e1, const float* __restrict__ e2,
                 const float* __restrict__ units,
                 const float* __restrict__ groups, int* __restrict__ work,
                 float mt_eps, float self_hit_eps, void* __restrict__ out,
                 int* __restrict__ live, int* __restrict__ walked) {
  constexpr bool MATMUL = KIND == MATMUL_HIT || KIND == MATMUL_DIST;
  constexpr bool WANT_IDX = KIND == NEAREST_HIT || KIND == MATMUL_HIT;
  constexpr bool COUNTED = KIND == NEAREST_HIT || KIND == NEAREST_DIST;
  __shared__ typename std::conditional<MATMUL, FeatRows, TriRows>::type s;
  __shared__ int next;
  __shared__ int scan;  // K4: this unit's ray tile still has a lane to occlude
  __shared__ unsigned block_scans;  // K1 / K2: the block's (warp, unit) scans
  __shared__ unsigned block_groups;  // K1 / K2: the groups they scanned
  unsigned long long* key_out = WANT_IDX ? (unsigned long long*)out : nullptr;
  unsigned int* bits_out = WANT_IDX ? nullptr : (unsigned int*)out;
  const int nR = Rp / TILE_R;
  const int n_items = work[0] * SWEEP_PARTS;
  const bool leader = (threadIdx.x & 31) == 0;
  int rt = -1;
  typename std::conditional<MATMUL, RayFeat, Ray>::type ray;
  // K1 / K2: units (thread 0), the warp's scans and the groups they scanned
  unsigned drawn = 0, scans = 0, group_scans = 0;
  if (COUNTED && threadIdx.x == 0) block_scans = block_groups = 0u;
  for (;;) {
    __syncthreads();  // previous rows consumed, previous `next` read
    if (threadIdx.x == 0) next = atomicAdd(&work[1], 1);
    __syncthreads();
    const int item = next;
    if (item >= n_items) {
      if constexpr (COUNTED) {  // one add of each count a block
        if (leader && scans) {
          atomicAdd(&block_scans, scans);
          atomicAdd(&block_groups, group_scans);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          unsigned long long* counts = (unsigned long long*)(work + 2);
          atomicAdd(&counts[0], (unsigned long long)drawn * SWEEP_WARPS);
          atomicAdd(&counts[1], (unsigned long long)block_scans);
          atomicAdd(&counts[2], (unsigned long long)block_groups);
        }
      }
      return;
    }
    if (COUNTED && threadIdx.x == 0) ++drawn;
    const int pair = work[SWEEP_HEAD + item / SWEEP_PARTS];
    const int unit = (pair / nR) * SWEEP_PARTS + item % SWEEP_PARTS;
    const int first = unit * SWEEP_SUB;
    const int r = (pair % nR) * TILE_R + threadIdx.x;
    if (pair % nR != rt) {
      rt = pair % nR;
      if constexpr (MATMUL)
        ray = load_ray_features(op, dp, Rp, r);
      else
        ray = load_ray(op, dp, Rp, r);
    }
    // the unit's box, read as broadcasts; a ray beyond its reach enters
    // the unit and each of its groups
    bool enter = true, reach = false;
    float ix = 0.0f, iy = 0.0f, iz = 0.0f;
    if constexpr (!MATMUL) {
      const float* B = units + 6 * unit;
      ix = inv_dir(ray.dx);
      iy = inv_dir(ray.dy);
      iz = inv_dir(ray.dz);
      reach = beyond_reach(B, ray.ox, ray.oy, ray.oz);
      enter = reach || slab_pass(__ldg(B), __ldg(B + 1), __ldg(B + 2),
                                 __ldg(B + 3), __ldg(B + 4), __ldg(B + 5),
                                 ray.ox, ray.oy, ray.oz, ix, iy, iz);
    }
    RowPart part;
    if constexpr (!MATMUL) part = load_rows(v0, e1, e2, groups, first);
    // K4's early exit: one thread reads the ray tile's count while the unit
    // is staged (no round trip of its own), the barrier hands its verdict to
    // the block, and a unit with nothing left to occlude is not scanned
    int lanes_left = 0;
    if (KIND == ANY_HIT && threadIdx.x == 0)
      lanes_left = *(volatile int*)&live[rt];
    if constexpr (COUNTED) {  // no ray of the block enters: nothing staged
      if (!__syncthreads_or(enter)) continue;
    }
    if constexpr (MATMUL)
      stage_features(s, v0, e1, e2, first);
    else
      store_rows(s, part);
    if (KIND == ANY_HIT && threadIdx.x == 0) {
      scan = lanes_left > 0;
      if (scan) atomicAdd(&walked[rt], 1);
    }
    __syncthreads();
    if (KIND == ANY_HIT && !scan) continue;
    // a warp none of whose rays enters skips the unit, and in a unit it
    // scans, the groups none of its rays enters
    unsigned warp_groups = SWEEP_ALL_GROUPS;
    if constexpr (!MATMUL) {
      const bool warp_enters = __any_sync(0xffffffffu, enter);
      if (COUNTED) scans += leader && warp_enters;
      if (!warp_enters) continue;
      warp_groups = __reduce_or_sync(
          0xffffffffu, reach ? SWEEP_ALL_GROUPS : group_bits(s, ray, ix, iy, iz));
      if (COUNTED && leader) group_scans += __popc(warp_groups);
    }
    if constexpr (MATMUL)
      scan_features<WANT_IDX>(s, ray, r, first, mt_eps, self_hit_eps, key_out,
                              bits_out);
    else if constexpr (KIND == ANY_HIT)
      scan_rows_any(s, warp_groups, ray, r, mt_eps, self_hit_eps,
                    (unsigned char*)out, &live[rt]);
    else
      scan_rows<WANT_IDX>(s, warp_groups, ray, r, first, mt_eps, self_hit_eps,
                          key_out, bits_out);
  }
}

// K3. What the TPU kernel did: one-hot (TILE_T x TILE_R) blocks multiplied on
// the MXU over a worklist of winner tiles, a workaround for the TPU's serial
// row gather; two variants split by a 4 MB VMEM budget. Here a gather is
// native and exact for any table size. What bounds it: device-memory bytes
// (n x C x 4 written, the winners' rows read, mostly from L2), and at a few
// thousand rows the launch itself. A row is 24 or 32 floats = L = 6 or 8
// float4: one thread moves one float4 with a read-only 16-byte load and a
// 16-byte store, a block of 32 L threads moves 32 rows, their 32 slots read
// once into shared memory. L is a template parameter, so row and lane come
// from a division by a constant, in 32-bit arithmetic throughout. A slot
// outside the table writes NaN instead of reading out of bounds.
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time per launch, `python3
// chip_smoke.py`): 65,536 rows of a (5,120 x 32) table 0.0038 ms against a
// bound of 0.0028 and 0.0408 for torch.index_select (which wants int64
// slots); 4,096 rows of a (96,000 x 32) table 0.0017 ms, the launch floor,
// against 0.0038. The first port (one thread per float, a 64-bit divide and
// modulo each) took 0.0076 ms per launch in a profiled frame.
#define FETCH_ROWS 32  // rows per block

template <int L>
__global__ void __launch_bounds__(FETCH_ROWS * L)
    fetch_rows_kernel(const float4* __restrict__ table, int Tp,
                      const int* __restrict__ idx, int idx_stride, int n,
                      float4* __restrict__ out) {
  __shared__ int slot[FETCH_ROWS];
  const int r0 = blockIdx.x * FETCH_ROWS;
  if (threadIdx.x < FETCH_ROWS && r0 + threadIdx.x < n)
    slot[threadIdx.x] = idx[(long)(r0 + threadIdx.x) * idx_stride];
  __syncthreads();
  const int row = threadIdx.x / L, lane = threadIdx.x - row * L;
  if (r0 + row >= n) return;
  const int j = slot[row];
  const float4 nan4 = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                  CUDART_NAN_F);
  out[(r0 + row) * L + lane] =
      (j >= 0 && j < Tp) ? __ldg(table + j * L + lane) : nan4;
}

// The tile cull: the (box, ray tile) mask of ops/cuda_intersect.
// tile_cull_mask_packed, entry (b, rt) = 1 when box b is nonempty and some
// ray of ray tile rt passes its slab test: t1 = (lo - o) * inv and t2 = (hi
// - o) * inv per axis, tmin = max(tmin, min(t1, t2)) and tmax = min(tmax,
// max(t1, t2)) from -inf / +inf, kept when tmax >= tmin and tmax >= 0, with
// inv = 1 / d (1e-30 standing in for a zero component).
//
// It replaces no Pallas kernel: the JAX package computes the cull in jnp
// (raytracing_gpu_tpu/ops/pallas_intersect.py, tile_cull_mask_packed /
// _slab_hits_packed), and the port first computed it as tensor ops, now its
// plain twin tile_cull_mask_packed_plain. Those build (boxes x rays) float
// tensors one op at a time, ~35 kernels a cull, each reading two tensors of
// (boxes x rays) floats and writing one: the cull was the largest layer of a
// frame (PERF.md section 5, bottleneck 1; 0.61 ms a shadow cull of 327,680
// rays against 20 boxes, 0.14 ms a 65,536-ray nearest cull).
//
// What bounds it: device-memory bytes. Each ray's origin and direction are
// read once (24 bytes) and only the (boxes x ray tiles) int32 mask written:
// 7.9 MB and 100 KB for the shadow batch, 2.4 us at 3.35 TB/s. The
// arithmetic is ~28 FP32 instructions per (ray, box), ~6 us of the card's
// issue rate at that batch, so the kernel sits between the two.
//
// The design: one block per ray tile, one ray per thread. A thread loads its
// ray once, coalesced from the (3, Rp) planes, and computes inv once per
// axis, correctly rounded (inv_dir). The boxes are staged in shared memory
// CULL_CHUNK at a time, so any number of boxes works (a flat cull has at
// most 64, partitioning "aabb" any number of leaf tiles), with the chunk's
// nonempty flags as ballot words. Every thread reads each box as a
// broadcast and runs the slab chain above in the same order; a warp ORs its
// lanes' verdicts for 32 boxes at once (__reduce_or_sync) into a shared word
// per 32 boxes, and after one barrier the block writes its column of the
// mask, the chunk's words ANDed with the nonempty words.
//
// Bit-equal to the twin: -fmad=false, the correctly rounded reciprocal,
// and the max / min of torch.maximum / torch.minimum, which return NaN when
// either side is NaN where fmaxf / fminf return the other side. A NaN
// arises where a direction component is a subnormal below ~3e-39 (inv =
// inf) and lo - o or hi - o is 0 (0 * inf): the twin culls that (box, ray)
// pair, which fmaxf / fminf, dropping the NaN, can keep (a ray with three
// such components starting on a box's corner). max.NaN / min.NaN (sm_80 on)
// are the propagating forms in one instruction each (FMNMX.NAN).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, device time per launch, `python3
// chip_smoke.py`, the benchmark's 19-tile sphere scene): 0.0127 ms for a
// 5-light shadow batch of 327,680 rays (the twin's ~35 kernels 0.6 ms in a
// frame), 0.0044 ms for a 65,536-ray chunk, against bounds of 0.0024 and
// 0.0005 ms; 0.041 ms for 65,536 rays against 375 leaf boxes. That is ~2x
// the instruction floor of ~30 FP32 instructions a (ray, box) pair, none of
// them fused. Shapes built and measured no faster (shadow batch / chunk /
// 375 boxes, us): 2, 4 or 8 rays a thread (13.1 / 4.9 / 39.1, 13.0 / 6.6 /
// 49.5, 17.5 / 11.4 / 97.9), one ray a thread with the boxes read as float4
// + float2 (13.0 / 4.7 / 42.3), and fminf / fmaxf wherever a warp's rays and
// the chunk's boxes are finite, where no NaN can arise (12.9 / 4.7 / 38.8),
// against 12.7 / 4.4 / 40.6 for this kernel.
#define CULL_CHUNK TILE_R  // boxes staged per round: one per thread
#define CULL_WORDS (CULL_CHUNK / 32)

__global__ void __launch_bounds__(TILE_R)
    tile_cull_kernel(const float* __restrict__ op, const float* __restrict__ dp,
                     int Rp, const float* __restrict__ boxes,
                     const unsigned char* __restrict__ nonempty, int nB,
                     int* __restrict__ mask) {
  __shared__ float box[CULL_CHUNK * 6];  // per box: lo x y z, hi x y z
  __shared__ unsigned kept[CULL_WORDS];  // OR over the block, bit = box
  __shared__ unsigned filled[CULL_WORDS];  // the boxes' nonempty flags
  const int nR = Rp / TILE_R, rt = blockIdx.x;
  const int r = rt * TILE_R + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ox = op[r], oy = op[Rp + r], oz = op[2 * Rp + r];
  const float dx = dp[r], dy = dp[Rp + r], dz = dp[2 * Rp + r];
  const float ix = inv_dir(dx);
  const float iy = inv_dir(dy);
  const float iz = inv_dir(dz);
  for (int c0 = 0; c0 < nB; c0 += CULL_CHUNK) {
    const int n = nB - c0 < CULL_CHUNK ? nB - c0 : CULL_CHUNK;
    __syncthreads();  // the previous chunk's words are written out
    for (int e = threadIdx.x; e < n * 6; e += TILE_R)
      box[e] = boxes[(long)c0 * 6 + e];
    const unsigned full =
        __ballot_sync(0xffffffffu, threadIdx.x < n && nonempty[c0 + threadIdx.x]);
    if (lane == 0) {
      filled[warp] = full;
      kept[warp] = 0u;
    }
    __syncthreads();
    for (int b0 = 0; b0 < n; b0 += 32) {
      const int m = n - b0 < 32 ? n - b0 : 32;
      unsigned bits = 0u;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float* B = box + (b0 + j) * 6;
        bits |= (unsigned)slab_pass(B[0], B[1], B[2], B[3], B[4], B[5], ox, oy,
                                    oz, ix, iy, iz)
                << j;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits) atomicOr(&kept[b0 >> 5], bits);
    }
    __syncthreads();
    const int b = threadIdx.x;
    if (b < n)
      mask[(long)(c0 + b) * nR + rt] =
          (int)((kept[b >> 5] & filled[b >> 5]) >> (b & 31) & 1u);
  }
}

// The hierarchical tile cull: the (leaf tile, ray tile) mask of ops/
// cuda_intersect.tile_cull_mask_levels, over the union boxes that
// build_tile_levels groups above the leaf tiles (coarse to fine: a top of at
// most 64 boxes, each box's children 8b..8b+7 one level down, the leaves
// last). Entry (b, rt) = 1 when some ray of ray tile rt passes the slab test
// above on leaf b and on every ancestor of b, each of them nonempty. A
// parent's box contains its children's and every operation of the chain
// rounds monotonically, so a ray that passes a leaf passes its ancestors:
// the mask is tile_cull_kernel's over the leaves alone, but where a
// subnormal direction component makes a NaN in one box and not in another.
//
// It replaces no Pallas kernel: the JAX package's hierarchical cull is jnp
// (raytracing_gpu_tpu/ops/pallas_intersect.py, tile_cull_mask_hierarchical,
// whose levels below the top test a whole ray tile at once, as one box of
// origins times one box of directions). The port ran the same tensor ops
// (~280 kernels a cull). That interval bound is wide on the mirror and
// shadow rays of a bounce, whose origins spread and whose directions fan
// out: on the SPD sphereflake it kept 4x the pair tiles that some ray of
// the tile enters (PERF.md section 7), and the sweeps ran them all.
//
// What bounds it: each ray's 24 bytes read once and the (leaves x ray
// tiles) int32 mask written once, against ~30 FP32 instructions per (ray,
// box) actually tested: the top's boxes, then the 8 children of each box a
// ray entered. On the sphereflake (34 + 269 + 2,152 boxes) a camera ray of
// the frame's middle enters 12 top boxes, 27 middle ones and 36 leaves:
// 341 tests, against 2,152 for the flat cull of the leaves.
//
// The design: one block per ray tile, one ray per thread, the ray and inv
// computed once as in tile_cull_kernel. The top level (<= 64 boxes) is
// staged in shared memory and tested by every thread in step, as
// broadcasts, into a 64-bit word of hits. Below it each warp walks, depth
// first, the union of its 32 rays' trees: the next box that some lane
// entered, by one __reduce_or_sync over the lanes' 8-bit verdicts on a
// group of siblings. Every lane tests that box's 8 children (uniform loads:
// a group is 8 consecutive boxes, 192 bytes) and ANDs them with its own
// verdict on the box, kept in registers (the top's 64 bits, then 8 bits a
// level), so a lane keeps only what its own chain passes. The tree is
// regular (box i's children are 8i..8i+7): the walk keeps a level, a group
// and 8 bits of pending siblings a level, and needs no stack. A group's 24
// float2 box loads and its 8 nonempty flags (one 8-byte load) are issued
// before any test: -fmad=false leaves ~50 instructions a test, and with
// few warps a short-circuit load (flag, then box) costs two memory
// latencies a child. At a group's end the warp ORs the leaves its lanes
// entered into a shared bitmap; after one barrier the block writes its
// column of the mask. No (boxes x rays) tensor is ever stored.
//
// Why the warp's union and not each ray's own walk: a warp of rays that
// each walk alone takes as many steps as its busiest ray, every step a
// gather from boxes the other lanes do not need, and the loads wait on
// the branch that chose them. The union costs 5% more tests than the rays'
// own walks on the sphereflake's nearest chunk (23.4 M against 22.4 M) and
// every load is a broadcast. Measured, device time per launch (NVIDIA H100
// 80GB HBM3, 700 W; sphereflake nearest chunk / its shadow batch / a grid
// chunk, us): each thread its own walk 326 / 432 / 54, the same with 8
// lanes a ray (a lane a child) in blocks of 1,024 176 / 304 / 40, the
// warp's union with short-circuit loads 109 / 193 / 30, with every load
// first 91 / 180 / 25, and with a full group's flags in one 8-byte load and
// its boxes at fixed offsets (this kernel) 70 / 140 / 19.5; the flat cull
// of the leaves 224 / 622 / 41. At 70 us the chunk's 23.4 M tests run at
// ~8x their operations bound: ~50 instructions a test with 4 warps a
// scheduler (256 blocks on 132 SMs).
//
// Bit-equal to the twin: the same slab chain (slab_pass, -fmad=false, IEEE
// division, max.NaN / min.NaN) on the same boxes, ANDed with the ray's own
// parent verdicts.
#define CULL_LEVELS 8  // top to leaves: 64 * 8^7 leaf tiles at most
#define CULL_TOP 64    // boxes of the top level at most (build_tile_levels)

struct CullLevels {
  const float* boxes[CULL_LEVELS];             // (size, 2, 3): lo xyz, hi xyz
  const unsigned char* nonempty[CULL_LEVELS];  // (size,) bools
  int size[CULL_LEVELS];
  int n;  // levels; level n - 1 is the leaf tiles
};

// The lane's verdicts (bit j) on the n <= 8 boxes B[0..n) with flags F.
__device__ __forceinline__ unsigned group_pass(const float* __restrict__ B,
                                               const unsigned char* __restrict__ F,
                                               int n, float ox, float oy,
                                               float oz, float ix, float iy,
                                               float iz) {
  float2 box[8][3];
  unsigned long long flags = 0ull;
  if (n == 8) {  // F is 8-byte aligned (the wrapper checks the level's flags)
    flags = __ldg((const unsigned long long*)F);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) box[j][k] = __ldg((const float2*)(B + 6 * j) + k);
  } else {  // a level's last group: clamped, then masked
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j < n ? j : n - 1;
      flags |= (unsigned long long)(j < n && __ldg(F + jj)) << (8 * j);
#pragma unroll
      for (int k = 0; k < 3; ++k) box[j][k] = __ldg((const float2*)(B + 6 * jj) + k);
    }
  }
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned t = slab_pass(box[j][0].x, box[j][0].y, box[j][1].x,
                                 box[j][1].y, box[j][2].x, box[j][2].y, ox, oy,
                                 oz, ix, iy, iz);
    bits |= ((unsigned)((flags >> (8 * j)) & 0xffull) != 0u ? t : 0u) << j;
  }
  return bits;
}

__global__ void __launch_bounds__(TILE_R)
    tile_cull_levels_kernel(const float* __restrict__ op,
                            const float* __restrict__ dp, int Rp, CullLevels L,
                            int* __restrict__ mask) {
  extern __shared__ unsigned kept[];  // OR over the block, bit = leaf tile
  __shared__ float top[CULL_TOP * 6];
  __shared__ unsigned top_filled[2];  // the top's nonempty flags
  __shared__ const float* boxes[CULL_LEVELS];
  __shared__ const unsigned char* filled[CULL_LEVELS];
  __shared__ int size[CULL_LEVELS];
  const unsigned full = 0xffffffffu;
  const int nR = Rp / TILE_R, rt = blockIdx.x;
  const int r = rt * TILE_R + threadIdx.x;
  const int last = L.n - 1, nT = L.size[last], n0 = L.size[0];
  for (int w = threadIdx.x; w < (nT + 31) >> 5; w += TILE_R) kept[w] = 0u;
  for (int e = threadIdx.x; e < n0 * 6; e += TILE_R) top[e] = L.boxes[0][e];
  if (threadIdx.x < CULL_LEVELS && threadIdx.x < L.n) {
    boxes[threadIdx.x] = L.boxes[threadIdx.x];
    filled[threadIdx.x] = L.nonempty[threadIdx.x];
    size[threadIdx.x] = L.size[threadIdx.x];
  }
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    const unsigned lo = __ballot_sync(full, j < n0 && L.nonempty[0][j]);
    const unsigned hi = __ballot_sync(full, j + 32 < n0 && L.nonempty[0][j + 32]);
    if (j == 0) {
      top_filled[0] = lo;
      top_filled[1] = hi;
    }
  }
  const float ox = op[r], oy = op[Rp + r], oz = op[2 * Rp + r];
  const float dx = dp[r], dy = dp[Rp + r], dz = dp[2 * Rp + r];
  const float ix = inv_dir(dx);
  const float iy = inv_dir(dy);
  const float iz = inv_dir(dz);
  __syncthreads();

  unsigned long long h0 = 0ull;  // the lane's top boxes entered
#pragma unroll 4
  for (int j = 0; j < n0; ++j) {
    const float* B = top + j * 6;
    h0 |= (unsigned long long)slab_pass(B[0], B[1], B[2], B[3], B[4], B[5],
                                        ox, oy, oz, ix, iy, iz)
          << j;
  }
  h0 &= (unsigned long long)top_filled[1] << 32 | top_filled[0];
  const unsigned lo = __reduce_or_sync(full, (unsigned)h0);
  const unsigned hi = __reduce_or_sync(full, (unsigned)(h0 >> 32));
  const bool leader = (threadIdx.x & 31) == 0;
  unsigned long long todo = (unsigned long long)hi << 32 | lo;  // top, warp
  unsigned long long pend = 0ull;  // 8 bits a level: siblings still to enter
  unsigned long long own = 0ull;   // 8 bits a level: the lane's verdicts
  int l = 0, base = 0;             // the group of siblings: level, first box
  for (;;) {
    if (l == 0) {  // the children of the next top box some lane entered
      if (!todo) break;
      base = 8 * (__ffsll((long long)todo) - 1);
      todo &= todo - 1ull;
      l = 1;
    }
    const int p = base >> 3;  // the parent, one level up
    const bool in_parent =
        l == 1 ? (h0 >> p) & 1ull : (own >> (8 * (l - 1) + (p & 7))) & 1ull;
    const int n = size[l] - base < 8 ? size[l] - base : 8;
    unsigned mine = group_pass(boxes[l] + 6 * base, filled[l] + base, n, ox,
                               oy, oz, ix, iy, iz);
    if (!in_parent) mine = 0u;
    const unsigned any = __reduce_or_sync(full, mine);
    if (l == last) {  // leaves: base is a multiple of 8, in one word
      if (leader && any) atomicOr(&kept[base >> 5], any << (base & 31));
      --l;
      base = (base >> 3) & ~7;
    } else {
      pend |= (unsigned long long)any << (8 * l);
      own = (own & ~(0xffull << (8 * l))) | (unsigned long long)mine << (8 * l);
    }
    while (l >= 1 && !((pend >> (8 * l)) & 0xffull)) {  // climb
      --l;
      base = (base >> 3) & ~7;
    }
    if (l >= 1) {  // descend into the next sibling some lane entered
      const int bit = __ffs((unsigned)(pend >> (8 * l)) & 0xffu) - 1;
      pend &= ~(1ull << (8 * l + bit));
      base = 8 * (base + bit);
      ++l;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nT; b += TILE_R)
    mask[(long)b * nR + rt] = (int)(kept[b >> 5] >> (b & 31) & 1u);
}

// Resident blocks of a persistent sweep on the current device.
template <int KIND>
int sweep_resident_blocks() {
  static int blocks = 0;
  if (!blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel<KIND>,
                                                  TILE_R, 0);
    blocks = sms * per_sm;
  }
  return blocks;
}

// One sweep: zero the queue's counters, list (and set every ray's result to
// `miss`), then the persistent kernel, all on stream `st`. `work` is scratch
// of SWEEP_HEAD + nT * (Rp / 256) ints, 8-byte aligned, and 2 * (Rp / 256)
// more for K4.
template <int KIND, typename T>
int launch_sweep(const float* op, const float* dp, int Rp, const float* v0,
                 const float* e1, const float* e2, const float* units,
                 const float* groups, const int* mask, int nT, float mt_eps,
                 float self_hit_eps, T* out, T miss, int* work, cudaStream_t st) {
  const int nR = Rp / TILE_R, n_pairs = nT * nR;
  const int n = Rp > n_pairs ? Rp : n_pairs;
  int* live = KIND == ANY_HIT ? work + SWEEP_HEAD + n_pairs : nullptr;
  int* walked = KIND == ANY_HIT ? live + nR : nullptr;
  cudaMemsetAsync(work, 0, SWEEP_HEAD * sizeof(int), st);
  sweep_list_kernel<T><<<(n + TILE_R - 1) / TILE_R, TILE_R, 0, st>>>(
      out, miss, Rp, mask, n_pairs, work, op, live, walked);
  if (nT > 0)
    sweep_kernel<KIND><<<sweep_resident_blocks<KIND>(), TILE_R, 0, st>>>(
        op, dp, Rp, v0, e1, e2, units, groups, work, mt_eps, self_hit_eps, out,
        live, walked);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The five sweeps share one signature: packed rays (3, Rp), triangles
// (Tp, 3) x 3 with Tp = 256 nT, the unit boxes (Tp / 64, 2, 3) and the group
// boxes (Tp / 8, 2, 3) (read by K1, K2 and K4; K5 and K6 take null), the
// (nT, Rp / 256) pair-tile mask, the two epsilons, one result per ray and
// the queue's scratch (see launch_sweep).
#define RGT_SWEEP(name, KIND, T, miss)                                        \
  int name(const float* op, const float* dp, int Rp, const float* v0,         \
           const float* e1, const float* e2, const float* units,              \
           const float* groups, const int* mask, int nT, float mt_eps,        \
           float self_hit_eps, T* out, int* work, void* stream) {             \
    return launch_sweep<KIND>(op, dp, Rp, v0, e1, e2, units, groups, mask,    \
                              nT, mt_eps, self_hit_eps, out, (T)(miss), work, \
                              (cudaStream_t)stream);                          \
  }

RGT_SWEEP(rgt_nearest_hit, NEAREST_HIT, unsigned long long, KEY_MISS)
RGT_SWEEP(rgt_nearest_dist, NEAREST_DIST, unsigned int, BITS_MISS)
RGT_SWEEP(rgt_any_hit, ANY_HIT, unsigned char, 0)
// rays and v0 recentred on the live rays' centroid by the caller
RGT_SWEEP(rgt_nearest_hit_matmul, MATMUL_HIT, unsigned long long, KEY_MISS)
RGT_SWEEP(rgt_nearest_dist_matmul, MATMUL_DIST, unsigned int, BITS_MISS)

// C is 24 or 32 (the wrapper checks); idx is read with a stride in elements.
int rgt_fetch_rows(const float* table, int Tp, int C, const int* idx,
                   int idx_stride, int n, float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n + FETCH_ROWS - 1) / FETCH_ROWS;
  if (C == 24)
    fetch_rows_kernel<6><<<blocks, FETCH_ROWS * 6, 0, st>>>(
        (const float4*)table, Tp, idx, idx_stride, n, (float4*)out);
  else if (C == 32)
    fetch_rows_kernel<8><<<blocks, FETCH_ROWS * 8, 0, st>>>(
        (const float4*)table, Tp, idx, idx_stride, n, (float4*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Packed rays (3, Rp) with Rp = 256 nR, boxes (nB, 2, 3), nonempty (nB,)
// bools -> the (nB, nR) int32 mask; the wrapper checks the shapes.
int rgt_tile_cull(const float* op, const float* dp, int Rp, const float* boxes,
                  const unsigned char* nonempty, int nB, int* mask,
                  void* stream) {
  tile_cull_kernel<<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      op, dp, Rp, boxes, nonempty, nB, mask);
  return (int)cudaGetLastError();
}

// Packed rays (3, Rp) with Rp = 256 nR; 2 to 8 union-box levels, top to
// leaves: boxes[l] (sizes[l], 2, 3) floats and nonempty[l] (sizes[l],)
// bools, 8-byte aligned device pointers in host arrays, with sizes[0] <= 64
// and sizes[l] = ceil(sizes[l + 1] / 8) -> the (sizes[n_levels - 1], nR)
// int32 mask. The wrapper checks the shapes, and that the leaves' bitmap
// fits in 46 KB beside the kernel's own 1.7 KB (376,832 leaf tiles).
int rgt_tile_cull_levels(const float* op, const float* dp, int Rp,
                         int n_levels, const void* const* boxes,
                         const void* const* nonempty, const int* sizes,
                         int* mask, void* stream) {
  if (n_levels < 2 || n_levels > CULL_LEVELS || sizes[0] > CULL_TOP)
    return (int)cudaErrorInvalidValue;
  CullLevels L = {};
  L.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    L.boxes[l] = (const float*)boxes[l];
    L.nonempty[l] = (const unsigned char*)nonempty[l];
    L.size[l] = sizes[l];
  }
  const size_t smem = (size_t)((sizes[n_levels - 1] + 31) / 32) * sizeof(unsigned);
  tile_cull_levels_kernel<<<Rp / TILE_R, TILE_R, smem, (cudaStream_t)stream>>>(
      op, dp, Rp, L, mask);
  return (int)cudaGetLastError();
}

const char* rgt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
