// Hand-written Hopper kernels for the render's intersection hot path.
//
// Six kernels, one translation unit, one build (csrc/build.py):
//   sweep_kernel<true>   (K1) replaces raytracing_gpu_tpu/ops/pallas_intersect.py
//                             _nearest_kernel / nearest_hit_pallas
//   sweep_kernel<false>  (K2) replaces _dist_kernel / nearest_dist_pallas
//   fetch_rows_kernel<L> (K3) replaces _fetch_small_kernel and _fetch_kernel
//                             (_fetch_rows_impl)
//   any_hit_kernel       (K4) replaces _any_kernel / any_hit_pallas
//   matmul_sweep_kernel<true>  (K5) replaces _mxu_kernel / nearest_hit_mxu
//   matmul_sweep_kernel<false> (K6) replaces _mxu_dist_kernel / nearest_dist_mxu
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

// One triangle tile staged in shared memory, component-major so that the 256
// threads of a block read the same address (a broadcast) in the scan loop.
// K4's staging; K1/K2 use TriRows below.
struct TriTile {
  float c[9][TILE_T];  // v0x v0y v0z e1x e1y e1z e2x e2y e2z
};

__device__ __forceinline__ void stage_tile(TriTile& s,
                                           const float* __restrict__ v0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           int j) {
  const int t = threadIdx.x;
  const long base = (long)(j * TILE_T + t) * 3;
  for (int k = 0; k < 3; ++k) {
    s.c[k][t] = v0[base + k];
    s.c[3 + k][t] = e1[base + k];
    s.c[6 + k][t] = e2[base + k];
  }
}

// One (ray, triangle) pair from a TriTile: +inf when rejected.
template <bool REF_DIST>
__device__ __forceinline__ float mt_pair(const Ray& r, const TriTile& s, int i,
                                         float mt_eps, float self_hit_eps) {
  const Tri T = {s.c[0][i], s.c[1][i], s.c[2][i], s.c[3][i], s.c[4][i],
                 s.c[5][i], s.c[6][i], s.c[7][i], s.c[8][i]};
  return mt_pair<REF_DIST>(r, T, mt_eps, self_hit_eps);
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
#define SWEEP_SUB 64  // triangles of a pair tile in one unit of work
#define SWEEP_PARTS (TILE_T / SWEEP_SUB)
#define KEY_MISS 0x7F80000000000000ull  // bits(+inf) << 32 | slot 0
#define BITS_MISS 0x7F800000u           // bits(+inf)

static_assert(TILE_T % SWEEP_SUB == 0, "a triangle tile must split evenly");

// SWEEP_SUB triangles as rows:
// q[i] = {v0x v0y v0z e1x | e1y e1z e2x e2y | e2z - - -}.
struct TriRows {
  float4 q[SWEEP_SUB][3];
};

// Stage the SWEEP_SUB triangles from clustered slot `first` on.
__device__ __forceinline__ void stage_rows(TriRows& s,
                                           const float* __restrict__ v0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           int first) {
  float* dst = reinterpret_cast<float*>(s.q);
  const long base = (long)first * 3;
  for (int e = threadIdx.x; e < SWEEP_SUB * 3; e += TILE_R) {
    const int tri = e / 3, c = e - tri * 3;
    dst[tri * 12 + c] = v0[base + e];
    dst[tri * 12 + 3 + c] = e1[base + e];
    dst[tri * 12 + 6 + c] = e2[base + e];
  }
}

// Scan the SWEEP_SUB triangles staged in `s` (clustered slots `first` on)
// for ray `r` and fold what it accepted into the per-ray minimum.
template <bool WANT_IDX>
__device__ __forceinline__ void scan_rows(
    const TriRows& s, const Ray& ray, int r, int first, float mt_eps,
    float self_hit_eps, unsigned long long* __restrict__ key_out,
    unsigned int* __restrict__ bits_out) {
  float best = CUDART_INF_F;
  int best_idx = 0;
#pragma unroll 2
  for (int i = 0; i < SWEEP_SUB; ++i) {
    const float4 A = s.q[i][0], B = s.q[i][1];
    const float C = s.q[i][2].x;
    const Tri T = {A.x, A.y, A.z, A.w, B.x, B.y, B.z, B.w, C};
    const float d = mt_pair<WANT_IDX>(ray, T, mt_eps, self_hit_eps);
    if (d < best) {
      best = d;
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

// The queue, in scratch memory. work[0]: kept pair tiles, work[1]: the next
// unit to hand out (both zeroed before), work[2 + k]: the k-th kept pair tile
// as j * nR + rt, in no fixed order.
template <typename T>
__global__ void sweep_list_kernel(T* __restrict__ out, T value, int n,
                                  const int* __restrict__ mask, int n_pairs,
                                  int* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = value;
  if (i < n_pairs && mask[i] > 0) work[2 + atomicAdd(&work[0], 1)] = i;
}

template <bool WANT_IDX>
__global__ void __launch_bounds__(TILE_R)
    sweep_kernel(const float* __restrict__ op, const float* __restrict__ dp,
                 int Rp, const float* __restrict__ v0,
                 const float* __restrict__ e1, const float* __restrict__ e2,
                 int* __restrict__ work, float mt_eps, float self_hit_eps,
                 unsigned long long* __restrict__ key_out,
                 unsigned int* __restrict__ bits_out) {
  __shared__ TriRows s;
  __shared__ int next;
  const int nR = Rp / TILE_R;
  const int n_items = work[0] * SWEEP_PARTS;
  int rt = -1;
  Ray ray;
  for (;;) {
    __syncthreads();  // previous rows consumed, previous `next` read
    if (threadIdx.x == 0) next = atomicAdd(&work[1], 1);
    __syncthreads();
    const int item = next;
    if (item >= n_items) return;
    const int pair = work[2 + item / SWEEP_PARTS];
    const int first =
        (pair / nR) * TILE_T + (item % SWEEP_PARTS) * SWEEP_SUB;
    const int r = (pair % nR) * TILE_R + threadIdx.x;
    if (pair % nR != rt) {
      rt = pair % nR;
      ray = load_ray(op, dp, Rp, r);
    }
    stage_rows(s, v0, e1, e2, first);
    __syncthreads();
    scan_rows<WANT_IDX>(s, ray, r, first, mt_eps, self_hit_eps, key_out,
                        bits_out);
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

// K4. What the TPU kernel did: the K2 grid with an int32 "occluded" row per
// ray tile in VMEM; a cell is skipped once its ray tile's row is all ones, and
// dead lanes (parked or padded rays, |origin| >= 1e20) are seeded occluded so
// they cannot pin a tile that is otherwise saturated. Here the row is one
// flag per thread. Before each worklist entry the block votes with
// __syncthreads_and: the exit is block-uniform, which it must be because the
// loop holds barriers, and the vote doubles as the "previous tile consumed"
// barrier. A thread that is already occluded still stages its share of the
// next tile and skips only its own scan; a scanning thread stops at its
// first accepted pair. The result is an OR over pairs, so no order matters:
// for a live ray it equals `nearest_dist < inf`, for a dead one it is false.
// walked_out[ray tile] is the number of triangle tiles the block scanned.
//
// What bounds it: as K2, FP32 throughput over the scanned pairs; the work depends
// on the data (a saturated tile ends its walk early).
__global__ void __launch_bounds__(TILE_R)
    any_hit_kernel(const float* __restrict__ op, const float* __restrict__ dp,
                   int Rp, const float* __restrict__ v0,
                   const float* __restrict__ e1, const float* __restrict__ e2,
                   const int* __restrict__ order, const int* __restrict__ count,
                   int nT, float mt_eps, float self_hit_eps,
                   unsigned char* __restrict__ occ_out,
                   int* __restrict__ walked_out) {
  __shared__ TriTile s;
  const int rt = blockIdx.x;
  const int r = rt * TILE_R + threadIdx.x;
  const Ray ray = load_ray(op, dp, Rp, r);
  const bool live = fabsf(ray.ox) < 1e20f && fabsf(ray.oy) < 1e20f &&
                    fabsf(ray.oz) < 1e20f;
  bool occ = !live;
  const int n = count[rt];
  int k = 0;
  for (; k < n; ++k) {
    if (__syncthreads_and(occ)) break;  // uniform: every live lane occluded
    const int j = order[(long)rt * nT + k];
    stage_tile(s, v0, e1, e2, j);
    __syncthreads();
    if (!occ) {
      for (int i = 0; i < TILE_T; ++i) {
        if (mt_pair<false>(ray, s, i, mt_eps, self_hit_eps) < CUDART_INF_F) {
          occ = true;
          break;
        }
      }
    }
  }
  occ_out[r] = (occ && live) ? 1 : 0;
  if (threadIdx.x == 0) walked_out[rt] = k;
}

// K5 / K6. What the TPU kernel did: the four Möller–Trumbore determinants of
// a 256x256 pair tile as four (16 x 256)^T (16 x 256) products on the MXU --
// ray features F = [d, m = o x d, o, 1, |d|, nd, 0, 0] against triangle
// features G = [a; u_num; v_num; t_num] -- then a short elementwise epilogue
// (divide, the acceptance chain, distance, min/argmin). Rays are recentred on
// the centroid of the live rays by the caller, since the expanded triple
// products cancel badly far from the origin.
//
// Here: the K1 grid (one block per ray tile, one thread per ray, ascending
// worklist, strict '<'). A thread keeps its ray's 14 used features in
// registers; of each triangle tile's (4,16,256) G block only the 19 rows that
// are not zero by construction are staged (ga 0-2, gu 0-5, gv 0-5, gt 6-9:
// 19 KB of shared memory instead of 64 KB). Each product is one fixed
// left-to-right chain of separately rounded multiplies and adds over exactly
// those rows -- the chain the plain twin (ops/cuda_intersect._matmul_pairs)
// evaluates -- so kernel and twin agree bit for bit. The products are computed
// in this body; no library GEMM is called.
//
// What bounds it: ~54 FP32 operations per pair (34 in the products), no
// device-memory traffic beyond one 19 KB tile per worklist entry; as K1,
// bound by FP32 throughput. Tensor cores (a 3xTF32 split to keep float32 accuracy)
// are later work.
#define G_ROWS 19

struct FeatTile {
  float g[G_ROWS][TILE_T];  // ga0-2 | gu0-5 | gv0-5 | gt6-9
};

__device__ __forceinline__ void stage_features(FeatTile& s,
                                               const float* __restrict__ G,
                                               long Tp, int j) {
  const long t = (long)j * TILE_T + threadIdx.x;
  for (int k = 0; k < 3; ++k) s.g[k][threadIdx.x] = G[(0 * 16 + k) * Tp + t];
  for (int k = 0; k < 6; ++k) {
    s.g[3 + k][threadIdx.x] = G[(1 * 16 + k) * Tp + t];
    s.g[9 + k][threadIdx.x] = G[(2 * 16 + k) * Tp + t];
  }
  for (int k = 0; k < 4; ++k)
    s.g[15 + k][threadIdx.x] = G[(3 * 16 + 6 + k) * Tp + t];
}

template <bool WANT_IDX>
__global__ void __launch_bounds__(TILE_R)
    matmul_sweep_kernel(const float* __restrict__ F, int Rp,
                        const float* __restrict__ G, int Tp,
                        const int* __restrict__ order,
                        const int* __restrict__ count, int nT, float mt_eps,
                        float self_hit_eps, float* __restrict__ dist_out,
                        int* __restrict__ idx_out) {
  __shared__ FeatTile s;
  const int rt = blockIdx.x;
  const int r = rt * TILE_R + threadIdx.x;
  float f[14];  // rows 0-13 of this ray's feature column
  for (int k = 0; k < 14; ++k) f[k] = F[(long)k * Rp + r];
  float best = CUDART_INF_F;
  int best_idx = 0;
  const int n = count[rt];
  for (int k = 0; k < n; ++k) {
    const int j = order[(long)rt * nT + k];
    __syncthreads();
    stage_features(s, G, Tp, j);
    __syncthreads();
    for (int i = 0; i < TILE_T; ++i) {
      const float a = (s.g[0][i] * f[0] + s.g[1][i] * f[1]) + s.g[2][i] * f[2];
      if (!(fabsf(a) >= mt_eps)) continue;
      const float inv = 1.0f / a;
      const float un =
          ((((s.g[3][i] * f[0] + s.g[4][i] * f[1]) + s.g[5][i] * f[2]) +
            s.g[6][i] * f[3]) + s.g[7][i] * f[4]) + s.g[8][i] * f[5];
      const float u = un * inv;
      if (!(u >= 0.0f && u <= 1.0f)) continue;
      const float vn =
          ((((s.g[9][i] * f[0] + s.g[10][i] * f[1]) + s.g[11][i] * f[2]) +
            s.g[12][i] * f[3]) + s.g[13][i] * f[4]) + s.g[14][i] * f[5];
      const float v = vn * inv;
      if (!(v >= 0.0f && u + v <= 1.0f)) continue;
      const float tn = ((s.g[15][i] * f[6] + s.g[16][i] * f[7]) +
                        s.g[17][i] * f[8]) + s.g[18][i] * f[9];
      const float t = tn * inv;
      if (!(t > mt_eps)) continue;
      const float td = t * f[10];
      float dist;
      if (WANT_IDX) {  // reference distance from the recentred origin
        const float ddx = (f[6] + f[11] * td) - f[6];
        const float ddy = (f[7] + f[12] * td) - f[7];
        const float ddz = (f[8] + f[13] * td) - f[8];
        dist = sqrtf((ddx * ddx + ddy * ddy) + ddz * ddz);
      } else {
        dist = td;
      }
      if (dist > self_hit_eps && dist < best) {
        best = dist;
        if (WANT_IDX) best_idx = j * TILE_T + i;
      }
    }
  }
  dist_out[r] = best;
  if (WANT_IDX) idx_out[r] = best_idx;
}

// Resident blocks of a persistent sweep on the current device.
template <bool WANT_IDX>
int sweep_resident_blocks() {
  static int blocks = 0;
  if (!blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_kernel<WANT_IDX>, TILE_R, 0);
    blocks = sms * per_sm;
  }
  return blocks;
}

template <bool WANT_IDX, typename T>
int launch_sweep(const float* op, const float* dp, int Rp, const float* v0,
                 const float* e1, const float* e2, const int* mask, int nT,
                 float mt_eps, float self_hit_eps, T* out, T miss, int* work,
                 cudaStream_t st) {
  unsigned long long* key = WANT_IDX ? (unsigned long long*)out : nullptr;
  unsigned int* bits = WANT_IDX ? nullptr : (unsigned int*)out;
  const int n_pairs = nT * (Rp / TILE_R);
  const int n = Rp > n_pairs ? Rp : n_pairs;
  cudaMemsetAsync(work, 0, 2 * sizeof(int), st);
  sweep_list_kernel<<<(n + 255) / 256, 256, 0, st>>>(out, miss, Rp, mask,
                                                     n_pairs, work);
  if (nT > 0)
    sweep_kernel<WANT_IDX><<<sweep_resident_blocks<WANT_IDX>(), TILE_R, 0,
                             st>>>(op, dp, Rp, v0, e1, e2, work, mt_eps,
                                   self_hit_eps, key, bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `work` is scratch of 2 + nT * (Rp / 256) ints.
int rgt_nearest_hit(const float* op, const float* dp, int Rp, const float* v0,
                    const float* e1, const float* e2, const int* mask, int nT,
                    float mt_eps, float self_hit_eps, unsigned long long* key,
                    int* work, void* stream) {
  return launch_sweep<true>(op, dp, Rp, v0, e1, e2, mask, nT, mt_eps,
                            self_hit_eps, key, (unsigned long long)KEY_MISS,
                            work, (cudaStream_t)stream);
}

int rgt_nearest_dist(const float* op, const float* dp, int Rp, const float* v0,
                     const float* e1, const float* e2, const int* mask, int nT,
                     float mt_eps, float self_hit_eps, unsigned int* bits,
                     int* work, void* stream) {
  return launch_sweep<false>(op, dp, Rp, v0, e1, e2, mask, nT, mt_eps,
                             self_hit_eps, bits, (unsigned int)BITS_MISS, work,
                             (cudaStream_t)stream);
}

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

int rgt_any_hit(const float* op, const float* dp, int Rp, const float* v0,
                const float* e1, const float* e2, const int* order,
                const int* count, int nT, float mt_eps, float self_hit_eps,
                unsigned char* occ, int* walked, void* stream) {
  any_hit_kernel<<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      op, dp, Rp, v0, e1, e2, order, count, nT, mt_eps, self_hit_eps, occ,
      walked);
  return (int)cudaGetLastError();
}

int rgt_nearest_hit_matmul(const float* F, int Rp, const float* G, int Tp,
                           const int* order, const int* count, int nT,
                           float mt_eps, float self_hit_eps, float* dist,
                           int* idx, void* stream) {
  matmul_sweep_kernel<true><<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      F, Rp, G, Tp, order, count, nT, mt_eps, self_hit_eps, dist, idx);
  return (int)cudaGetLastError();
}

int rgt_nearest_dist_matmul(const float* F, int Rp, const float* G, int Tp,
                            const int* order, const int* count, int nT,
                            float mt_eps, float self_hit_eps, float* dist,
                            void* stream) {
  matmul_sweep_kernel<false><<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      F, Rp, G, Tp, order, count, nT, mt_eps, self_hit_eps, dist, nullptr);
  return (int)cudaGetLastError();
}

const char* rgt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
