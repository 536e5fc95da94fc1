// Hand-written Hopper kernels for the render's intersection hot path.
//
// Six kernels, one translation unit, one build (csrc/build.py):
//   sweep_kernel<true>   (K1) replaces raytracing_gpu_tpu/ops/pallas_intersect.py
//                             _nearest_kernel / nearest_hit_pallas
//   sweep_kernel<false>  (K2) replaces _dist_kernel / nearest_dist_pallas
//   fetch_rows_kernel    (K3) replaces _fetch_small_kernel and _fetch_kernel
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

// One triangle tile staged in shared memory, component-major so that the 256
// threads of a block read the same address (a broadcast) in the scan loop.
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

// Möller–Trumbore for one (ray, triangle) pair, operation for operation the
// arithmetic of pallas_intersect._mt_tile and of the plain twin
// (ops/cuda_intersect.mt_pairs). Returns +inf when the pair is rejected.
// REF_DIST selects the reference's winner distance |fl(o + nd*(t*|d|)) - o|
// (cpu/hit.c:36-38,57); otherwise t*|d|.
template <bool REF_DIST>
__device__ __forceinline__ float mt_pair(const Ray& r, const TriTile& s, int i,
                                         float mt_eps, float self_hit_eps) {
  const float v0x = s.c[0][i], v0y = s.c[1][i], v0z = s.c[2][i];
  const float e1x = s.c[3][i], e1y = s.c[4][i], e1z = s.c[5][i];
  const float e2x = s.c[6][i], e2y = s.c[7][i], e2z = s.c[8][i];
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = (e1x * hx + e1y * hy) + e1z * hz;
  if (!(fabsf(a) >= mt_eps)) return CUDART_INF_F;
  const float f = 1.0f / a;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u = f * ((sx * hx + sy * hy) + sz * hz);
  if (!(u >= 0.0f && u <= 1.0f)) return CUDART_INF_F;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * ((r.dx * qx + r.dy * qy) + r.dz * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return CUDART_INF_F;
  const float t = f * ((e2x * qx + e2y * qy) + e2z * qz);
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

// K1 / K2. What the TPU kernel did: a (triangle tile, worklisted ray tile)
// grid running in order on one core, folding each 256x256 pair tile into a
// running (min, argmin) row in VMEM. Blocks on this card run in parallel and
// in no order, so the sequential axis becomes a loop inside the block: one
// block per 256-ray tile, one thread per ray, walking that ray tile's worklist
// of surviving triangle tiles in ascending order. Each tile's v0/e1/e2
// (256 x 9 floats, 9 KB) is staged in shared memory and every thread scans its
// 256 triangles with a strict '<', so the winner is the global minimum with the
// lowest clustered slot on a tie -- the Pallas result, without any cross-block
// reduction.
//
// What bounds it: ~60 FP32 operations per pair and no device-memory traffic
// beyond one 9 KB tile per worklist entry; the pair rate is bound by FP32
// issue, branch divergence of the early rejects, and occupancy (a 65,536-ray
// chunk gives 256 blocks of 256 threads for 132 SMs). Worklist compaction
// across blocks, wider tiles and tensor cores are later work.
template <bool WANT_IDX>
__global__ void __launch_bounds__(TILE_R)
    sweep_kernel(const float* __restrict__ op, const float* __restrict__ dp,
                 int Rp, const float* __restrict__ v0,
                 const float* __restrict__ e1, const float* __restrict__ e2,
                 const int* __restrict__ order, const int* __restrict__ count,
                 int nT, float mt_eps, float self_hit_eps,
                 float* __restrict__ dist_out, int* __restrict__ idx_out) {
  __shared__ TriTile s;
  const int rt = blockIdx.x;
  const int r = rt * TILE_R + threadIdx.x;
  const Ray ray = load_ray(op, dp, Rp, r);
  float best = CUDART_INF_F;
  int best_idx = 0;  // a miss reports slot 0, as the Pallas kernel initialises
  const int n = count[rt];
  for (int k = 0; k < n; ++k) {
    const int j = order[(long)rt * nT + k];
    __syncthreads();  // previous tile fully consumed
    stage_tile(s, v0, e1, e2, j);
    __syncthreads();
    for (int i = 0; i < TILE_T; ++i) {
      const float d = mt_pair<WANT_IDX>(ray, s, i, mt_eps, self_hit_eps);
      if (d < best) {
        best = d;
        if (WANT_IDX) best_idx = j * TILE_T + i;
      }
    }
  }
  dist_out[r] = best;
  if (WANT_IDX) idx_out[r] = best_idx;
}

// K3. What the TPU kernel did: one-hot (TILE_T x TILE_R) blocks multiplied on
// the MXU over a worklist of winner tiles, a workaround for the TPU's serial
// row gather; two variants split by a 4 MB VMEM budget. Here a gather is
// native: one thread per (ray, column), out[r, c] = table[idx[r], c], exact,
// for any table size. Bound by device-memory bytes (R x C x 4 written, the
// winners' rows read, mostly from L2). An index outside the table writes NaN
// instead of reading out of bounds.
__global__ void fetch_rows_kernel(const float* __restrict__ table, int Tp,
                                  int C, const int* __restrict__ idx, int n,
                                  float* __restrict__ out) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)n * C) return;
  const int r = (int)(e / C);
  const int c = (int)(e % C);
  const int j = idx[r];
  out[e] = (j >= 0 && j < Tp) ? table[(long)j * C + c] : CUDART_NAN_F;
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

}  // namespace

extern "C" {

int rgt_nearest_hit(const float* op, const float* dp, int Rp, const float* v0,
                    const float* e1, const float* e2, const int* order,
                    const int* count, int nT, float mt_eps, float self_hit_eps,
                    float* dist, int* idx, void* stream) {
  sweep_kernel<true><<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      op, dp, Rp, v0, e1, e2, order, count, nT, mt_eps, self_hit_eps, dist,
      idx);
  return (int)cudaGetLastError();
}

int rgt_nearest_dist(const float* op, const float* dp, int Rp, const float* v0,
                     const float* e1, const float* e2, const int* order,
                     const int* count, int nT, float mt_eps,
                     float self_hit_eps, float* dist, void* stream) {
  sweep_kernel<false><<<Rp / TILE_R, TILE_R, 0, (cudaStream_t)stream>>>(
      op, dp, Rp, v0, e1, e2, order, count, nT, mt_eps, self_hit_eps, dist,
      nullptr);
  return (int)cudaGetLastError();
}

int rgt_fetch_rows(const float* table, int Tp, int C, const int* idx, int n,
                   float* out, void* stream) {
  const long total = (long)n * C;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  fetch_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      table, Tp, C, idx, n, out);
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
