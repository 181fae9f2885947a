// K3 and K2: nearest-neighbour distances from each point of a to cloud b.
//
// Replaces two Pallas kernels of gan_rl_3d_tpu/ops/chamfer.py:
//   K3 _nn_kernel (launched by _nearest_pallas_fwd, chamfer.py:107-153):
//      distance and int32 argmin, with the b_mask folded into |b|^2 as a
//      +1e30 penalty;
//   K2 _nn_min_kernel (launched by nearest_min_distances, :182-219):
//      the distance only.
// Both compute d2 = (|a|^2 + |b|^2) + (-2a).b, keep the running minimum over
// b, and return sqrt(max(d2_min, 1e-12)).
//
// What bounds it on an H100: operations. Every (a_i, b_j) pair costs one
// FMUL, two FFMA and two FADD for d2, and one FMNMX for the minimum, for no
// extra bytes: 6 issue slots a pair, 3.1 ms at B=4096, N=M=2048 on 132 SMs
// x 128 lanes at 1.98 GHz; the input is 200 MB at that size (60 us at
// 3.35 TB/s).
//
// What the design does about it: register tiling on the CUDA cores. Each
// thread holds kR query points (-2a, |a|^2 and the running best of each);
// the block stages b in shared memory, kTileM points at a time, as float4
// (x, y, z, |b|^2 + penalty) computed once per tile, so one broadcast
// 16-byte shared load feeds kR query points. For each query point the kC
// distances of a sub-tile are reduced by FMNMX and compared once with the
// running best: K3 remembers only the sub-tile where its best last dropped
// strictly, and after the scan recomputes that sub-tile's kC distances
// (the same operations, so the same bits) to find the first j whose d2
// equals the best. That index is the first among equal minima, as a scan of
// j in increasing order with a strict < returns, like jnp.argmin and the TPU
// kernel's tile carry (chamfer.py:94-104): before the sub-tile that holds
// the first copy of the minimum every running best is strictly larger, and
// after it none drops. The distance matrix never exists; the ragged edges of
// a and b are masked, not padded (a tile's last sub-tile is filled with
// |b|^2 = +inf, which never wins). On an H100, R = 4 and C = 1 were both
// slower than R = C = 8 at B=4096 (PERF.md).
//
// The bits per pair are the TPU kernel's association, and those of the one-
// point-per-thread kernel this replaces: |a|^2 and |b|^2 as (x*x + y*y) +
// z*z, the penalty (1 - mask) * 1e30 added to |b|^2, cross = fma(nz, bz,
// fma(ny, by, nx * bx)), d2 = (|a|^2 + |b|^2) + cross, every step rounded
// on its own (the intrinsics keep nvcc from contracting or reordering).
// Minima agree with that kernel's strict < scan: d2 is never -0 (+0 + -0 is
// +0, and |a|^2 + |b|^2 is a sum of squares), a NaN never wins a strict <,
// and fminf drops a NaN.
//
// Small batches leave the card short of warps (B=64, N=2048 is 128 blocks
// of 4 warps); on an H100, splitting M over more blocks there saved 3.5-4.5
// us of device time and nothing end to end, so each block scans all of M.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kR = 8;  // query points a thread holds
constexpr int kC = 8;  // distances reduced before a compare
constexpr int kBlockPoints = kThreads * kR;
constexpr int kTileM = 256;
constexpr float kBig = 1e30f;
static_assert(kTileM % kC == 0, "a tile holds whole sub-tiles");

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// b point j as (x, y, z, |b|^2 + penalty); the product (1 - mask) * 1e30
// is rounded before the add, as the plain version does (for masks of 0 and
// 1 it is exact, so a contracted FFMA gives the same bits).
template <bool kMasked>
__device__ __forceinline__ float4 b_point(const float* bc, const float* mc,
                                          int j) {
  const float* p = bc + static_cast<size_t>(j) * 3;
  const float x = p[0], y = p[1], z = p[2];
  float b2 = norm2(x, y, z);
  if (kMasked) b2 = __fadd_rn(b2, __fmul_rn(__fsub_rn(1.f, mc[j]), kBig));
  return make_float4(x, y, z, b2);
}

__device__ __forceinline__ float pair_d2(float nx, float ny, float nz,
                                         float a2, float4 q) {
  const float cross =
      __fmaf_rn(nz, q.z, __fmaf_rn(ny, q.y, __fmul_rn(nx, q.x)));
  return __fadd_rn(__fadd_rn(a2, q.w), cross);
}

struct Queries {
  float nx[kR], ny[kR], nz[kR], a2[kR], best[kR];
  int sub[kR];  // first j of the sub-tile where best last dropped, or -1
};

// kC b points of the staged tile against the thread's kR query points.
template <bool kKeepIdx>
__device__ __forceinline__ void scan_sub(const float4* t, int jsub,
                                         Queries& q) {
  float4 p[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) p[c] = t[c];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float mn = pair_d2(q.nx[r], q.ny[r], q.nz[r], q.a2[r], p[0]);
#pragma unroll
    for (int c = 1; c < kC; ++c) {
      mn = fminf(mn, pair_d2(q.nx[r], q.ny[r], q.nz[r], q.a2[r], p[c]));
    }
    if (kKeepIdx && mn < q.best[r]) q.sub[r] = jsub;
    q.best[r] = fminf(q.best[r], mn);
  }
}

// grid.x = batch * q_blocks (the batch folded into grid.x: grid.y would cap
// it at 65,535); block (cloud, query block qb) takes query points
// [qb * kBlockPoints, +kBlockPoints) and all of b, in tiles of kTileM.
// Asking for at least 4 blocks an SM changes only how ptxas schedules the
// loop (5 blocks of 128 threads fit either way); on an H100 it ran K2
// faster than no minimum or a minimum of 5.
template <bool kKeepIdx, bool kMasked>
__global__ void __launch_bounds__(kThreads, 4)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ b_mask, int n, int m, int q_blocks,
          float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 tile[kTileM];
  const int cloud = blockIdx.x / q_blocks;
  const int i0 =
      (blockIdx.x - cloud * q_blocks) * kBlockPoints + threadIdx.x;
  const float* bc = b + static_cast<size_t>(cloud) * m * 3;
  const float* mc = kMasked ? b_mask + static_cast<size_t>(cloud) * m
                            : nullptr;

  Queries q;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    // a query point past N computes on point N - 1 and writes nothing
    const int i = min(i0 + r * kThreads, n - 1);
    const float* ai = a + (static_cast<size_t>(cloud) * n + i) * 3;
    const float ax = ai[0], ay = ai[1], az = ai[2];
    q.a2[r] = norm2(ax, ay, az);
    q.nx[r] = -2.f * ax;
    q.ny[r] = -2.f * ay;
    q.nz[r] = -2.f * az;
    q.best[r] = pos_inf();
    q.sub[r] = -1;
  }

  for (int j0 = 0; j0 < m; j0 += kTileM) {
    const int count = min(kTileM, m - j0);
    const int padded = (count + kC - 1) / kC * kC;
    __syncthreads();
    for (int t = threadIdx.x; t < padded; t += kThreads) {
      tile[t] = t < count ? b_point<kMasked>(bc, mc, j0 + t)
                          : make_float4(0.f, 0.f, 0.f, pos_inf());
    }
    __syncthreads();
    if (count == kTileM) {
      // a full tile: a trip count known at compile time, 4 sub-tiles an
      // iteration
#pragma unroll 4
      for (int c0 = 0; c0 < kTileM; c0 += kC) {
        scan_sub<kKeepIdx>(tile + c0, j0 + c0, q);
      }
    } else {
#pragma unroll 1
      for (int c0 = 0; c0 < padded; c0 += kC) {
        scan_sub<kKeepIdx>(tile + c0, j0 + c0, q);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    // a best that never dropped below +inf keeps index 0, as the strict <
    // scan keeps its initial 0
    int arg = 0;
    if (kKeepIdx && q.sub[r] >= 0) {
      const int end = min(q.sub[r] + kC, m);
      for (int j = q.sub[r]; j < end; ++j) {
        const float d2 = pair_d2(q.nx[r], q.ny[r], q.nz[r], q.a2[r],
                                 b_point<kMasked>(bc, mc, j));
        if (d2 == q.best[r]) {
          arg = j;
          break;
        }
      }
    }
    const int i = i0 + r * kThreads;
    if (i >= n) continue;
    const size_t o = static_cast<size_t>(cloud) * n + i;
    dist[o] = sqrtf(fmaxf(q.best[r], 1e-12f));
    if (kKeepIdx) idx[o] = arg;
  }
}

template <bool kKeepIdx>
int launch(const float* a, const float* b, const float* b_mask, int batch,
           int n, int m, float* dist, int* idx, void* stream) {
  const int q_blocks = (n + kBlockPoints - 1) / kBlockPoints;
  if (batch < 1 || n < 1 || m < 1 ||
      static_cast<long long>(q_blocks) * batch > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = q_blocks * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_mask) {
    nn_kernel<kKeepIdx, true><<<grid, kThreads, 0, s>>>(
        a, b, b_mask, n, m, q_blocks, dist, idx);
  } else {
    nn_kernel<kKeepIdx, false><<<grid, kThreads, 0, s>>>(
        a, b, b_mask, n, m, q_blocks, dist, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (B, N, 3), b (B, M, 3), b_mask (B, M) or null, all f32 -> dist (B, N)
// f32 and idx (B, N) int32.
GRL_EXPORT int grl_nn_dist(const float* a, const float* b,
                           const float* b_mask, int batch, int n, int m,
                           float* dist, int* idx, void* stream) {
  return launch<true>(a, b, b_mask, batch, n, m, dist, idx, stream);
}

// a (B, N, 3), b (B, M, 3) f32 -> dist (B, N) f32.
GRL_EXPORT int grl_nn_min(const float* a, const float* b, int batch, int n,
                          int m, float* dist, void* stream) {
  return launch<false>(a, b, nullptr, batch, n, m, dist, nullptr, stream);
}
