// K4 and K5: the backward of the nearest-neighbour distance (K3).
//
// Replaces two Pallas kernels of gan_rl_3d_tpu/ops/chamfer.py, both called
// by the custom VJP _nearest_tpu_bwd (chamfer.py:341-353):
//   K4 _gather_rows_kernel (launched by _gather_rows, chamfer.py:284-302):
//      b[idx] as a one-hot matmul, because batched gathers serialise on the
//      TPU. Here it is a direct indexed load, fused with the arithmetic
//      that consumes it:
//        da_i = where(dist_i > 1e-6, g_i / max(dist_i, 1e-6), 0) * (a_i - b[idx_i])
//   K5 _nn_bwd_kernel (launched by _scatter_db, chamfer.py:305-322):
//        db_j = -sum_{i: idx_i = j} da_i
//      as a masked one-hot matmul on the TPU.
//
// What bounds them on an H100: bytes. K4 reads a, b, idx, dist, g once and
// writes da (28 + 12 bytes per query point, 6.3 MB at B=64, N=M=2048: 1.9 us
// at 3.35 TB/s) for a handful of flops per point. K5 needs N*3 adds per
// cloud against reading idx and da and writing db (3.7 MB at B=64); the
// O(N*M) compares of this first version are the design's cost, not work
// the function needs.
//
// What the designs do about it:
// K4: one thread per query point; idx, dist and g are coalesced loads, the
//     b row is a 12-byte gather that stays in L1/L2 (b is 24 KB per cloud).
//     The arithmetic uses the IEEE-rounded intrinsics in the order of the
//     JAX expression, so the result is bit-identical to the plain version.
// K5: deterministic, no float atomics. One block per (cloud, tile of 256
//     targets j); the cloud's idx and da are staged in shared memory in
//     chunks of 2048 points (8 KB + 24 KB); each thread owns one target and
//     sums da_i over increasing i where idx_i == j (the shared loads are
//     warp-wide broadcasts). Two launches on the same inputs give the same
//     bits. A counting-sort form that does O(N) work is later work.
// Any N and M: ragged edges are masked.

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 256;
constexpr int kChunkN = 2048;
constexpr float kMinDist = 1e-6f;

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const int* __restrict__ idx, const float* __restrict__ dist,
              const float* __restrict__ g, int n, int m,
              float* __restrict__ da) {
  const int cloud = blockIdx.y;
  const int i = blockIdx.x * kGatherThreads + threadIdx.x;
  if (i >= n) return;
  const size_t o = static_cast<size_t>(cloud) * n + i;
  const int j = idx[o];
  const float d = dist[o];
  const float s =
      d > kMinDist ? __fdiv_rn(g[o], fmaxf(d, kMinDist)) : 0.f;
  float* out = da + o * 3;
  if (j < 0 || j >= m) {  // not an index K3 returns: make it visible
    out[0] = out[1] = out[2] = __int_as_float(0x7fc00000);
    return;
  }
  const float* ai = a + o * 3;
  const float* bj = b + (static_cast<size_t>(cloud) * m + j) * 3;
  out[0] = __fmul_rn(s, __fsub_rn(ai[0], bj[0]));
  out[1] = __fmul_rn(s, __fsub_rn(ai[1], bj[1]));
  out[2] = __fmul_rn(s, __fsub_rn(ai[2], bj[2]));
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ da,
               int n, int m, float* __restrict__ db) {
  __shared__ int s_idx[kChunkN];
  __shared__ float s_da[kChunkN * 3];
  const int cloud = blockIdx.y;
  const int j = blockIdx.x * kScatterThreads + threadIdx.x;
  const int* ic = idx + static_cast<size_t>(cloud) * n;
  const float* dc = da + static_cast<size_t>(cloud) * n * 3;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int i0 = 0; i0 < n; i0 += kChunkN) {
    const int count = min(kChunkN, n - i0);
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kScatterThreads) {
      s_idx[t] = ic[i0 + t];
    }
    for (int t = threadIdx.x; t < count * 3; t += kScatterThreads) {
      s_da[t] = dc[static_cast<size_t>(i0) * 3 + t];
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < count; ++t) {
      if (s_idx[t] == j) {
        sx = __fadd_rn(sx, s_da[3 * t]);
        sy = __fadd_rn(sy, s_da[3 * t + 1]);
        sz = __fadd_rn(sz, s_da[3 * t + 2]);
      }
    }
  }
  if (j < m) {
    float* out = db + (static_cast<size_t>(cloud) * m + j) * 3;
    // 0 - s rather than -s: a target nothing chose gets +0, as the plain
    // version's zero-initialised scatter gives
    out[0] = __fsub_rn(0.f, sx);
    out[1] = __fsub_rn(0.f, sy);
    out[2] = __fsub_rn(0.f, sz);
  }
}

bool bad_shape(int batch, int n, int m) {
  return batch < 1 || batch > 65535 || n < 1 || m < 1;
}

}  // namespace

// a (B, N, 3), b (B, M, 3), idx (B, N) int32, dist (B, N), g (B, N), all
// f32 but idx -> da (B, N, 3) f32.
GRL_EXPORT int grl_nn_grad_a(const float* a, const float* b, const int* idx,
                             const float* dist, const float* g, int batch,
                             int n, int m, float* da, void* stream) {
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kGatherThreads - 1) / kGatherThreads, batch);
  gather_kernel<<<grid, kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, idx, dist, g, n,
                                                       m, da);
  return static_cast<int>(cudaGetLastError());
}

// idx (B, N) int32, da (B, N, 3) f32 -> db (B, M, 3) f32.
GRL_EXPORT int grl_nn_grad_b(const int* idx, const float* da, int batch,
                             int n, int m, float* db, void* stream) {
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kScatterThreads - 1) / kScatterThreads, batch);
  scatter_kernel<<<grid, kScatterThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(idx, da, n, m, db);
  return static_cast<int>(cudaGetLastError());
}
