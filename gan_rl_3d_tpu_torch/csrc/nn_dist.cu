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
// What bounds it on an H100: operations. Every (a_i, b_j) pair costs about
// 8 f32 flop (3 products, 4 adds, 1 compare) for no extra bytes; at B=64,
// N=M=2048 that is 2.1 GFLOP per direction, 32 us at the 67 TFLOP/s f32
// CUDA-core rate, against 2 MB of input (under 1 us at 3.35 TB/s).
//
// What the design does about it: one thread per query point keeps -2a,
// |a|^2 and its running best in registers; the block walks b in tiles of
// kTileM points staged in shared memory as float4 (x, y, z, |b|^2 + penalty),
// computed once per tile, so the inner loop is one broadcast 16-byte
// shared load and 4 FMA-class instructions plus a compare per pair. The
// distance matrix never exists. j is scanned in increasing order with a
// strict <, which keeps the first index among equal minima, as jnp.argmin
// and the TPU kernel's tile carry (chamfer.py:101-104) do. Any N and M
// work: the ragged edge of a and b is masked here, not padded.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileM = 1024;
constexpr float kBig = 1e30f;

template <bool kKeepIdx, bool kMasked>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ b_mask, int n, int m, int blocks_per_cloud,
          float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 tile[kTileM];
  // the batch is folded into grid.x (grid.y would cap it at 65,535)
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i = (blockIdx.x - cloud * blocks_per_cloud) * kThreads +
                threadIdx.x;
  const bool live = i < n;
  const float* ai = a + (static_cast<size_t>(cloud) * n + (live ? i : 0)) * 3;
  const float ax = ai[0], ay = ai[1], az = ai[2];
  const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                             __fmul_rn(az, az));
  const float nx = -2.f * ax, ny = -2.f * ay, nz = -2.f * az;
  const float* bc = b + static_cast<size_t>(cloud) * m * 3;

  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int j0 = 0; j0 < m; j0 += kTileM) {
    const int count = min(kTileM, m - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const float* p = bc + static_cast<size_t>(j0 + t) * 3;
      const float x = p[0], y = p[1], z = p[2];
      float b2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z));
      if (kMasked) {
        b2 += (1.f - b_mask[static_cast<size_t>(cloud) * m + j0 + t]) * kBig;
      }
      tile[t] = make_float4(x, y, z, b2);
    }
    __syncthreads();
    for (int t = 0; t < count; ++t) {
      const float4 q = tile[t];
      const float cross = fmaf(nz, q.z, fmaf(ny, q.y, nx * q.x));
      const float d2 = (a2 + q.w) + cross;
      if (d2 < best) {
        best = d2;
        if (kKeepIdx) arg = j0 + t;
      }
    }
  }
  if (live) {
    const size_t o = static_cast<size_t>(cloud) * n + i;
    dist[o] = sqrtf(fmaxf(best, 1e-12f));
    if (kKeepIdx) idx[o] = arg;
  }
}

template <bool kKeepIdx>
int launch(const float* a, const float* b, const float* b_mask, int batch,
           int n, int m, float* dist, int* idx, void* stream) {
  const int blocks_per_cloud = (n + kThreads - 1) / kThreads;
  if (batch < 1 || n < 1 || m < 1 ||
      static_cast<long long>(blocks_per_cloud) * batch > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = blocks_per_cloud * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_mask) {
    nn_kernel<kKeepIdx, true><<<grid, kThreads, 0, s>>>(
        a, b, b_mask, n, m, blocks_per_cloud, dist, idx);
  } else {
    nn_kernel<kKeepIdx, false><<<grid, kThreads, 0, s>>>(
        a, b, b_mask, n, m, blocks_per_cloud, dist, idx);
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
