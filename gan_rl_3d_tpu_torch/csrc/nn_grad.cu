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
// cloud against reading idx and da and writing db (3.7 MB at B=64: 1.1 us).
//
// What the designs do about it:
// K4: one thread per query point; idx, dist and g are coalesced loads, the
//     b row is a 12-byte gather that stays in L1/L2 (b is 24 KB per cloud).
//     The arithmetic uses the IEEE-rounded intrinsics in the order of the
//     JAX expression, so the result is bit-identical to the plain version.
// K5: a deterministic counting sort, O(N + M) work per cloud whatever idx
//     holds, no float atomics. One block of kGroups warps per cloud; warp g
//     owns the g-th contiguous range of query points. What bounds a block
//     is latency (a chain of dependent shared-memory steps and barriers),
//     so each phase keeps many independent operations in flight.
//       0. da and idx are staged in shared memory by coalesced 16-byte
//          loads, eight in flight a thread (4-byte ones where unaligned),
//          and hist is zeroed.
//       1. Each warp counts its range's points per target into its own row
//          hist[g][j] with shared integer atomics (counts are order-free).
//       2. An exclusive scan of hist in key-major order (j, then g) turns
//          it into the first slot of range g's points of target j: the
//          per-target totals go to a bank-skewed array, each thread scans
//          a contiguous run of them, one block-wide scan joins the runs.
//       3. Each warp walks its range again, 32 points at a time, claiming
//          slots from its row with atomics. Where the 32 targets are
//          distinct (no lane's claim differs from the row's value before
//          the claims) that is the slot; otherwise __match_any_sync gives
//          each lane its rank among equal targets of lower lanes, so slots
//          follow increasing i either way. The points of target j then sit
//          in increasing i at order[start_j, end_j), and hist[G-1][j] ends
//          as end_j.
//       4. The positions are cut into one equal share a thread; a thread
//          sums each segment that starts in its share (balanced by points,
//          not by targets), from 0.f with __fadd_rn in increasing i, and
//          writes 0 - s: the same adds in the same order as a plain loop
//          over increasing i, so two launches give the same bits and the
//          ordered plain version equals the kernel bit for bit. Targets
//          nothing chose get +0.
//     Where a cloud's arrays fit kSharedLimit bytes of shared memory
//     (N = M = 2048: 112.3 KB, two blocks an SM) they live there;
//     otherwise hist, the totals and order live in a global scratch the
//     wrapper allocates
//     (grl_nn_grad_b_scratch words per cloud) and idx and da are read
//     through L1/L2. Indices outside [0, M) are skipped.
// Any N and M: ragged edges are masked.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 256;
constexpr int kGroups = kScatterThreads / 32;  // point ranges, one per warp
constexpr int kStageLoads = 8;  // 16-byte loads a thread has in flight
// two blocks an SM: 228 KB less 1 KB reserved and 32 B static per block
constexpr size_t kSharedLimit = 228 * 1024 / 2 - 1024 - 32;
constexpr float kMinDist = 1e-6f;

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const int* __restrict__ idx, const float* __restrict__ dist,
              const float* __restrict__ g, int n, int m,
              int blocks_per_cloud, float* __restrict__ da) {
  // the batch is folded into grid.x (grid.y would cap it at 65,535)
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i =
      (blockIdx.x - cloud * blocks_per_cloud) * kGatherThreads + threadIdx.x;
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

// The per-target totals of the scan, at j + j / 32 so that a thread's
// contiguous run of targets falls in other banks than its neighbours'.
__host__ __device__ inline int skew(int j) { return j + (j >> 5); }

// Words of the totals, a multiple of 4.
__host__ __device__ inline int tot_words(int m) { return (skew(m) + 4) & ~3; }

// Words of hist (kGroups x M), the totals and order (N) per cloud: a
// multiple of 4 when N is, so that the staged da and idx are 16-byte
// aligned.
__host__ __device__ inline size_t sort_words(int n, int m) {
  return static_cast<size_t>(kGroups) * m + tot_words(m) + n;
}

// Shared bytes of a cloud: the sort's words, then da and idx staged.
__host__ inline size_t shared_bytes(int n, int m) {
  return (sort_words(n, m) + 4 * static_cast<size_t>(n)) * 4;
}

__host__ inline bool fits_shared(int n, int m) {
  return shared_bytes(n, m) <= kSharedLimit;
}

// Exclusive scan of v over the block (called once per launch: warp_sums
// is not reused).
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) before += w < warp ? warp_sums[w] : 0;
  return before + x - v;
}

template <bool kShared>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ da,
               int n, int m, int* __restrict__ scratch,
               float* __restrict__ db) {
  extern __shared__ int4 smem4[];
  __shared__ int warp_sums[kGroups];
  const int cloud = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int* ic = idx + static_cast<size_t>(cloud) * n;  // staged if kShared
  const float* src = da + static_cast<size_t>(cloud) * n * 3;
  int* hist;
  if constexpr (kShared) {
    hist = reinterpret_cast<int*>(smem4);
    float* s_da = reinterpret_cast<float*>(hist + sort_words(n, m));
    int* s_idx = reinterpret_cast<int*>(s_da + 3 * n);
    const bool aligned =
        n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(ic)) % 16 == 0;
    if (aligned) {  // da, idx and both staged copies 16-byte aligned
      // n 16-byte words: 3n/4 of da, then n/4 of idx; eight loads in
      // flight a thread before the first store
      const int q = 3 * n / 4;
      const int4* da4 = reinterpret_cast<const int4*>(src);
      const int4* idx4 = reinterpret_cast<const int4*>(ic);
      int4* s_da4 = reinterpret_cast<int4*>(s_da);
      int4* s_idx4 = reinterpret_cast<int4*>(s_idx);
      for (int t0 = tid; t0 < n; t0 += kStageLoads * kScatterThreads) {
        int4 v[kStageLoads];
#pragma unroll
        for (int r = 0; r < kStageLoads; ++r) {
          const int t = t0 + r * kScatterThreads;
          if (t < n) v[r] = t < q ? da4[t] : idx4[t - q];
        }
#pragma unroll
        for (int r = 0; r < kStageLoads; ++r) {
          const int t = t0 + r * kScatterThreads;
          if (t < q) {
            s_da4[t] = v[r];
          } else if (t < n) {
            s_idx4[t - q] = v[r];
          }
        }
      }
    } else {
#pragma unroll 8
      for (int t = tid; t < 3 * n; t += kScatterThreads) s_da[t] = src[t];
#pragma unroll 8
      for (int t = tid; t < n; t += kScatterThreads) s_idx[t] = ic[t];
    }
#pragma unroll 4
    for (int t = tid; t < kGroups * m / 4; t += kScatterThreads) {
      reinterpret_cast<int4*>(hist)[t] = make_int4(0, 0, 0, 0);
    }
    src = s_da;
    ic = s_idx;
  } else {
    hist = scratch + static_cast<size_t>(cloud) * sort_words(n, m);
    for (int t = tid; t < kGroups * m; t += kScatterThreads) hist[t] = 0;
  }
  int* tot = hist + static_cast<size_t>(kGroups) * m;
  int* order = tot + tot_words(m);
  __syncthreads();

  // 1. per-range counts
  const int span = (n + kGroups - 1) / kGroups;
  const int lo = g * span;
  const int hi = min(n, lo + span);
  int* row = hist + static_cast<size_t>(g) * m;
  for (int i = lo + lane; i < hi; i += 32) {
    const int j = ic[i];
    if (j >= 0 && j < m) atomicAdd(row + j, 1);
  }
  __syncthreads();

  // 2. key-major exclusive scan: hist[g][j] = start_j + sum_{g' < g} count
  for (int j = tid; j < m; j += kScatterThreads) {
    int total = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) total += hist[q * m + j];
    tot[skew(j)] = total;
  }
  __syncthreads();
  const int run_len = (m + kScatterThreads - 1) / kScatterThreads;
  const int j0 = min(m, tid * run_len);
  const int j1 = min(m, j0 + run_len);
  int run_sum = 0;
  for (int j = j0; j < j1; ++j) run_sum += tot[skew(j)];
  int run = block_exclusive_scan(run_sum, warp_sums);
  for (int j = j0; j < j1; ++j) {
    const int c = tot[skew(j)];
    tot[skew(j)] = run;
    run += c;
  }
  __syncthreads();
  for (int j = tid; j < m; j += kScatterThreads) {
    int start = tot[skew(j)];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int c = hist[q * m + j];
      hist[q * m + j] = start;
      start += c;
    }
  }
  __syncthreads();

  // 3. stable placement: slots in increasing i within each target
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int j = i < hi ? ic[i] : -1;
    if (j >= m) j = -1;
    const int before = j >= 0 ? row[j] : 0;
    __syncwarp();
    int slot = j >= 0 ? atomicAdd(row + j, 1) : 0;
    if (__any_sync(0xffffffffu, slot != before)) {
      // equal targets in this chunk: rank them by lane
      const unsigned same = __match_any_sync(0xffffffffu, j);
      slot = before + __popc(same & below);
    }
    if (j >= 0) order[slot] = i;
    __syncwarp();
  }
  __syncthreads();

  // 4. the positions are cut into equal shares, one a thread; a thread
  // sums every segment that starts in its share, in increasing i, so the
  // work is balanced by points and not by targets
  const int* ends = hist + static_cast<size_t>(kGroups - 1) * m;
  for (int j = tid; j < m; j += kScatterThreads) {
    if (ends[j] == (j > 0 ? ends[j - 1] : 0)) {  // a target nothing chose
      float* out = db + (static_cast<size_t>(cloud) * m + j) * 3;
      out[0] = out[1] = out[2] = 0.f;
    }
  }
  const int total = ends[m - 1];
  const int share = (total + kScatterThreads - 1) / kScatterThreads;
  const int p_hi = min(total, (tid + 1) * share);
  int p = min(total, tid * share);
  if (p > 0 && p < p_hi) {
    const int j = ic[order[p]];
    if (j == ic[order[p - 1]]) p = ends[j];  // an earlier share's segment
  }
  while (p < p_hi) {
    const int j = ic[order[p]];
    const int end = ends[j];
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (; p < end; ++p) {
      const float* d = src + 3 * order[p];
      sx = __fadd_rn(sx, d[0]);
      sy = __fadd_rn(sy, d[1]);
      sz = __fadd_rn(sz, d[2]);
    }
    float* out = db + (static_cast<size_t>(cloud) * m + j) * 3;
    // 0 - s rather than -s: -0 sums give +0, as the plain version does
    out[0] = __fsub_rn(0.f, sx);
    out[1] = __fsub_rn(0.f, sy);
    out[2] = __fsub_rn(0.f, sz);
  }
}

}  // namespace

// a (B, N, 3), b (B, M, 3), idx (B, N) int32, dist (B, N), g (B, N), all
// f32 but idx -> da (B, N, 3) f32.
GRL_EXPORT int grl_nn_grad_a(const float* a, const float* b, const int* idx,
                             const float* dist, const float* g, int batch,
                             int n, int m, float* da, void* stream) {
  const int blocks_per_cloud = (n + kGatherThreads - 1) / kGatherThreads;
  if (batch < 1 || n < 1 || m < 1 ||
      static_cast<long long>(blocks_per_cloud) * batch > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_kernel<<<blocks_per_cloud * batch, kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      a, b, idx, dist, g, n, m, blocks_per_cloud, da);
  return static_cast<int>(cudaGetLastError());
}

// int32 words of global scratch per cloud that grl_nn_grad_b needs (0 when
// a cloud fits shared memory).
GRL_EXPORT long long grl_nn_grad_b_scratch(int n, int m) {
  return fits_shared(n, m) ? 0 : static_cast<long long>(sort_words(n, m));
}

// idx (B, N) int32, da (B, N, 3) f32, scratch (B, grl_nn_grad_b_scratch)
// int32 or null -> db (B, M, 3) f32.
GRL_EXPORT int grl_nn_grad_b(const int* idx, const float* da, int batch,
                             int n, int m, int* scratch, float* db,
                             void* stream) {
  if (batch < 1 || n < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits_shared(n, m)) {
    const size_t smem = shared_bytes(n, m);
    // once, so that a launch inside a CUDA graph capture makes no such call
    static const cudaError_t set = cudaFuncSetAttribute(
        scatter_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSharedLimit));
    if (set != cudaSuccess) return static_cast<int>(set);
    scatter_kernel<true><<<batch, kScatterThreads, smem, s>>>(
        idx, da, n, m, nullptr, db);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    scatter_kernel<false><<<batch, kScatterThreads, 0, s>>>(idx, da, n, m,
                                                           scratch, db);
  }
  return static_cast<int>(cudaGetLastError());
}
