// Training BatchNorm + ReLU after a dense layer, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves dense -> batchnorm_train ->
// relu (gan_rl_3d_tpu/nn.py:114-261) to XLA, which fuses it. Eager PyTorch
// runs the same composite (gan_rl_3d_tpu_torch/nn.py::batchnorm_train) as
// about 14 passes over the activation forward and 25 backward, and its
// Neumaier combine as some 300 launches a layer; these kernels compute the
// same function in two passes each way. ops/bn_train.py binds them as one
// autograd op, z = x @ w coming from cuBLAS without the bias.
//
// With x = z + b (the dense bias) over R rows of C channels:
//   forward  y = relu(((x - mean) * (inv * scale)) + bias), inv =
//            rsqrt(var + eps), the batch statistics by the composite's mode,
//            and the running state (momentum, unbiased variance);
//   backward g = dy [y > 0]; d_bias = sum g; d_scale = inv sum g (x - mean);
//            dz = k g - k sum(g) / R - (x - mean) k inv^2 sum(g (x - mean)) / R
//            with k = inv * scale (the last term 0 where the single-read
//            variance clamped to 0, as the composite's clamp passes no
//            gradient); db = sum dz, summed as autograd sums it.
//
// What bounds them on an H100: bytes. Let T be one read or write of the
// (R, C) f32 activation (1.07 GB at R = 4.19 M, C = 64). The forward reads
// z for the statistics and again to write y (3T; the centered form reads it
// once more); the backward reads z and dy for two channel sums, then both
// again to write dz (5T): 8T a layer, 2.6 ms at 3.35 TB/s for that layer.
// The composite moves about 40T.
//
// What the design does about it:
// * The forward's statistics are the composite's, bit for bit: stats_kernel
//   reads z once and adds x = z + b and x * x (each rounded, as the
//   composite materialises them) in the order in which PyTorch's CUDA
//   reduction (ATen/native/cuda/Reduce.cuh, sum and mean over the rows of a
//   contiguous (groups, rows, C) tensor) adds them: the same block shape,
//   the same rows a thread takes with its four accumulators, the same tree
//   over the block's warps and the same pass over the staged partials of
//   the blocks that split the rows, all from the same (rows, C, SM count).
//   sum_config mirrors setReduceConfig. The composite's statistics are what
//   the rest of the step and its reference were measured with: summed in any
//   other order (more exactly, in f64) they moved the first step's loss by
//   up to 4.5e-6 on an H100, against 2e-7 for the composite. The Neumaier combine of
//   the 8 group sums, the mean, the clamped variance, inv and the running
//   state follow in the composite's f32 operations: y and the state equal
//   the composite's bit for bit. A warp reads whole rows: 512 contiguous
//   bytes at C = 64.
// * rows_kernel streams y and the backward: a block is 256 threads, tx
//   along channels (16-byte loads of 4 channels where C % 4 == 0, else 1),
//   ty = 256 / tx along rows; grid.y tiles the channels, grid.x cuts the
//   rows into about 528 chunks. Its sums run without float atomics: f32 over
//   4 rows, added to f64 accumulators, a fixed tree over the block, one f64
//   partial per chunk and channel summed in chunk order; the order depends
//   only on (R, C), so two runs give the same bits.
// * The last block to arrive (an integer ticket, __threadfence) finalizes
//   each reduction: the statistics and the running state (forward); d_scale,
//   d_bias and dz's two per-channel coefficients (backward); db. So a layer
//   is 2 launches forward (3 in the centered form) and 2 backward.
// * The normalization and its recomputation in the backward use
//   __fadd_rn / __fmul_rn in the composite's order, so that no FMA is
//   contracted and the backward's mask [y > 0] is the forward's.
// * The backward saves nothing but z and the (2, C) statistics: x - mean and
//   y are recomputed from z.
// Any R >= 1 and C >= 1 with R * C < 2^31 (PyTorch splits larger
// reductions); ragged edges are masked.

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // rows a thread loads per step
constexpr int kMaxWidth = 64;    // threads along the channels of a block
constexpr int kTargetBlocks = 528;
constexpr int kMaxGroups = 8;
constexpr int kSumThreads = 512;  // PyTorch's MAX_NUM_THREADS for f32 sums
constexpr int kSumUnroll = 4;     // its vt0: accumulators a thread keeps

enum Pass : int {
  kMoments = 0,   // sums of x and x^2 in each group (single_read_grouped)
  kMean = 1,      // mean of x (the centered form's first read)
  kCentered = 2,  // mean of (x - mean)^2 (its second read)
  kGrad = 3,      // sum of g and of g (x - mean)
  kInput = 4,     // dz, and its sum
  kNormalize = 5  // y
};

struct Args {
  const float* z;
  const float* b;      // the dense bias
  const float* dy;     // the output's gradient (backward)
  const float* scale;
  const float* bias;
  const float* run_mean;  // the running state (forward)
  const float* run_var;
  float* stats;  // (2, C): mean, inv (negated where the variance clamped)
  float* coef;   // (2, C): dz's coefficients (backward)
  float* out;    // y or dz
  float* res0;   // new running mean / d_scale / db
  float* res1;   // new running variance / d_bias
  float* staged;      // stats_kernel: the group sums, then block partials
  double* partials;   // rows_kernel: (chunks, sums, C)
  unsigned* tickets;  // 0 between launches
  int final_ticket;   // stats_kernel: the ticket of the groups' combine
  float inv_n, keep, momentum, unbias, eps;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// The last of `count` blocks to arrive at `ticket`: every block's writes
// before its call are visible to it once it returns true.
__device__ __forceinline__ bool last_arrival(unsigned* ticket,
                                             unsigned count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(ticket, 1u) == count - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// the statistics in PyTorch's reduction order
// ---------------------------------------------------------------------------

// setReduceConfig (Reduce.cuh) for sum / mean over the rows of a contiguous
// (groups, rows, C) f32 tensor, which TensorIterator orders as [rows
// (reduced), C, groups]: outputs run over (C, groups), vectorised by `vec`
// along C ("vectorize along output"); block (bw, bh); a thread's first
// output quad x + y * om1 + blockIdx.x * step_out and first row
// y * im1 + blockIdx.y * im2, then every step_in-th row; ctas blocks
// (grid.y) split the rows where there are many.
struct SumConfig {
  long long rows;  // rows of a group
  int c, groups, vec, bw, bh, om1, im1, im2, step_in, step_out, grid_x, ctas;
  float factor;  // MeanOps' factor: C / (rows * C), in f32
};

inline int last_pow2(int n) {
  n |= n >> 1;
  n |= n >> 2;
  n |= n >> 4;
  n |= n >> 8;
  n |= n >> 16;
  return n - (n >> 1) > 1 ? n - (n >> 1) : 1;
}

inline long long div_up(long long a, long long b) { return (a + b - 1) / b; }

__host__ SumConfig sum_config(long long rows, int c, int groups, int sms,
                              int threads_per_sm) {
  SumConfig k{};
  k.rows = rows / groups;
  k.c = c;
  k.groups = groups;
  k.vec = c % 4 == 0 ? 4 : (c % 2 == 0 ? 2 : 1);
  const long long outputs = static_cast<long long>(groups) * c;
  const int most = kSumThreads / k.vec;
  const long long dim0 = outputs / k.vec, dim1 = k.rows;
  const int p0 = dim0 < most ? last_pow2(static_cast<int>(dim0)) : most;
  const int p1 = dim1 < most ? last_pow2(static_cast<int>(dim1)) : most;
  k.bw = p0 < 32 ? p0 : 32;
  k.bh = p1 < most / k.bw ? p1 : most / k.bw;
  k.bw = p0 < most / k.bh ? p0 : most / k.bh;
  k.step_in = 1;
  k.step_out = k.bw;
  if (k.rows >= (k.bh * 16 < 256 ? k.bh * 16 : 256)) {
    k.im1 = 1;  // the rows split across the block's warps
    k.step_in = k.bh;
  } else {
    k.om1 = k.bw;  // each warp its own outputs
    k.step_out = k.bw * k.bh;
  }
  k.grid_x = static_cast<int>(div_up(dim0, k.step_out));
  k.ctas = 1;
  const long long target = static_cast<long long>(sms) *
                           (threads_per_sm / (k.bw * k.bh));
  const long long per_thread = div_up(k.rows, k.step_in);
  if (k.im1 != 0 && per_thread >= 256 && k.grid_x <= target) {
    const long long a = div_up(target, k.grid_x), b = div_up(per_thread, 16);
    const long long least = div_up(per_thread, 256);
    const long long ctas = a < b ? a : b;
    k.ctas = static_cast<int>(ctas > least ? ctas : least);
    if (k.ctas > 1) {
      k.im2 = k.step_in;
      k.step_in *= k.ctas;
    }
  }
  k.factor = static_cast<float>(c) / static_cast<float>(k.rows * c);
  return k;
}

// f32 words of stats_kernel's scratch: the (2, groups, C) group sums, then
// each block's partials where the rows split across blocks.
__host__ long long staged_words(const SumConfig& k) {
  const long long partials =
      k.ctas > 1 ? static_cast<long long>(k.grid_x) * k.ctas * k.bw * k.vec * 2
                 : 0;
  return 2LL * k.groups * k.c + partials;
}

// Neumaier's compensated sum of v[0], v[stride], ... in order:
// nn._neumaier_combine.
__device__ float neumaier(const float* v, int n, int stride) {
  float s = __ldcg(v), comp = 0.f;
  for (int i = 1; i < n; ++i) {
    const float p = __ldcg(v + i * stride);
    const float t = __fadd_rn(s, p);
    comp = __fadd_rn(comp, fabsf(s) >= fabsf(p)
                               ? __fadd_rn(__fsub_rn(s, t), p)
                               : __fadd_rn(__fsub_rn(p, t), s));
    s = t;
  }
  return __fadd_rn(s, comp);
}

// inv, the saved statistics and the new running state of channel `cc`.
__device__ __forceinline__ void finish_channel(const Args& a, int c, int cc,
                                               float mean, float var,
                                               bool live) {
  const float inv = rsqrtf(__fadd_rn(var, a.eps));
  a.stats[cc] = mean;
  a.stats[c + cc] = live ? inv : -inv;
  a.res0[cc] = __fadd_rn(__fmul_rn(a.keep, a.run_mean[cc]),
                         __fmul_rn(a.momentum, mean));
  a.res1[cc] = __fadd_rn(__fmul_rn(a.keep, a.run_var[cc]),
                         __fmul_rn(a.momentum, __fmul_rn(var, a.unbias)));
}

// The statistics of one mode, each output (group, channel) summed as
// PyTorch's reduction sums it: kMoments the sums of x and of x * x per
// group, then (the last block) the composite's combine; kMean the mean;
// kCentered the mean of (x - mean)^2, then inv and the state.
template <int V, int P>
__global__ void __launch_bounds__(kSumThreads)
stats_kernel(Args a, SumConfig k) {
  constexpr int S = P == kMoments ? 2 : 1;
  __shared__ float tree[kSumThreads * 2];
  const int x = threadIdx.x, y = threadIdx.y;
  const int c = k.c;
  const long long outputs = static_cast<long long>(k.groups) * c;
  const long long o =
      (x + static_cast<long long>(y) * k.om1 +
       static_cast<long long>(blockIdx.x) * k.step_out) * V;
  const long long first = static_cast<long long>(y) * k.im1 +
                          static_cast<long long>(blockIdx.y) * k.im2;
  float val[S][V];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < V; ++j) val[s][j] = 0.f;
  }
  const int ch = static_cast<int>(o % c);
  if (o < outputs && first < k.rows) {
    const float* base = a.z + (o / c) * k.rows * c + ch;
    float bb[V], mean[V];
    load<V>(a.b + ch, bb);
    if constexpr (P == kCentered) load<V>(a.stats + ch, mean);
    float acc[kSumUnroll][S][V];
#pragma unroll
    for (int i = 0; i < kSumUnroll; ++i) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][s][j] = 0.f;
      }
    }
    auto add = [&](float (&sum)[S][V], const float (&z)[V]) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = __fadd_rn(z[j], bb[j]);
        if constexpr (P == kCentered) {
          const float d = __fsub_rn(xv, mean[j]);
          sum[0][j] = __fadd_rn(sum[0][j], __fmul_rn(d, d));
        } else {
          sum[0][j] = __fadd_rn(sum[0][j], xv);
          if constexpr (S == 2) {
            sum[1][j] = __fadd_rn(sum[1][j], __fmul_rn(xv, xv));
          }
        }
      }
    };
    const long long stride = k.step_in, end = k.rows;
    long long idx = first;
    float zv[kSumUnroll][V];
    while (idx + (kSumUnroll - 1) * stride < end) {
#pragma unroll
      for (int i = 0; i < kSumUnroll; ++i) {
        load<V>(base + (idx + i * stride) * c, zv[i]);
      }
#pragma unroll
      for (int i = 0; i < kSumUnroll; ++i) add(acc[i], zv[i]);
      idx += stride * kSumUnroll;
    }
#pragma unroll
    for (int i = 0; i < kSumUnroll; ++i) {  // the tail, one row a slot
      if (idx + i * stride < end) {
        load<V>(base + (idx + i * stride) * c, zv[i]);
        add(acc[i], zv[i]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = acc[0][s][j];
#pragma unroll
        for (int i = 1; i < kSumUnroll; ++i) t = __fadd_rn(t, acc[i][s][j]);
        val[s][j] = t;
      }
    }
  }

  // block_y_reduce: a tree over the warps, value[y] += value[y + offset]
  auto block_y = [&]() {
    const int slot = (x + y * k.bw) * S * V;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < V; ++j) tree[slot + s * V + j] = val[s][j];
    }
    for (int offset = k.bh / 2; offset > 0; offset >>= 1) {
      __syncthreads();
      if (y < offset && y + offset < k.bh) {
        const int other = (x + (y + offset) * k.bw) * S * V;
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            val[s][j] = __fadd_rn(val[s][j], tree[other + s * V + j]);
            tree[slot + s * V + j] = val[s][j];
          }
        }
      }
    }
  };
  if (k.im1 != 0) block_y();
  const bool stores = o < outputs && (k.im1 == 0 || y == 0);

  if (k.ctas > 1) {  // global_reduce: the blocks' partials, in cta order
    float* part = a.staged + 2LL * k.groups * c;
    if (stores) {
      const long long at =
          ((static_cast<long long>(blockIdx.x) * k.ctas + blockIdx.y) * k.bw +
           x) * S * V;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) part[at + s * V + j] = val[s][j];
      }
    }
    if (!last_arrival(a.tickets + blockIdx.x, gridDim.y)) return;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < V; ++j) val[s][j] = 0.f;
    }
    for (int q = y; q < k.ctas; q += k.bh) {
      const long long at =
          ((static_cast<long long>(blockIdx.x) * k.ctas + q) * k.bw + x) *
          S * V;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          val[s][j] = __fadd_rn(val[s][j], __ldcg(part + at + s * V + j));
        }
      }
    }
    block_y();
    if (x == 0 && y == 0) a.tickets[blockIdx.x] = 0;
  }

  if constexpr (P == kMoments) {
    if (stores) {
      const long long g = o / c;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a.staged[(s * k.groups + g) * c + ch + j] = val[s][j];
        }
      }
    }
    // the last block to store combines the groups of every channel
    if (!last_arrival(a.tickets + a.final_ticket, gridDim.x)) return;
    const int tid = x + y * k.bw;
    for (int cc = tid; cc < c; cc += k.bw * k.bh) {
      const float total = neumaier(a.staged + cc, k.groups, c);
      const float total_sq =
          neumaier(a.staged + k.groups * c + cc, k.groups, c);
      // the composite divides by a Python int: a multiply by 1.0f / n
      const float mean = __fmul_rn(total, a.inv_n);
      const float raw =
          __fsub_rn(__fmul_rn(total_sq, a.inv_n), __fmul_rn(mean, mean));
      const float var = isnan(raw) ? raw : fmaxf(raw, 0.f);  // clamp(min=0)
      finish_channel(a, c, cc, mean, var, raw >= 0.f);
    }
    if (tid == 0) a.tickets[a.final_ticket] = 0;
  } else if (stores) {  // one group: each output is its channel's
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float m = __fmul_rn(val[0][j], k.factor);  // MeanOps::project
      if constexpr (P == kMean) {
        a.stats[ch + j] = m;
      } else {
        finish_channel(a, c, ch + j, a.stats[ch + j], m, true);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// y and the backward
// ---------------------------------------------------------------------------

struct Geometry {
  long long rows, chunk_rows;
  int c, vec, tx, ty, tiles, chunks;
};

__host__ Geometry make_geometry(long long rows, int c) {
  Geometry g{};
  g.rows = rows;
  g.c = c;
  g.vec = c % 4 == 0 ? 4 : 1;
  const int cv = c / g.vec;
  g.tx = 1;
  while (g.tx < cv && g.tx < kMaxWidth) g.tx *= 2;
  g.ty = kThreads / g.tx;
  g.tiles = (cv + g.tx - 1) / g.tx;
  const long long by_rows =
      div_up(rows, static_cast<long long>(g.ty) * kUnroll);
  long long chunks = kTargetBlocks / g.tiles;
  if (chunks > by_rows) chunks = by_rows;
  if (chunks < 1) chunks = 1;
  g.chunk_rows = div_up(rows, chunks);
  g.chunks = static_cast<int>(div_up(rows, g.chunk_rows));
  return g;
}

template <int V>
__device__ __forceinline__ void channel(const float* p, int c0, bool active,
                                        float (&v)[V]) {
  if (active) {
    load<V>(p + c0, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
}

template <int P>
__device__ void finish_sums(const Args& a, const Geometry& g, double* sh);

// One pass over a chunk of rows: y (kNormalize), or the backward's sums
// (kGrad) or dz and its sum (kInput): f32 sums of kUnroll rows added to
// f64 accumulators, reduced over the block's rows in a fixed tree, one
// partial per (chunk, sum, channel); the tile's last block finishes.
template <int V, int P>
__global__ void __launch_bounds__(kThreads)
rows_kernel(Args a, Geometry g) {
  constexpr int S = P == kGrad ? 2 : (P == kInput ? 1 : 0);
  __shared__ double sh[S > 0 ? 2 * kThreads * 4 + kThreads : 1];
  const int tid = threadIdx.x;
  const int lx = tid % g.tx;
  const int ly = tid / g.tx;
  const int c = g.c;
  const int c0 = (blockIdx.y * g.tx + lx) * V;
  const bool active = c0 < c;
  const long long r0 = static_cast<long long>(blockIdx.x) * g.chunk_rows;
  const long long r1 = min(r0 + g.chunk_rows, g.rows);

  // the composite's k = inv * scale; inv is saved with the clamp's sign
  float bb[V], mean[V], k[V], bias[V], c1[V], c2[V];
  {
    float inv[V], scale[V];
    channel<V>(a.b, c0, active, bb);
    channel<V>(a.stats, c0, active, mean);
    channel<V>(a.stats + c, c0, active, inv);
    channel<V>(a.scale, c0, active, scale);
    channel<V>(a.bias, c0, active, bias);
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = __fmul_rn(fabsf(inv[j]), scale[j]);
    if constexpr (P == kInput) {
      channel<V>(a.coef, c0, active, c1);
      channel<V>(a.coef + c, c0, active, c2);
    }
  }
  double acc[S > 0 ? S : 1][V];
#pragma unroll
  for (int s = 0; s < (S > 0 ? S : 1); ++s) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[s][j] = 0.0;
  }

  const long long stride = static_cast<long long>(g.ty) * kUnroll;
  for (long long r = r0 + ly; r < r1; r += stride) {
    float zv[kUnroll][V], dv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + static_cast<long long>(u) * g.ty;
      if (active && row < r1) {
        load<V>(a.z + row * c + c0, zv[u]);
        if constexpr (P != kNormalize) load<V>(a.dy + row * c + c0, dv[u]);
      }
    }
    float s0[V], s1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s0[j] = s1[j] = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + static_cast<long long>(u) * g.ty;
      if (!(active && row < r1)) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // y before the ReLU, in the composite's order
        const float xc = __fsub_rn(__fadd_rn(zv[u][j], bb[j]), mean[j]);
        const float y = __fadd_rn(__fmul_rn(xc, k[j]), bias[j]);
        if constexpr (P == kNormalize) {
          o[j] = isnan(y) ? y : fmaxf(y, 0.f);  // torch.relu's clamp_min
        } else {
          const float gr = y > 0.f ? dv[u][j] : 0.f;
          if constexpr (P == kGrad) {
            s0[j] += gr;
            s1[j] = fmaf(gr, xc, s1[j]);
          } else {
            o[j] = fmaf(xc, c2[j], fmaf(k[j], gr, c1[j]));
            s0[j] += o[j];
          }
        }
      }
      if constexpr (P != kGrad) store<V>(a.out + row * c + c0, o);
    }
    if constexpr (S > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0][j] += static_cast<double>(s0[j]);
        if constexpr (S > 1) acc[1][j] += static_cast<double>(s1[j]);
      }
    }
  }
  if constexpr (S > 0) {
    // the block's rows in a fixed tree: sh[(s * V + j) * kThreads + tid]
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < V; ++j) sh[(s * V + j) * kThreads + tid] = acc[s][j];
    }
    __syncthreads();
    for (int half = g.ty / 2; half > 0; half /= 2) {
      if (ly < half) {
#pragma unroll
        for (int q = 0; q < S * V; ++q) {
          sh[q * kThreads + tid] += sh[q * kThreads + tid + half * g.tx];
        }
      }
      __syncthreads();
    }
    if (ly == 0 && active) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a.partials[(static_cast<long long>(blockIdx.x) * S + s) * c + c0 +
                     j] = sh[(s * V + j) * kThreads + tid];
        }
      }
    }
    if (last_arrival(a.tickets + blockIdx.y, gridDim.x)) {
      finish_sums<P>(a, g, sh);
      if (tid == 0) a.tickets[blockIdx.y] = 0;
    }
  }
}

// The tile's last block: sums the partials of each (sum, channel) in chunk
// order, then d_scale, d_bias and dz's coefficients (kGrad) or db (kInput).
template <int P>
__device__ void finish_sums(const Args& a, const Geometry& g, double* sh) {
  constexpr int S = P == kGrad ? 2 : 1;
  const int tid = threadIdx.x;
  const int width = g.tx * g.vec;
  const int first = blockIdx.y * width;
  const int nch = min(width, g.c - first);
  const int items = S * nch;
  // threads per item: up to 32 where there are few items, each summing a
  // strided share of the chunks; the shares are added in order after
  int split = 1;
  while (split < 32 && split * 2 * items <= kThreads) split *= 2;
  double* total = sh;                  // [items], item = s * nch + ch
  double* share = sh + 2 * kThreads * 4;  // [kThreads]
  __syncthreads();
  for (int base = 0; base < items * split; base += kThreads) {
    const int w = base + tid;
    const int item = w / split, part = w % split;
    double t = 0.0;
    if (item < items) {
      const int ch = item % nch, s = item / nch;
      const double* p =
          a.partials + static_cast<long long>(s) * g.c + first + ch;
      const long long step = static_cast<long long>(S) * g.c;
      double t0 = 0.0, t1 = 0.0, t2 = 0.0, t3 = 0.0;
      int q = part;
      for (; q + 3 * split < g.chunks; q += 4 * split) {
        t0 += __ldcg(p + q * step);
        t1 += __ldcg(p + (q + split) * step);
        t2 += __ldcg(p + (q + 2 * split) * step);
        t3 += __ldcg(p + (q + 3 * split) * step);
      }
      for (; q < g.chunks; q += split) t0 += __ldcg(p + q * step);
      t = (t0 + t1) + (t2 + t3);
    }
    share[tid] = t;
    __syncthreads();
    if (part == 0 && item < items) {
      double sum = 0.0;
      for (int j = 0; j < split; ++j) sum += share[tid + j];
      total[item] = sum;
    }
    __syncthreads();
  }
  for (int ch = tid; ch < nch; ch += kThreads) {
    const int cc = first + ch;
    if constexpr (P == kGrad) {
      const double sum_g = total[ch], sum_gx = total[nch + ch];
      const float stored = a.stats[g.c + cc];
      const float inv = fabsf(stored);
      const double k = static_cast<double>(__fmul_rn(inv, a.scale[cc]));
      const double n = static_cast<double>(g.rows);
      a.res0[cc] = __fmul_rn(static_cast<float>(sum_gx), inv);  // d_scale
      a.res1[cc] = static_cast<float>(sum_g);                   // d_bias
      a.coef[cc] = static_cast<float>(-k * sum_g / n);
      a.coef[g.c + cc] =
          stored > 0.f ? static_cast<float>(-k * inv * inv * sum_gx / n) : 0.f;
    } else {
      a.res0[cc] = static_cast<float>(total[ch]);  // db
    }
  }
}

template <int P>
cudaError_t launch_rows(const Args& a, const Geometry& g, cudaStream_t s) {
  const dim3 grid(g.chunks, g.tiles);
  if (g.vec == 4) {
    rows_kernel<4, P><<<grid, kThreads, 0, s>>>(a, g);
  } else {
    rows_kernel<1, P><<<grid, kThreads, 0, s>>>(a, g);
  }
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_stats(const Args& a, const SumConfig& k, cudaStream_t s) {
  const dim3 grid(k.grid_x, k.ctas), block(k.bw, k.bh);
  if (k.vec == 4) {
    stats_kernel<4, P><<<grid, block, 0, s>>>(a, k);
  } else if (k.vec == 2) {
    stats_kernel<2, P><<<grid, block, 0, s>>>(a, k);
  } else {
    stats_kernel<1, P><<<grid, block, 0, s>>>(a, k);
  }
  return cudaGetLastError();
}

// The statistics' configuration on the current device.
cudaError_t device_sum_config(long long rows, int c, bool grouped,
                              SumConfig* k) {
  int device = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  }
  if (err == cudaSuccess) {
    *k = sum_config(rows, c, grouped ? kMaxGroups : 1, sms, threads);
  }
  return err;
}

bool valid(long long rows, int c, int n_tickets) {
  if (rows < 1 || c < 1 || rows >= INT_MAX / c) return false;
  return make_geometry(rows, c).tiles <= n_tickets;
}

}  // namespace

// f64 words of scratch a call with these shapes needs, forward or backward
// (grouped: single_read_grouped's 8 groups), on the current device; -1 for
// shapes the kernels refuse.
GRL_EXPORT long long grl_bn_scratch(long long rows, int c, int grouped) {
  if (rows < 1 || c < 1 || rows >= INT_MAX / c) return -1;
  SumConfig k;
  if (device_sum_config(rows, c, grouped != 0, &k) != cudaSuccess) return -1;
  const long long forward = (staged_words(k) + 1) / 2;
  const long long backward = 2LL * c * make_geometry(rows, c).chunks;
  return forward > backward ? forward : backward;
}

// z (R, C), b, scale, bias, run_mean, run_var (C) f32, all contiguous and
// 16-byte aligned; grouped: R splits into 8 groups (single_read_grouped),
// else the centered form -> stats (2, C), y (R, C), new_mean, new_var (C).
// scratch: grl_bn_scratch words; tickets: n_tickets zeroed words, left
// zeroed.
GRL_EXPORT int grl_bn_forward(const float* z, const float* b,
                              const float* scale, const float* bias,
                              const float* run_mean, const float* run_var,
                              long long rows, int c, int grouped, float keep,
                              float momentum, float unbias, float eps,
                              double* scratch, unsigned* tickets,
                              int n_tickets, float* stats, float* y,
                              float* new_mean, float* new_var, void* stream) {
  if (!valid(rows, c, n_tickets) || (grouped && rows % kMaxGroups != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SumConfig k;
  cudaError_t err = device_sum_config(rows, c, grouped != 0, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k.grid_x >= n_tickets - 1) {  // the last ticket is the combine's
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.z = z;
  a.b = b;
  a.scale = scale;
  a.bias = bias;
  a.run_mean = run_mean;
  a.run_var = run_var;
  a.stats = stats;
  a.out = y;
  a.res0 = new_mean;
  a.res1 = new_var;
  a.staged = reinterpret_cast<float*>(scratch);
  a.tickets = tickets;
  a.final_ticket = n_tickets - 1;
  // the composite divides by a Python int: a multiply by 1.0f / n on CUDA
  a.inv_n = 1.0f / static_cast<float>(rows);
  a.keep = keep;
  a.momentum = momentum;
  a.unbias = unbias;
  a.eps = eps;
  if (grouped) {
    err = launch_stats<kMoments>(a, k, s);
  } else {
    err = launch_stats<kMean>(a, k, s);
    if (err == cudaSuccess) err = launch_stats<kCentered>(a, k, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_rows<kNormalize>(a, make_geometry(rows, c), s));
}

// z (R, C), b, scale, bias (C), stats (2, C) from grl_bn_forward, dy (R, C)
// -> coef (2, C) scratch, dz (R, C), db, d_scale, d_bias (C).
GRL_EXPORT int grl_bn_backward(const float* z, const float* b,
                               const float* scale, const float* bias,
                               const float* stats, const float* dy,
                               long long rows, int c, double* scratch,
                               unsigned* tickets, int n_tickets, float* coef,
                               float* dz, float* db, float* d_scale,
                               float* d_bias, void* stream) {
  if (!valid(rows, c, n_tickets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.z = z;
  a.b = b;
  a.dy = dy;
  a.scale = scale;
  a.bias = bias;
  a.stats = const_cast<float*>(stats);
  a.coef = coef;
  a.partials = scratch;
  a.tickets = tickets;
  const Geometry g = make_geometry(rows, c);
  a.res0 = d_scale;
  a.res1 = d_bias;
  cudaError_t err = launch_rows<kGrad>(a, g, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.out = dz;
  a.res0 = db;
  a.res1 = nullptr;
  return static_cast<int>(launch_rows<kInput>(a, g, s));
}
