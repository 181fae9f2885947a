// K1: fused encoder point-MLP + masked global max-pool.
//
// Replaces the Pallas kernel gan_rl_3d_tpu/ops/encoder_kernel.py::_make_kernel
// (launched by fused_encoder_pool, encoder_kernel.py:101-160): the BN-folded
// point-MLP 3->64->128->128->256->128, each layer +b and ReLU, layer 0 as
// three f32 products, padded points set to -inf by the mask, then the max
// over the N points of each cloud.
//
// What bounds it on an H100: operations. A point costs
// 2*(3*64 + 64*128 + 128*128 + 128*256 + 256*128) = 180,608 flop for 12
// input bytes, far above the card's ops:byte ridge; at B=64, N=2048 that is
// 23.7 GFLOP, 0.35 ms at the 67 TFLOP/s f32 CUDA-core rate. So the design
// has to keep the FMA pipe fed: few instructions that are not FMAs, and
// operands that come from registers.
//
// What the design does about it:
// - Register tiling. A block of 256 threads takes a tile of kTile points
//   (128 for the flagship widths) through every layer. Each thread owns an
//   8-channel x 8-point outer-product tile (64 f32 sums in registers); per
//   input channel k it reads two float4 of activations and two of weights
//   from shared memory for 64 FMAs. A thread's points are {4tp..4tp+3} and
//   the same plus kTile/2, its channels likewise, so the eight threads of a
//   quarter-warp read 128 contiguous bytes: no bank conflicts. At 128
//   points a pass covers 128 channels, the width of most flagship layers,
//   so few threads compute padding channels (at 64 points a pass covers
//   256, and the 64- and 128-wide layers waste half of it: 74.5 ms against
//   40.5 ms at B=4096, H100 80GB HBM3, 700 W).
// - Activations never leave the chip: two shared buffers laid out
//   [channel][point] ping-pong between layers, each sized by the widths it
//   holds (the flagship's 3/128/256 and 64/128: 192 KB at kTile = 128). The
//   last layer's outputs go straight from registers to the pool.
// - Weights staged in shared memory in slabs of kSlabWords (k rows x the
//   block's channel tile), double-buffered: a thread issues its loads of
//   slab s+1 before the FMAs on slab s and stores them after, so the L2
//   latency hides behind 1,024 FMAs a thread. With 128 points a tile, each
//   weight read from L2 serves four times as many points as a 32-point
//   tile does (about 24 GB of L2 reads at B=4096, N=2048). Slabs are
//   f32 in shared memory; the bf16 variant widens there. A full slab runs
//   unrolled with no bounds test; only a ragged last slab tests k < K.
// - Persistent blocks: as many as fit on the SMs (one at the flagship
//   widths, 213 KB) walk over the B x ceil(N / kTile) tiles. Their count
//   is queried once per instance, shared memory and device (launch.cuh).
// - Pooling: each thread takes the max over its valid points, the threads
//   sharing channels combine by warp shuffles, and one atomicMax per
//   channel per tile on the order-preserving int encoding (pool.cuh)
//   combines the tiles. Max is exact in any order: deterministic.
// Where the widths do not fit the 128-point tile, a 32-point instance of
// the same template takes them, with its weights read through L1 instead
// of shared memory, which leaves all of it to the activations (up to 907 +
// 907 channels). The wrapper picks the instance (encoder_kernel.py::
// encoder_tile); what neither fits is refused.
//
// Numerics, the same bits as the plain chain of products: every output is
// acc = 0, fmaf(x_k, w_kc, acc) over increasing k, + bias, ReLU; layer 0 as
// ((x0*w0 + x1*w1) + x2*w2) with IEEE-rounded products and adds, the TPU
// kernel's association. Input channels past K are skipped, not multiplied by
// zero, so no -0 or NaN is summed in. The bf16 variant keeps the JAX
// rounding points: the input and every layer output are rounded to bf16,
// bf16 weights are widened to f32 and summed in f32, biases stay f32. Both
// run on the CUDA cores. bf16 engines whose widths the tensor-core instance
// takes (at most 256 after padding to 16) run csrc/encoder_pool_bf16.cu
// instead; this bf16 variant takes the wider ones (encoder_kernel.py::
// bf16_instance).

#include <cuda_bf16.h>

#include <climits>

#include "common.cuh"
#include "launch.cuh"
#include "pool.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;
constexpr int kSlabWords = 2048;  // one weight slab: kSlab(T) x kChTile(T)
constexpr int kMaxSmem = 232448;

// The instance's tiles: kTile points, kChTile channels a pass, kSlab input
// channels a weight slab; weights staged in shared memory for kTile >= 128.
template <int kTile>
struct Tiles {
  static constexpr int kPtThreads = kTile / 8;
  static constexpr int kChThreads = kThreads / kPtThreads;
  static constexpr int kChTile = 8 * kChThreads;
  static constexpr int kSlab = kSlabWords / kChTile;
  static constexpr bool kStaged = kTile >= 128;
};

struct Layers {
  const void* w[kMaxLayers];   // (C_in, C_out) row-major, f32 or bf16
  const float* b[kMaxLayers];  // (C_out,) f32
  int dim[kMaxLayers + 1];     // dim[0] == 3
  int n;
};

// Shared-memory words of an instance: buffer A holds the inputs of the
// even layers, B of the odd ones (the last layer's output is pooled from
// registers); then the weight slabs and the points' valid flags.
struct Layout {
  int a, b, slab, valid, words;
};

inline Layout make_layout(const Layers& L, int tile) {
  int wa = 0, wb = 0;
  for (int l = 0; l < L.n; ++l) {
    int& w = (l % 2 == 0) ? wa : wb;
    w = L.dim[l] > w ? L.dim[l] : w;
  }
  Layout o{};
  o.a = 0;
  o.b = wa * tile;
  o.slab = o.b + wb * tile;
  o.valid = o.slab + (tile >= 128 ? 2 * kSlabWords : 0);
  o.words = o.valid + tile;
  return o;
}

template <bool kBf16>
__device__ __forceinline__ float weight(const void* w, size_t i) {
  if constexpr (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else {
    return __ldg(static_cast<const float*>(w) + i);
  }
}

template <bool kBf16>
__device__ __forceinline__ float act(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

// A thread's 8 channels (j < 4: c0 + j, else c0 + half + j - 4) or points.
__device__ __forceinline__ int lane_of(int base, int half, int j) {
  return base + (j < 4 ? j : half + j - 4);
}

// Bias, ReLU and rounding of a thread's 8x8 tile; then either stored to
// the next layer's buffer [channel][point] (channels < C), or pooled: the
// max over the valid points, combined over the threads sharing the
// channels, one atomicMax per channel.
template <int kTile, bool kBf16>
__device__ __forceinline__ void epilogue(float (&acc)[8][8], const float* bias,
                                         int C, int c0, int p0, bool last,
                                         float* out, const int* valid,
                                         int* pooled) {
  using T = Tiles<kTile>;
  constexpr int kHalfCh = T::kChTile / 2;
  constexpr int kHalfPt = kTile / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = lane_of(c0, kHalfCh, i);
    const float bc = c < C ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = act<kBf16>(fmaxf(acc[i][j] + bc, 0.f));
  }
  if (!last) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane_of(c0, kHalfCh, i);
      if (c < C) {
        float* row = out + c * kTile + p0;
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + kHalfPt) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    return;
  }
  bool ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ok[j] = valid[lane_of(p0, kHalfPt, j)] != 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = neg_inf();
#pragma unroll
    for (int j = 0; j < 8; ++j) m = ok[j] ? fmaxf(m, acc[i][j]) : m;
    // the kPtThreads threads of these channels are consecutive lanes
#pragma unroll
    for (int d = T::kPtThreads / 2; d > 0; d >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    }
    const int c = lane_of(c0, kHalfCh, i);
    if (p0 == 0 && c < C && m > neg_inf()) atomicMax(pooled + c, ordered(m));
  }
}

// One input channel k of the outer product: the thread's 8 activations
// (x: its first point of row k) times its 8 weights wv,
// acc[i][j] = fmaf(x_j, w_i, acc[i][j]).
template <int kTile>
__device__ __forceinline__ void fma_step(float (&acc)[8][8], const float* x,
                                         const float (&wv)[8]) {
  const float4 xa = *reinterpret_cast<const float4*>(x);
  const float4 xb = *reinterpret_cast<const float4*>(x + kTile / 2);
  const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[j], wv[i], acc[i][j]);
  }
}

// The same with the weights read from a staged slab (w: its first channel).
template <int kTile>
__device__ __forceinline__ void fma_step_slab(float (&acc)[8][8],
                                              const float* x,
                                              const float* w) {
  constexpr int kHalfCh = Tiles<kTile>::kChTile / 2;
  const float4 wa = *reinterpret_cast<const float4*>(w);
  const float4 wb = *reinterpret_cast<const float4*>(w + kHalfCh);
  const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  fma_step<kTile>(acc, x, wv);
}

// The staged instance runs one block an SM (213 KB of shared memory at the
// flagship widths), so it may use 255 registers a thread (173 measured);
// the 32-point one keeps two blocks an SM, 128 registers.
template <int kTile, bool kBf16, bool kMasked>
__global__ void __launch_bounds__(kThreads, Tiles<kTile>::kStaged ? 1 : 2)
encoder_pool_kernel(const float* __restrict__ pc,
                    const float* __restrict__ mask, const Layers layers,
                    const Layout lay, int n_points, int n_tiles,
                    int* __restrict__ pooled) {
  using T = Tiles<kTile>;
  constexpr int kHalfCh = T::kChTile / 2;
  constexpr int kHalfPt = kTile / 2;
  constexpr int kPerThread = kSlabWords / kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* valid = reinterpret_cast<int*>(smem + lay.valid);
  float* slabs = smem + lay.slab;

  const int tid = threadIdx.x;
  const int tp = tid % T::kPtThreads;
  const int tc = tid / T::kPtThreads;
  const int p0 = 4 * tp;   // this thread's points: lane_of(p0, kHalfPt, j)
  const int c_off = 4 * tc;  // its channels in a pass: c0 + lane_of(...)
  const int c_out = layers.dim[layers.n];
  const int tiles_per_cloud = (n_points + kTile - 1) / kTile;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int cloud = tile / tiles_per_cloud;
    const int first = (tile - cloud * tiles_per_cloud) * kTile;
    const int live = min(kTile, n_points - first);
    const size_t row0 = static_cast<size_t>(cloud) * n_points + first;
    int* pool = pooled + static_cast<size_t>(cloud) * c_out;

    __syncthreads();  // the previous tile is done with the buffers
    for (int p = tid; p < kTile; p += kThreads) {
      bool v = p < live;
      if (kMasked && v) v = mask[row0 + p] > 0.f;
      valid[p] = v;
    }
    for (int i = tid; i < 3 * kTile; i += kThreads) {
      const int p = i / 3;
      const int k = i - 3 * p;
      const float v = p < live ? pc[(row0 + p) * 3 + k] : 0.f;
      smem[lay.a + k * kTile + p] = act<kBf16>(v);
    }
    __syncthreads();

    for (int l = 0; l < layers.n; ++l) {
      const int K = layers.dim[l];
      const int C = layers.dim[l + 1];
      const void* w = layers.w[l];
      const float* in = smem + (l % 2 == 0 ? lay.a : lay.b);
      float* out = smem + (l % 2 == 0 ? lay.b : lay.a);
      const bool last = l == layers.n - 1;

      for (int ct = 0; ct < C; ct += T::kChTile) {
        float acc[8][8];
        if (l == 0) {
          // K = 3 as the TPU kernel's three products, same association
          // ((x0*w0 + x1*w1) + x2*w2), no FMA contraction
          float x[3][8];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              x[k][j] = in[k * kTile + lane_of(p0, kHalfPt, j)];
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = ct + lane_of(c_off, kHalfCh, i);
            const bool in_c = c < C;
            const float w0 = in_c ? weight<kBf16>(w, c) : 0.f;
            const float w1 = in_c ? weight<kBf16>(w, C + c) : 0.f;
            const float w2 = in_c ? weight<kBf16>(w, 2 * C + c) : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(x[0][j], w0),
                                              __fmul_rn(x[1][j], w1)),
                                    __fmul_rn(x[2][j], w2));
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
          }
          if constexpr (T::kStaged) {
            // slab s covers input channels [s * kSlab, (s + 1) * kSlab) of
            // this pass's kChTile channels, laid out [k][channel]
            float stage[kPerThread];
            auto fetch = [&](int k0) {
#pragma unroll
              for (int r = 0; r < kPerThread; ++r) {
                const int e = tid + r * kThreads;
                const int k = k0 + e / T::kChTile;
                const int c = ct + e % T::kChTile;
                stage[r] = (k < K && c < C)
                               ? weight<kBf16>(w, static_cast<size_t>(k) * C + c)
                               : 0.f;
              }
            };
            auto put = [&](float* slab) {
#pragma unroll
              for (int r = 0; r < kPerThread; ++r) {
                slab[tid + r * kThreads] = stage[r];
              }
            };
            fetch(0);
            put(slabs);
            __syncthreads();
            const int n_slabs = (K + T::kSlab - 1) / T::kSlab;
            for (int s = 0; s < n_slabs; ++s) {
              const int k0 = s * T::kSlab;
              const bool more = s + 1 < n_slabs;
              if (more) fetch(k0 + T::kSlab);
              const float* slab = slabs + (s % 2) * kSlabWords;
              const int k_end = min(T::kSlab, K - k0);
              if (k_end == T::kSlab) {  // full slab: no guard in the way
#pragma unroll
                for (int kk = 0; kk < T::kSlab; ++kk) {
                  fma_step_slab<kTile>(acc, in + (k0 + kk) * kTile + p0,
                                       slab + kk * T::kChTile + c_off);
                }
              } else {
                for (int kk = 0; kk < k_end; ++kk) {
                  fma_step_slab<kTile>(acc, in + (k0 + kk) * kTile + p0,
                                       slab + kk * T::kChTile + c_off);
                }
              }
              if (more) put(slabs + ((s + 1) % 2) * kSlabWords);
              __syncthreads();
            }
          } else {
            // weights through L1: the 32-point instance leaves shared
            // memory to the activations
            for (int k = 0; k < K; ++k) {
              float wv[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int c = ct + lane_of(c_off, kHalfCh, i);
                wv[i] = c < C ? weight<kBf16>(w, static_cast<size_t>(k) * C + c)
                              : 0.f;
              }
              fma_step<kTile>(acc, in + k * kTile + p0, wv);
            }
          }
        }
        epilogue<kTile, kBf16>(acc, layers.b[l], C, ct + c_off, p0, last, out,
                               valid, pool);
      }
      __syncthreads();  // this layer's outputs are the next one's inputs
    }
  }
}

template <int kTile, bool kBf16, bool kMasked>
cudaError_t launch(cudaStream_t s, const float* pc, const float* mask,
                   const Layers& layers, const Layout& lay, int batch,
                   int n_points, int device, int* pooled) {
  auto kernel = encoder_pool_kernel<kTile, kBf16, kMasked>;
  const int smem = lay.words * 4;
  int blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), kThreads, smem, device, &blocks);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(batch) * ((n_points + kTile - 1) / kTile);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  kernel<<<grid, kThreads, smem, s>>>(pc, mask, layers, lay, n_points,
                                      static_cast<int>(tiles), pooled);
  return cudaGetLastError();
}

template <int kTile>
cudaError_t launch_tile(bool bf16, cudaStream_t s, const float* pc,
                        const float* mask, const Layers& layers,
                        const Layout& lay, int batch, int n_points,
                        int device, int* pooled) {
  if (bf16) {
    return mask ? launch<kTile, true, true>(s, pc, mask, layers, lay, batch,
                                            n_points, device, pooled)
                : launch<kTile, true, false>(s, pc, mask, layers, lay, batch,
                                             n_points, device, pooled);
  }
  return mask ? launch<kTile, false, true>(s, pc, mask, layers, lay, batch,
                                           n_points, device, pooled)
              : launch<kTile, false, false>(s, pc, mask, layers, lay, batch,
                                            n_points, device, pooled);
}

}  // namespace

// pc (B, N, 3) f32; mask (B, N) f32 or null; weights[l] (dims[l],
// dims[l+1]) f32 (bf16 == 0) or bf16; biases[l] (dims[l+1]) f32; tile the
// point tile the wrapper picked (128 or 32; encoder_kernel.py::
// encoder_tile); device the current device's index (the caller knows it,
// so no query runs a steady call);
// pooled_bits (B, dims[n]) int32 scratch; out (B, dims[n]) f32.
GRL_EXPORT int grl_encoder_pool(const float* pc, const float* mask,
                                const void* const* weights,
                                const float* const* biases, const int* dims,
                                int n_layers, int bf16, int tile, int batch,
                                int n_points, int device, int* pooled_bits,
                                float* out, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[0] != 3 || batch < 1 ||
      n_points < 1 || (tile != 128 && tile != 32) || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers layers{};
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = weights[l];
    layers.b[l] = biases[l];
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    layers.dim[l] = dims[l];
  }
  layers.n = n_layers;
  const Layout lay = make_layout(layers, tile);
  if (static_cast<long long>(lay.words) * 4 > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = batch * dims[n_layers];
  pool_init<<<(count + 255) / 256, 256, 0, s>>>(pooled_bits, count);
  const cudaError_t err =
      tile == 128 ? launch_tile<128>(bf16, s, pc, mask, layers, lay, batch,
                                     n_points, device, pooled_bits)
                  : launch_tile<32>(bf16, s, pc, mask, layers, lay, batch,
                                    n_points, device, pooled_bits);
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_decode<<<(count + 255) / 256, 256, 0, s>>>(pooled_bits, out, count);
  return static_cast<int>(cudaGetLastError());
}
