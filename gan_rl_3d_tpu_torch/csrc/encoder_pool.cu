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
// 23.7 GFLOP, 0.35 ms at the 67 TFLOP/s f32 CUDA-core rate.
//
// What the design does about it: one block takes kTile=32 points of one
// cloud through every layer, ping-ponging the activations between two
// shared-memory buffers laid out [channel][point] (at most 256 x 32 x 4 B
// = 32 KB each), so no activation reaches device memory, which was the
// point of the TPU kernel. The 90k weights are read through L2, which every
// block shares. A thread owns one output channel for 8 points: per input
// channel it loads one weight and two broadcast float4s for 8 FMAs. The
// blocks of one cloud combine their tile maxima with atomicMax on an
// order-preserving int encoding of the float; max is exact in any order, so
// the result is deterministic. A last small pass decodes it.
//
// The bf16 variant keeps the JAX rounding points: the input and every layer
// output are rounded to bf16, bf16 weights are widened to f32 and summed in
// f32, biases stay f32. Both variants run on the CUDA cores; the tensor
// cores (wgmma) are later work.

#include <cuda_bf16.h>

#include "common.cuh"
#include "pool.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPointsPerThread = 8;
constexpr int kGroups = kTile / kPointsPerThread;
constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;

struct Layers {
  const void* w[kMaxLayers];   // (C_in, C_out) row-major, f32 or bf16
  const float* b[kMaxLayers];  // (C_out,) f32
  int dim[kMaxLayers + 1];     // dim[0] == 3
  int n;
};

template <bool kBf16>
__device__ __forceinline__ float weight(const void* w, int i) {
  if constexpr (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  } else {
    return static_cast<const float*>(w)[i];
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

template <bool kBf16, bool kMasked>
__global__ void __launch_bounds__(kThreads)
encoder_pool_kernel(const float* __restrict__ pc,
                    const float* __restrict__ mask, const Layers layers,
                    int n_points, int width, int* __restrict__ pooled) {
  extern __shared__ float4 smem4[];
  __shared__ bool valid[kTile];
  float* in = reinterpret_cast<float*>(smem4);
  float* out = in + width * kTile;

  const int cloud = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int live = min(kTile, n_points - p0);
  const size_t row0 = static_cast<size_t>(cloud) * n_points + p0;

  if (tid < kTile) {
    bool v = tid < live;
    if (kMasked && v) v = mask[row0 + tid] > 0.f;
    valid[tid] = v;
  }
  for (int i = tid; i < 3 * kTile; i += kThreads) {
    const int p = i / 3;
    const int k = i - 3 * p;
    const float v = p < live ? pc[(row0 + p) * 3 + k] : 0.f;
    in[k * kTile + p] = act<kBf16>(v);
  }
  __syncthreads();

  for (int l = 0; l < layers.n; ++l) {
    const int K = layers.dim[l];
    const int C = layers.dim[l + 1];
    const void* w = layers.w[l];
    for (int item = tid; item < C * kGroups; item += kThreads) {
      const int g = item % kGroups;
      const int c = item / kGroups;
      const float* x = in + g * kPointsPerThread;
      float acc[kPointsPerThread];
      if (l == 0) {
        // K = 3 as the TPU kernel's three products, same association
        // ((x0*w0 + x1*w1) + x2*w2), no FMA contraction
        const float w0 = weight<kBf16>(w, c);
        const float w1 = weight<kBf16>(w, C + c);
        const float w2 = weight<kBf16>(w, 2 * C + c);
#pragma unroll
        for (int j = 0; j < kPointsPerThread; ++j) {
          acc[j] = __fadd_rn(__fadd_rn(__fmul_rn(x[j], w0),
                                       __fmul_rn(x[kTile + j], w1)),
                             __fmul_rn(x[2 * kTile + j], w2));
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPointsPerThread; ++j) acc[j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float wk = weight<kBf16>(w, k * C + c);
          const float4 lo = *reinterpret_cast<const float4*>(x + k * kTile);
          const float4 hi =
              *reinterpret_cast<const float4*>(x + k * kTile + 4);
          acc[0] = fmaf(lo.x, wk, acc[0]);
          acc[1] = fmaf(lo.y, wk, acc[1]);
          acc[2] = fmaf(lo.z, wk, acc[2]);
          acc[3] = fmaf(lo.w, wk, acc[3]);
          acc[4] = fmaf(hi.x, wk, acc[4]);
          acc[5] = fmaf(hi.y, wk, acc[5]);
          acc[6] = fmaf(hi.z, wk, acc[6]);
          acc[7] = fmaf(hi.w, wk, acc[7]);
        }
      }
      const float bias = layers.b[l][c];
      float4 lo, hi;
      lo.x = act<kBf16>(fmaxf(acc[0] + bias, 0.f));
      lo.y = act<kBf16>(fmaxf(acc[1] + bias, 0.f));
      lo.z = act<kBf16>(fmaxf(acc[2] + bias, 0.f));
      lo.w = act<kBf16>(fmaxf(acc[3] + bias, 0.f));
      hi.x = act<kBf16>(fmaxf(acc[4] + bias, 0.f));
      hi.y = act<kBf16>(fmaxf(acc[5] + bias, 0.f));
      hi.z = act<kBf16>(fmaxf(acc[6] + bias, 0.f));
      hi.w = act<kBf16>(fmaxf(acc[7] + bias, 0.f));
      float* y = out + c * kTile + g * kPointsPerThread;
      *reinterpret_cast<float4*>(y) = lo;
      *reinterpret_cast<float4*>(y + 4) = hi;
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }

  const int C = layers.dim[layers.n];
  for (int c = tid; c < C; c += kThreads) {
    float m = neg_inf();
    // start each channel at its own point so a warp's reads hit 32 banks
    for (int p = 0; p < kTile; ++p) {
      const int q = (p + c) & (kTile - 1);
      if (valid[q]) m = fmaxf(m, in[c * kTile + q]);
    }
    if (m > neg_inf()) {
      atomicMax(pooled + static_cast<size_t>(cloud) * C + c, ordered(m));
    }
  }
}

template <bool kBf16, bool kMasked>
void launch_main(dim3 grid, size_t smem, cudaStream_t s, const float* pc,
                 const float* mask, const Layers& layers, int n_points,
                 int width, int* pooled) {
  auto kernel = encoder_pool_kernel<kBf16, kMasked>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, kThreads, smem, s>>>(pc, mask, layers, n_points, width,
                                      pooled);
}

}  // namespace

// pc (B, N, 3) f32; mask (B, N) f32 or null; weights[l] (dims[l],
// dims[l+1]) f32 (bf16 == 0) or bf16; biases[l] (dims[l+1]) f32;
// pooled_bits (B, dims[n]) int32 scratch; out (B, dims[n]) f32.
GRL_EXPORT int grl_encoder_pool(const float* pc, const float* mask,
                                const void* const* weights,
                                const float* const* biases, const int* dims,
                                int n_layers, int bf16, int batch,
                                int n_points, int* pooled_bits, float* out,
                                void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims[0] != 3 || batch < 1 ||
      batch > 65535 || n_points < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers layers{};
  int width = 0;
  for (int l = 0; l < n_layers; ++l) {
    layers.w[l] = weights[l];
    layers.b[l] = biases[l];
  }
  for (int l = 0; l <= n_layers; ++l) {
    layers.dim[l] = dims[l];
    width = dims[l] > width ? dims[l] : width;
  }
  layers.n = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = batch * dims[n_layers];
  const size_t smem = 2 * static_cast<size_t>(width) * kTile * sizeof(float);
  const dim3 grid((n_points + kTile - 1) / kTile, batch);

  pool_init<<<(count + 255) / 256, 256, 0, s>>>(pooled_bits, count);
  if (bf16) {
    if (mask) {
      launch_main<true, true>(grid, smem, s, pc, mask, layers, n_points,
                              width, pooled_bits);
    } else {
      launch_main<true, false>(grid, smem, s, pc, mask, layers, n_points,
                               width, pooled_bits);
    }
  } else {
    if (mask) {
      launch_main<false, true>(grid, smem, s, pc, mask, layers, n_points,
                               width, pooled_bits);
    } else {
      launch_main<false, false>(grid, smem, s, pc, mask, layers, n_points,
                                width, pooled_bits);
    }
  }
  pool_decode<<<(count + 255) / 256, 256, 0, s>>>(pooled_bits, out, count);
  return static_cast<int>(cudaGetLastError());
}
