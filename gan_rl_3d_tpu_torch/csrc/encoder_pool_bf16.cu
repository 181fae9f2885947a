// K1 bf16 on the bf16 tensor cores: fused encoder point-MLP + masked
// global max-pool with bf16 operands and activations and f32 sums.
//
// Replaces the Pallas kernel gan_rl_3d_tpu/ops/encoder_kernel.py::
// _make_kernel with compute_dtype=bfloat16 (launched by fused_encoder_pool,
// encoder_kernel.py:101-160): the cloud rounded to bf16; layer 0 (K = 3) as
// three f32 products of bf16 values, ((x0 w0 + x1 w1) + x2 w2) + b; every
// later layer a bf16 x bf16 product summed in f32 plus an f32 bias; every
// layer's output through ReLU and rounded to bf16; padded points -inf, then
// the max over the N points of each cloud, returned as f32.
//
// What bounds it on an H100: operations. At the flagship widths
// 3->64->128->128->256->128 a point costs 90,112 bf16 multiply-adds for 12
// input bytes: 1.51e15 flop at B=4096, N=2048, 1.53 ms at the 989 TFLOP/s
// bf16 tensor-core rate.
//
// What the design does about it (K6's warp-slab skeleton,
// encoder_pool_int8.cu, with bf16 in place of int8):
// - Products on the tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32. A
//   warp owns a slab of 16 points of one cloud and takes it through every
//   layer on its own: a layer's outputs for its 16 rows and all C channels
//   stay in registers (the m16n8 accumulator layout, C / 2 values a
//   thread), so there is no block barrier between layers and no
//   activation goes to shared memory.
// - The accumulators are the next layer's A operand as they stand: for
//   thread (g, t), output tiles 2kc and 2kc + 1 hold rows g and g + 8 at
//   columns 2t, 2t + 1, 2t + 8 and 2t + 9 of K chunk kc, which is the
//   m16n8k16 A fragment of that chunk. The epilogue adds the bias, applies
//   the ReLU and packs pairs with cvt.rn.bf16x2.f32: no shuffle and no
//   permutation between layers.
// - Layer 0 stays on the CUDA cores, with the TPU kernel's association in
//   IEEE-rounded products and adds, computed straight into the
//   accumulator layout: its bits equal the plain version's.
// - Weights packed once per engine (ops/encoder_kernel.py::
//   pack_bf16_encoder), in fragment order: for output tile j and K chunk
//   kc the 32 lanes' B fragments (4 bf16, 8 bytes each) are 256 contiguous
//   bytes, one conflict-free 8-byte shared load a lane per mma. The image
//   (183,808 bytes at the flagship widths: 90,112 bf16 weights, f32 w0 and
//   biases) is copied into the shared memory of each persistent block
//   once; one block of 8 warps an SM.
// - Pooling as in K6: running column maxima of the warp's current cloud in
//   registers (8 a thread: lane g of a quad row owns the output tiles
//   j = g mod 8), masked points and rows past N left out, combined across
//   the quad rows by shuffles and into the cloud's pool with atomicMax on
//   the order-preserving int encoding (pool.cuh) when the warp's cloud
//   changes. A fully masked cloud stays -inf.
// - Widths are padded to multiples of 16 with zero weights and zero bias:
//   a padded channel is ReLU(0) = 0 and adds nothing to a product. Every
//   padded width must be at most 256 (the 128 accumulator registers of a
//   16 x 256 slab) and the image must fit shared memory; wider engines run
//   the CUDA-core bf16 instance of encoder_pool.cu (the wrapper picks by
//   the widths, encoder_kernel.py::bf16_instance). The flagship widths get
//   an instance with the widths fixed at compile time (runtime width
//   guards cost K6 3x), other widths a generic one with the same
//   arithmetic.
// What is left: each mma reads its 256-byte B fragment from shared memory,
// about 94.5 GB at B=4096 (3.2 ms at 128 bytes a clock an SM); wgmma, which
// reads B for 64 rows through a shared-memory descriptor, is the next step.
//
// Numerics: not bit for bit. The tensor cores sum the products of a K
// chunk in their own order and precision, and the chunks in another order
// than the plain version's matmul, so a layer output may round to the
// neighbouring bf16 value; held to 2e-2 relative to the plain version
// (chip_smoke.TOL_BF16), as the bf16 engine is held to the f32 one.

#include <climits>

#include "common.cuh"
#include "launch.cuh"
#include "pool.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // points a warp's slab
constexpr int kMaxNT = 32;           // output tiles of 8 channels: 256
constexpr int kMaxKC = kMaxNT / 2;   // K chunks of 16
constexpr int kMaxLayers = 7;        // tensor-core layers after layer 0
constexpr int kMaxSmem = 232448;
// the flagship widths 64 -> 128 -> 128 -> 256 -> 128 (configs/config.yaml)
constexpr int kFlagLayers = 4;
__host__ __device__ constexpr int flag_dim(int i) {
  return i == 0 ? 64 : i == 3 ? 256 : 128;
}

// Padded widths: dim[0] = C0 (layer 0's outputs), dim[l + 1] = tensor-core
// layer l's outputs, all multiples of 16 in [16, 256]; c_last the unpadded
// last width. n = 0 pools layer 0's outputs.
struct Plan {
  int n;
  int dim[kMaxLayers + 1];
  int c_last;
};

// Bytes of the packed image, laid out as pack_bf16_encoder writes it: w0
// (3, C0) and b0 (C0,) f32, then per layer b (C,) f32 and the bf16 weights
// in fragment order (2 K C bytes). Every part is a multiple of 64 bytes.
__host__ __device__ inline int packed_bytes(const Plan& p) {
  int at = 16 * p.dim[0];
  for (int l = 0; l < p.n; ++l) {
    at += 4 * p.dim[l + 1] + 2 * p.dim[l] * p.dim[l + 1];
  }
  return at;
}

// two floats as bf16 (nearest, ties to even): lo in the low half, the
// m16n8k16 A fragment's order
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// v rounded to bf16 (nearest, ties to even), as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(pack_bf16(v, 0.f) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ((x0 w0 + x1 w1) + x2 w2) + b, then ReLU, rounded step by step
__device__ __forceinline__ float layer0(const float (&x)[3], float w0,
                                        float w1, float w2, float b) {
  const float acc = __fadd_rn(__fadd_rn(__fmul_rn(x[0], w0),
                                        __fmul_rn(x[1], w1)),
                              __fmul_rn(x[2], w2));
  return fmaxf(__fadd_rn(acc, b), 0.f);
}

template <bool kFixed>
__device__ __forceinline__ int width(const Plan& p, int i) {
  return kFixed ? flag_dim(i) : p.dim[i];
}

template <bool kMasked, bool kFixed>
__global__ void __launch_bounds__(kThreads, 1)
encoder_pool_bf16_kernel(const float* __restrict__ pc,
                         const float* __restrict__ mask,
                         const int4* __restrict__ packed, const Plan P,
                         int n_points, int slabs_per_cloud, long long n_slabs,
                         int* __restrict__ pooled) {
  extern __shared__ int4 smem4[];
  const int words = packed_bytes(P) / 16;
  for (int i = threadIdx.x; i < words; i += kThreads) smem4[i] = packed[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the quad's rows: g and g + 8
  const int t = lane & 3;   // the thread's columns: 2t, 2t + 1 of each tile
  const int n_layers = kFixed ? kFlagLayers : P.n;
  const int c0 = width<kFixed>(P, 0);
  const float* w0 = reinterpret_cast<const float*>(smem4);
  const float* b0 = w0 + 3 * c0;
  const unsigned char* layer_base =
      reinterpret_cast<const unsigned char*>(smem4) + 16 * c0;

  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  const long long s_end = n_slabs * (gw + 1) / warps;

  float y[kMaxNT][4];  // outputs of the current layer, accumulator layout
  float run[4][2];     // running max of columns 8 (g + 8u) + 2t + e
  long long cloud = -1;

  auto flush = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (g + 8 * u) + 2 * t + e;
        if (c < P.c_last && run[u][e] > neg_inf()) {
          atomicMax(pooled + cloud * P.c_last + c, ordered(run[u][e]));
        }
      }
    }
  };

  for (long long s = n_slabs * gw / warps; s < s_end; ++s) {
    const long long cl = s / slabs_per_cloud;
    if (cl != cloud) {
      if (cloud >= 0) flush();
      cloud = cl;
#pragma unroll
      for (int u = 0; u < 4; ++u) run[u][0] = run[u][1] = neg_inf();
    }
    const int r0 = static_cast<int>(s - cl * slabs_per_cloud) * kRows + g;
    const int r1 = r0 + 8;
    const size_t base = static_cast<size_t>(cl) * n_points;
    float x0[3] = {0.f, 0.f, 0.f}, x1[3] = {0.f, 0.f, 0.f};
    bool v0 = r0 < n_points, v1 = r1 < n_points;
    if (v0) {
      const float* q = pc + (base + r0) * 3;
      x0[0] = round_bf16(q[0]), x0[1] = round_bf16(q[1]);
      x0[2] = round_bf16(q[2]);
      if (kMasked) v0 = mask[base + r0] > 0.f;
    }
    if (v1) {
      const float* q = pc + (base + r1) * 3;
      x1[0] = round_bf16(q[0]), x1[1] = round_bf16(q[1]);
      x1[2] = round_bf16(q[2]);
      if (kMasked) v1 = mask[base + r1] > 0.f;
    }

    // layer 0; tiles past the width are zeroed so that every y is dead
    // between its last read and its next write (no spill of stale tiles)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j < c0 / 8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float wa = w0[c], wb = w0[c0 + c], wc = w0[2 * c0 + c];
          y[j][e] = layer0(x0, wa, wb, wc, b0[c]);
          y[j][2 + e] = layer0(x1, wa, wb, wc, b0[c]);
        }
      } else {
        y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
      }
    }

    const unsigned char* lp = layer_base;
#pragma unroll (kFixed ? kFlagLayers : 1)
    for (int l = 0; l < n_layers; ++l) {
      const int K = width<kFixed>(P, l);
      const int C = width<kFixed>(P, l + 1);
      const float* bias = reinterpret_cast<const float*>(lp);
      const uint2* frag = reinterpret_cast<const uint2*>(lp + 4 * C);
      lp += 4 * C + 2 * K * C;

      // A fragments: the accumulator tiles 2kc and 2kc + 1, rounded to
      // bf16 in pairs
      unsigned a[kMaxKC][4];
#pragma unroll
      for (int kc = 0; kc < kMaxKC; ++kc) {
        if (kc < K / 16) {
          a[kc][0] = pack_bf16(y[2 * kc][0], y[2 * kc][1]);
          a[kc][1] = pack_bf16(y[2 * kc][2], y[2 * kc][3]);
          a[kc][2] = pack_bf16(y[2 * kc + 1][0], y[2 * kc + 1][1]);
          a[kc][3] = pack_bf16(y[2 * kc + 1][2], y[2 * kc + 1][3]);
        } else {
          a[kc][0] = a[kc][1] = a[kc][2] = a[kc][3] = 0u;
        }
      }

      float acc[kMaxNT][4];
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < kMaxKC; ++kc) {
        if (kc < K / 16) {
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j) {
            if (j < C / 8) {
              const uint2 b = frag[(j * (K / 16) + kc) * 32 + lane];
              mma_bf16(acc[j], a[kc], b.x, b.y);
            }
          }
        }
      }

#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j < C / 8) {
          const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
          y[j][0] = fmaxf(acc[j][0] + b.x, 0.f);
          y[j][1] = fmaxf(acc[j][1] + b.y, 0.f);
          y[j][2] = fmaxf(acc[j][2] + b.x, 0.f);
          y[j][3] = fmaxf(acc[j][3] + b.y, 0.f);
        } else {
          y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
        }
      }
    }

    // the slab's column maxima over its valid points, rounded to bf16 as
    // the layer's output is, into the running max
    const int c_out = width<kFixed>(P, n_layers);
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j < c_out / 8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = fmaxf(v0 ? round_bf16(y[j][e]) : neg_inf(),
                          v1 ? round_bf16(y[j][2 + e]) : neg_inf());
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          }
          if (g == (j & 7)) run[j >> 3][e] = fmaxf(run[j >> 3][e], m);
        }
      }
    }
  }
  if (cloud >= 0) flush();
}

bool is_flagship(const Plan& p) {
  if (p.n != kFlagLayers) return false;
  for (int i = 0; i <= p.n; ++i) {
    if (p.dim[i] != flag_dim(i)) return false;
  }
  return true;
}

using Kernel = void (*)(const float*, const float*, const int4*, Plan, int,
                        int, long long, int*);

Kernel pick(bool masked, bool fixed) {
  if (masked) {
    return fixed ? encoder_pool_bf16_kernel<true, true>
                 : encoder_pool_bf16_kernel<true, false>;
  }
  return fixed ? encoder_pool_bf16_kernel<false, true>
               : encoder_pool_bf16_kernel<false, false>;
}

bool make_plan(const int* dims, int n_layers, int c_last, Plan* p) {
  if (n_layers < 0 || n_layers > kMaxLayers) return false;
  *p = Plan{};
  p->n = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 16 || dims[l] > 8 * kMaxNT || dims[l] % 16) return false;
    p->dim[l] = dims[l];
  }
  if (c_last < 1 || c_last > dims[n_layers] || c_last <= dims[n_layers] - 16) {
    return false;
  }
  p->c_last = c_last;
  return true;
}

}  // namespace

// Shared memory the kernel needs for these padded widths (dims[0] = C0,
// then the n_layers tensor-core output widths, every one a multiple of 16
// in [16, 256]): the bytes of the packed image, or -1 if the widths are not
// supported.
GRL_EXPORT int grl_encoder_pool_bf16_smem(const int* dims, int n_layers) {
  Plan p;
  if (!make_plan(dims, n_layers, dims[n_layers], &p)) return -1;
  return packed_bytes(p);
}

// Registers a thread (and local-memory bytes, spills included) of the
// instance, from cudaFuncGetAttributes; -1 on an error.
GRL_EXPORT int grl_encoder_pool_bf16_attributes(int masked, int fixed,
                                                int* local_bytes) {
  cudaFuncAttributes attr{};
  if (cudaFuncGetAttributes(&attr, pick(masked, fixed)) != cudaSuccess) {
    return -1;
  }
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return attr.numRegs;
}

// pc (B, N, 3) f32; mask (B, N) f32 or null; packed: the image of
// pack_bf16_encoder for the padded widths dims (n_layers + 1 of them);
// c_last the unpadded output width; device the current device's index;
// pooled_bits (B, c_last) int32 scratch; out (B, c_last) f32.
GRL_EXPORT int grl_encoder_pool_bf16(const float* pc, const float* mask,
                                     const void* packed, const int* dims,
                                     int n_layers, int c_last, int batch,
                                     int n_points, int device,
                                     int* pooled_bits, float* out,
                                     void* stream) {
  Plan p;
  if (!make_plan(dims, n_layers, c_last, &p) || batch < 1 || n_points < 1 ||
      device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = packed_bytes(p);
  const long long count = static_cast<long long>(batch) * c_last;
  if (smem > kMaxSmem || count > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(mask != nullptr, is_flagship(p));
  int blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), kThreads, smem, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slabs_per_cloud = (n_points + kRows - 1) / kRows;
  const long long n_slabs = static_cast<long long>(batch) * slabs_per_cloud;
  const long long want = (n_slabs + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < blocks ? want : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(count);
  pool_init<<<(n + 255) / 256, 256, 0, s>>>(pooled_bits, n);
  kernel<<<grid, kThreads, smem, s>>>(pc, mask,
                                      static_cast<const int4*>(packed), p,
                                      n_points, slabs_per_cloud, n_slabs,
                                      pooled_bits);
  pool_decode<<<(n + 255) / 256, 256, 0, s>>>(pooled_bits, out, n);
  return static_cast<int>(cudaGetLastError());
}
