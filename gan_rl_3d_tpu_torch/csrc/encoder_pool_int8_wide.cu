// K6, wide instance: int8 encoder point-MLP + masked global max-pool for
// bundles that the mma.sync instance (encoder_pool_int8.cu) does not take,
// a padded width above 256 or a bundle larger than shared memory.
//
// Replaces the same Pallas kernel as encoder_pool_int8.cu,
// gan_rl_3d_tpu/ops/encoder_kernel.py::_make_int8_kernel (launched by
// fused_encoder_pool_int8, encoder_kernel.py:204-258), with the same
// arithmetic and the same bits: layer 0 as three f32 products, then per
// quantized layer the row scale, the int8 row, the exact int32 product and
// relu((acc * s_x) * s_w + b) (int8_quantize.cuh, shared with the mma.sync
// instance); padded points -inf, then the max over the N points.
//
// What bounds it: operations, as for the mma.sync instance (180,224 int8
// ops a point at the flagship widths), but this instance runs its products
// on the CUDA cores (__dp4a, four multiply-adds an instruction), so its
// own floor is the CUDA cores' integer rate, about 30x below the tensor
// cores'. It exists for widths, not for speed: no configuration of the
// repository is wider than 256.
//
// What the design does: it is the __dp4a kernel that preceded the mma.sync
// one, cut to a 32-point tile with the weights read through L1, so that
// shared memory holds only a tile's activations and widths up to 1,440
// fit:
// - Persistent blocks walk over tiles of kTile = 32 points of one cloud.
//   Shared memory holds the tile's f32 rows (32 x the widest layer) and
//   their int8 copy (32 x the widest input); nothing else.
// - The packed bundle stays in device memory (pack_int8_encoder, its wide
//   layout): w0 and b0, per layer s_w and b, and the int8 weights as int32
//   words of four along K, byte j of word [k4, c] = wq[4 k4 + j, c]. A
//   thread owns 4 points x 8 channels (32 int32 sums) and reads two int4
//   of weight words through L1 (__ldg) and one word per point from shared
//   memory for every four K steps.
// - Quantization: one warp per point takes the row maximum (shuffles) and
//   writes the int8 row. Pooling: each thread takes the max over the
//   tile's valid points for its channels and combines the tiles with
//   atomicMax on the order-preserving int encoding (pool.cuh).
// Widths are padded to multiples of 32 as for the mma.sync instance, so
// both take the same packed widths.

#include <climits>

#include "common.cuh"
#include "int8_quantize.cuh"
#include "launch.cuh"
#include "pool.cuh"

namespace {

constexpr int kTile = 32;      // points per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 4;        // points per thread in the product
constexpr int kCh = 8;         // channels per thread in the product
constexpr int kMaxQLayers = 8;
constexpr int kMaxSmem = 232448;

// Padded widths, as encoder_pool_int8.cu's Plan: dim[0] = C0, dim[l + 1]
// = layer l's outputs, multiples of 32; c_last the unpadded last width.
struct Plan {
  int n;
  int dim[kMaxQLayers + 1];
  int c_last;
};

// Offsets in 4-byte words of the shared-memory regions: the f32 rows y
// (kTile x width), the int8 rows xq (kTile x kq words), the row scales,
// the tile's points and their valid flags. Every region starts on 16
// bytes; the same function sizes the launch and carves the buffer.
struct Layout {
  int width, kq, y, xq, sx, pc, valid, words;
};

__host__ __device__ inline Layout make_layout(const Plan& p) {
  Layout o{};
  int width = p.dim[0], kmax = 0;
  for (int l = 0; l < p.n; ++l) {
    width = p.dim[l + 1] > width ? p.dim[l + 1] : width;
    kmax = p.dim[l] > kmax ? p.dim[l] : kmax;
  }
  o.width = width;
  o.kq = kmax / 4;
  o.y = 0;
  o.xq = o.y + kTile * width;
  o.sx = o.xq + kTile * o.kq;
  o.pc = o.sx + kTile;
  o.valid = o.pc + 3 * kTile;
  o.words = o.valid + kTile;
  return o;
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
encoder_pool_int8_wide_kernel(const float* __restrict__ pc,
                              const float* __restrict__ mask,
                              const unsigned char* __restrict__ packed,
                              const Plan P, const Layout o, int n_points,
                              int tiles_per_cloud, long long n_tiles,
                              int* __restrict__ pooled) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  float* smemf = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = P.dim[0];
  const float* w0 = reinterpret_cast<const float*>(packed);
  const float* b0 = w0 + 3 * c0;
  float* y = smemf + o.y;
  int* xq = smem + o.xq;
  float* sx = smemf + o.sx;
  float* pts = smemf + o.pc;
  int* valid = smem + o.valid;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long cloud = tile / tiles_per_cloud;
    const int p0 = static_cast<int>(tile - cloud * tiles_per_cloud) * kTile;
    const int live = min(kTile, n_points - p0);
    const size_t row0 = static_cast<size_t>(cloud) * n_points + p0;
    __syncthreads();  // the previous tile's pool is done with the rows
    if (tid < kTile) {
      bool v = tid < live;
      if (kMasked && v) v = mask[row0 + tid] > 0.f;
      valid[tid] = v;
    }
    for (int i = tid; i < 3 * kTile; i += kThreads) {
      pts[i] = i < 3 * live ? pc[row0 * 3 + i] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kTile * c0; i += kThreads) {
      const int p = i / c0;
      const int c = i - p * c0;
      const float x[3] = {pts[3 * p], pts[3 * p + 1], pts[3 * p + 2]};
      y[p * o.width + c] = layer0(x, __ldg(w0 + c), __ldg(w0 + c0 + c),
                                  __ldg(w0 + 2 * c0 + c), __ldg(b0 + c));
    }
    __syncthreads();

    const unsigned char* lp = packed + 16 * c0;
    for (int l = 0; l < P.n; ++l) {
      const int K4 = P.dim[l] / 4;
      const int C = P.dim[l + 1];
      const float* sw = reinterpret_cast<const float*>(lp);
      const float* bias = sw + C;
      const int* w = reinterpret_cast<const int*>(lp + 8 * C);
      lp += 8 * C + 4 * K4 * C;

      // quantize: one warp per point, the row maximum then the int8 row
      for (int p = warp; p < kTile; p += kWarps) {
        const float4* row = reinterpret_cast<const float4*>(y + p * o.width);
        float m = 0.f;
        for (int k4 = lane; k4 < K4; k4 += 32) {
          const float4 v = row[k4];
          m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
        const float r = reciprocal(s);
        if (lane == 0) sx[p] = s;
        for (int k4 = lane; k4 < K4; k4 += 32) {
          const float4 v = row[k4];
          xq[p * o.kq + k4] = static_cast<int>(pack4(v.x, v.y, v.z, v.w, s, r));
        }
      }
      __syncthreads();

      // product: a thread owns kPts points x kCh channels; y is rewritten
      // in place (the quantization above was its last reader)
      const int groups = C / kCh;
      for (int item = tid; item < groups * (kTile / kPts); item += kThreads) {
        const int cg = item % groups;
        const int pg = item / groups;
        const int* xr = xq + pg * kPts * o.kq;
        const int* wc = w + cg * kCh;
        int acc[kPts][kCh];
#pragma unroll
        for (int i = 0; i < kPts; ++i) {
#pragma unroll
          for (int j = 0; j < kCh; ++j) acc[i][j] = 0;
        }
#pragma unroll 4
        for (int k4 = 0; k4 < K4; ++k4) {
          const int4 wa = __ldg(reinterpret_cast<const int4*>(wc + k4 * C));
          const int4 wb = __ldg(reinterpret_cast<const int4*>(wc + k4 * C + 4));
          const int wv[kCh] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < kPts; ++i) {
            const int xv = xr[i * o.kq + k4];
#pragma unroll
            for (int j = 0; j < kCh; ++j) acc[i][j] = __dp4a(xv, wv[j], acc[i][j]);
          }
        }
        float swv[kCh], bv[kCh];
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          swv[j] = __ldg(sw + cg * kCh + j);
          bv[j] = __ldg(bias + cg * kCh + j);
        }
#pragma unroll
        for (int i = 0; i < kPts; ++i) {
          const int p = pg * kPts + i;
          const float s = sx[p];
          float out[kCh];
#pragma unroll
          for (int j = 0; j < kCh; ++j) out[j] = dequant(acc[i][j], s, swv[j], bv[j]);
          float4* dst = reinterpret_cast<float4*>(y + p * o.width + cg * kCh);
          dst[0] = make_float4(out[0], out[1], out[2], out[3]);
          dst[1] = make_float4(out[4], out[5], out[6], out[7]);
        }
      }
      __syncthreads();
    }

    for (int c = tid; c < P.c_last; c += kThreads) {
      float m = neg_inf();
      for (int p = 0; p < kTile; ++p) {
        if (valid[p]) m = fmaxf(m, y[p * o.width + c]);
      }
      if (m > neg_inf()) {
        atomicMax(pooled + static_cast<size_t>(cloud) * P.c_last + c,
                  ordered(m));
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, const unsigned char*,
                        Plan, Layout, int, int, long long, int*);

Kernel pick(bool masked) {
  return masked ? encoder_pool_int8_wide_kernel<true>
                : encoder_pool_int8_wide_kernel<false>;
}

bool make_plan(const int* dims, int n_qlayers, int c_last, Plan* p) {
  if (n_qlayers < 0 || n_qlayers > kMaxQLayers) return false;
  *p = Plan{};
  p->n = n_qlayers;
  for (int l = 0; l <= n_qlayers; ++l) {
    if (dims[l] < 32 || dims[l] % 32) return false;
    p->dim[l] = dims[l];
  }
  if (c_last < 1 || c_last > dims[n_qlayers] || c_last <= dims[n_qlayers] - 32) {
    return false;
  }
  p->c_last = c_last;
  return true;
}

}  // namespace

// Shared memory a block needs for these padded widths (dims[0] = C0, then
// the n_qlayers output widths, multiples of 32), or -1 if the widths are
// not supported.
GRL_EXPORT int grl_encoder_pool_int8_wide_smem(const int* dims,
                                               int n_qlayers) {
  Plan p;
  if (!make_plan(dims, n_qlayers, dims[n_qlayers], &p)) return -1;
  return make_layout(p).words * 4;
}

// Registers a thread (and local-memory bytes, spills included) of the
// instance, from cudaFuncGetAttributes; -1 on an error.
GRL_EXPORT int grl_encoder_pool_int8_wide_attributes(int masked,
                                                     int* local_bytes) {
  cudaFuncAttributes attr{};
  if (cudaFuncGetAttributes(&attr, pick(masked)) != cudaSuccess) return -1;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return attr.numRegs;
}

// pc (B, N, 3) f32; mask (B, N) f32 or null; packed: the bundle of
// pack_int8_encoder in its wide layout for the padded widths dims
// (n_qlayers + 1 of them); c_last the unpadded output width; device the
// current device's index; pooled_bits (B, c_last) int32 scratch; out
// (B, c_last) f32.
GRL_EXPORT int grl_encoder_pool_int8_wide(const float* pc, const float* mask,
                                          const void* packed, const int* dims,
                                          int n_qlayers, int c_last,
                                          int batch, int n_points, int device,
                                          int* pooled_bits, float* out,
                                          void* stream) {
  Plan p;
  if (!make_plan(dims, n_qlayers, c_last, &p) || batch < 1 || n_points < 1 ||
      device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay = make_layout(p);
  const int smem = lay.words * 4;
  const long long count = static_cast<long long>(batch) * c_last;
  if (smem > kMaxSmem || count > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(mask != nullptr);
  int blocks = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(kernel), kThreads, smem, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_cloud = (n_points + kTile - 1) / kTile;
  const long long n_tiles = static_cast<long long>(batch) * tiles_per_cloud;
  const int grid = static_cast<int>(n_tiles < blocks ? n_tiles : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(count);
  pool_init<<<(n + 255) / 256, 256, 0, s>>>(pooled_bits, n);
  kernel<<<grid, kThreads, smem, s>>>(
      pc, mask, static_cast<const unsigned char*>(packed), p, lay, n_points,
      tiles_per_cloud, n_tiles, pooled_bits);
  pool_decode<<<(n + 255) / 256, 256, 0, s>>>(pooled_bits, out, n);
  return static_cast<int>(cudaGetLastError());
}
