// Launch geometry of the port's persistent kernels (K1 and K6's instances),
// queried once per (kernel, dynamic shared memory, device) and then read
// from a table: a steady call makes no runtime query, and neither does a
// call inside a CUDA graph capture once the same call ran outside it.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

// Blocks of `threads` threads that the device's SMs hold at once when each
// block takes `smem` bytes of dynamic shared memory: the grid of a
// persistent kernel. The kernel's dynamic shared-memory limit is raised to
// `smem` first where it is lower, never lowered: a smaller request must not
// refuse a larger one that another caller looked up before. The caller
// makes `device` current.
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                                   int device, int* blocks) {
  struct Entry {
    const void* kernel;
    int smem, device, blocks;
  };
  constexpr int kEntries = 64;
  static std::mutex lock;
  static Entry table[kEntries];
  static int used = 0;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.kernel == kernel && e.smem == smem && e.device == device) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem > attr.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  // a full table is left as it is: a new (kernel, smem, device) is then
  // queried on every call
  if (used < kEntries) table[used++] = Entry{kernel, smem, device, *blocks};
  return cudaSuccess;
}

}  // namespace
