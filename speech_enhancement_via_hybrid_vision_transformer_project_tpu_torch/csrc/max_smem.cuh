// Lets a kernel's blocks take all the shared memory the card allows a block:
// K2's forward (attention.cu) and backward (attention_bwd.cu) list a masked
// row's kept keys in shared memory, so what they need grows with N.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <initializer_list>

namespace {

constexpr int MAX_SMEM_DEVICES = 64;  // devices whose kernel attributes are cached

// Sets each of `kernels` to take as dynamic shared memory what the card's
// opt-in maximum a block leaves beside the kernel's static part, and to
// prefer the largest shared-memory carveout. Function attributes are per
// device: the first call on a device sets them and later calls return at
// once (always the same values, so threads racing here do no harm). One
// cache per head dim D and kernel types, that is per template instance of
// the caller.
template <int D, class... K>
cudaError_t allow_max_smem(K... kernels) {
  static std::atomic<bool> done[MAX_SMEM_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_SMEM_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int most;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const void* kernel : {reinterpret_cast<const void*>(kernels)...}) {
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - static_cast<int>(attr.sharedSizeBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && dev < MAX_SMEM_DEVICES) done[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace
