// A kernel's dynamic shared-memory limit (cudaFuncAttributeMaxDynamicSharedMemorySize),
// raised before a launch that needs more than the default 48 KB.
//
// The limit is a property of the function in the context, shared by every
// host thread, while a launch may come from any thread: PyTorch's autograd
// engine runs a backward's launches on a thread of its own.  So the limit
// only ever grows: every raise goes through one lock and a process-wide
// record of what each kernel was given, and a thread that launches at a
// smaller size never lowers what another thread's larger launch needs.  A
// thread-local record in front of it keeps the common case, a size this
// thread has launched before, free of the lock and of attribute calls.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace gato {

// Sets `kernel`'s dynamic shared-memory limit on the current device to at
// least `bytes` (and, with `nonportable`, allows cluster sizes above 8);
// makes no call where that was done for at least `bytes` before.
inline cudaError_t raise_smem_limit(const void* kernel, size_t bytes, bool nonportable) {
  constexpr int kLocal = 16, kShared = 128;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static thread_local const void* local_kernel[kLocal] = {};
  static thread_local int local_device[kLocal] = {};
  static thread_local size_t local_bytes[kLocal] = {};
  int slot = 0;
  while (slot < kLocal - 1 && local_kernel[slot] != nullptr &&
         (local_kernel[slot] != kernel || local_device[slot] != device))
    ++slot;
  if (local_kernel[slot] == kernel && local_device[slot] == device &&
      local_bytes[slot] >= bytes)
    return cudaSuccess;

  static std::mutex lock;
  static const void* set_kernel[kShared] = {};
  static int set_device[kShared] = {};
  static size_t set_bytes[kShared] = {};
  std::lock_guard<std::mutex> guard(lock);
  int at = 0;
  while (at < kShared && set_kernel[at] != nullptr &&
         (set_kernel[at] != kernel || set_device[at] != device))
    ++at;
  if (at == kShared) return cudaErrorMemoryAllocation;  // more kernels than the record
  const bool seen = set_kernel[at] == kernel;
  size_t limit = seen ? set_bytes[at] : 0;
  if (!seen || limit < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    if (nonportable) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    set_kernel[at] = kernel;
    set_device[at] = device;
    set_bytes[at] = limit = bytes;
  }
  local_kernel[slot] = kernel;
  local_device[slot] = device;
  local_bytes[slot] = limit;
  return cudaSuccess;
}

}  // namespace gato
