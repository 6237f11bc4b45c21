// Helpers shared by the port's kernels: element loads and stores that widen
// to float32 and narrow from it, a warp sum, shared-memory addresses for PTX,
// the dtype codes the ctypes wrappers pass (0 = float32, 1 = bfloat16), and
// launch set-up kept per device.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace esv {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 32-bit shared-window address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two adjacent elements of a row, stored as one 8-byte (float) or 4-byte
// (bf16) write; dst must be aligned to that size.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launch set-up that need not run on every launch (attribute queries,
// cudaFuncSetAttribute) runs once per device and Site: setup(device) on the
// first launch there, its result kept for the later ones, which cost a
// cudaGetDevice.  Site is a type of the caller's, one per kernel.  The
// function is static, so each library keeps its own state for its own copy
// of a kernel (the statics of an inline function are one for the whole
// process, whichever library set them).
constexpr int kMaxDevices = 64;

template <auto Kernel>
struct KernelSite {};

template <typename Site, typename F>
static cudaError_t once_per_device(int* device, F&& setup) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[*device], [&] { result[*device] = setup(*device); });
  return result[*device];
}

}  // namespace esv
