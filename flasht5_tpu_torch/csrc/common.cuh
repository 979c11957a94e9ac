// Shared helpers of the port's CUDA kernels. Each csrc/<name>.cu is built on
// its own into lib<name>.so with a plain C interface (see runtime.py); every
// entry point returns the cudaError_t of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FT5_EXPORT extern "C" __attribute__((visibility("default")))

FT5_EXPORT const char* ft5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ft5 {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// masked-score sentinel of the TPU kernels (no inf arithmetic anywhere)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round-to-nearest-even through bf16, as `x.astype(bfloat16)` does
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// round x to the storage type T and back (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

}  // namespace ft5
