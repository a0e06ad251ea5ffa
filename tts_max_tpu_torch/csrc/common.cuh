// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ttsk {

constexpr float NEG_INF = -1e30f;  // the JAX kernels' mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Round through T and back: the JAX decode kernel rounds the scaled query to
// the compute dtype before the dot products.
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace ttsk

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
