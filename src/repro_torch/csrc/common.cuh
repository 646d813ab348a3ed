// Shared helpers of the port's attention kernels: element conversion and
// the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

// dtype codes passed by the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Round a count of floats up to a multiple of 4 (16-byte alignment of the
// next shared-memory section, for float4 accesses).
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

}  // namespace repro
