// Loads and stores of the storage types (f32, bf16) as f32, shared by every
// kernel source: a bf16 load widens exactly, a bf16 store rounds to nearest
// even (__float2bfloat16_rn, the conversion torch's CUDA code uses).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace
