// Device helpers shared by the multi-lane serving kernels (lanes2d.cu, K4;
// lanes3d.cu, K5): the per-step storage rounding, and the fused per-lane
// reductions into the (6, L) int32 boundary vector (rows: remaining,
// finite, then float32 resid/tmin/tmax/heat bitcast; the layout of
// serve/engine.BOUNDARY_ROWS and cuda_lanes.write_boundary).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "storage.cuh"

namespace {

// An update rounded to the storage type, as f32: bf16 by round to nearest
// even (__float2bfloat16_rn, the conversion torch's CUDA code uses); f32 as
// it is, but a NaN is written as 0x7fc00000, so the bytes do not depend on
// the card's NaN payload rules.
template <typename T> __device__ __forceinline__ float to_storage(float v);
template <> __device__ __forceinline__ float to_storage<float>(float v) {
  return isnan(v) ? __int_as_float(0x7fc00000) : v;
}
template <> __device__ __forceinline__ float to_storage<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// float max/min by integer atomics: non-negative floats order as signed
// ints, negative ones in reverse as unsigned ints. -0 is merged as +0.
__device__ __forceinline__ void atomic_max_f(float* a, float v) {
  if (v == 0.0f) v = 0.0f;
  if (v >= 0.0f) atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_min_f(float* a, float v) {
  if (v == 0.0f) v = 0.0f;
  if (v >= 0.0f) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

// One block's (finite, resid, tmin, tmax, heat) into lane `lane`'s column:
// warp shuffles, then the NWARP warps' partials in shared memory, then one
// atomic per stat. Every thread of the block (NWARP * 32 of them) calls it.
// max/min are order-free; the heat sum is f32 in another order than the
// plain version's.
template <int NWARP>
__device__ void publish(int* boundary, int L, int lane, int fin, float resid,
                        float tmin, float tmax, float heat) {
  __shared__ int s_fin[NWARP];
  __shared__ float s_val[4][NWARP];
  for (int o = 16; o > 0; o >>= 1) {
    fin &= __shfl_xor_sync(0xffffffffu, fin, o);
    resid = fmaxf(resid, __shfl_xor_sync(0xffffffffu, resid, o));
    tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, o));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    heat += __shfl_xor_sync(0xffffffffu, heat, o);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    s_fin[warp] = fin;
    s_val[0][warp] = resid;
    s_val[1][warp] = tmin;
    s_val[2][warp] = tmax;
    s_val[3][warp] = heat;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NWARP; ++w) {
      fin &= s_fin[w];
      resid = fmaxf(resid, s_val[0][w]);
      tmin = fminf(tmin, s_val[1][w]);
      tmax = fmaxf(tmax, s_val[2][w]);
      heat += s_val[3][w];
    }
    float* st = reinterpret_cast<float*>(boundary + 2 * L);
    if (!fin) atomicAnd(boundary + L + lane, 0);
    atomic_max_f(st + lane, resid);
    atomic_min_f(st + L + lane, tmin);
    atomic_max_f(st + 2 * L + lane, tmax);
    atomicAdd(st + 3 * L + lane, heat);
  }
}

// Before a chunk's last launch: the post-chunk countdown max(rem - ktotal, 0)
// into rem_out and boundary row 0, and the merge identities into rows 1-5
// (never "block 0 initialises": blocks have no grid-wide order).
__global__ void lanes_init(const int* rem, int* rem_out, int* boundary, int L,
                           int ktotal) {
  float* st = reinterpret_cast<float*>(boundary + 2 * L);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int left = rem[l] - ktotal;
    rem_out[l] = left > 0 ? left : 0;
    boundary[l] = left > 0 ? left : 0;
    boundary[L + l] = 1;
    st[l] = 0.0f;
    st[L + l] = INFINITY;
    st[2 * L + l] = -INFINITY;
    st[3 * L + l] = 0.0f;
  }
}

// lanes_init on `stream` where `boundary` is given (the chunk's last launch)
inline cudaError_t init_boundary(const int* rem, int* rem_out, int* boundary,
                                 int L, int ktotal, cudaStream_t stream) {
  if (boundary == nullptr) return cudaSuccess;
  lanes_init<<<1, 256, 0, stream>>>(rem, rem_out, boundary, L, ktotal);
  return cudaGetLastError();
}

}  // namespace
