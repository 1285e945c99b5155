// Fused multistep 2D FTCS stencil for Hopper (sm_90a).
//
// Replaces both 2D solo TPU kernels of heat_tpu/ops/pallas_stencil.py:
//   K1 _pallas_2d          (:256, body _make_kernel_2d :216)  full-width row bands
//   K2 _pallas_2d_coltiled (:633, body _make_kernel_2d_coltiled :587)  (R x C) tiles
// The two compute one function -- k masked FTCS steps per pass on an f32
// band, rounded to the storage type once per pass -- and differ only in how
// they fit the TPU's VMEM. Here one tiled kernel stands for both: a full
// 32768-wide f32 row (128 KiB) would not fit one block's shared memory anyway.
//
// Design: each block owns a BR x BC output tile and loads the
// (BR+2k) x (BC+2k) band around it into dynamic shared memory as f32 (cells
// outside the array load as 0.0f, which is finite, so a frozen cell's
// 0*lap stays 0). It then runs k <= KMAX mini-steps, ping-ponging two
// shared buffers; the valid region shrinks by one cell per side per step, so
// after k steps exactly the tile is valid. Each thread owns one band column
// and a run of rows, keeping up/centre/down in registers (3 shared loads and
// 1 store per cell-step).
//
// Arithmetic, in the Pallas body's order (pallas_stencil.py:239-249):
//   maskr = frozen ? 0 : r          (r rounded to f32; frozen where the GLOBAL
//                                     row/col index <= lo or >= hi of bounds)
//   lap   = ((up + dn) + lf) + rt - 4*c
//   c'    = fma(maskr, lap, c)      one rounding, as the Pallas kernel's
//                                     compiled update contracts it
// Built with -fmad=false so nothing else is contracted; the explicit
// __fmaf_rn still emits its FMA. No fast-math (it flushes subnormals).
//
// Bound on the card: the pass must read and write the field once
// (2 * itemsize * m * n bytes), and does ~7 f32 operations per cell-step, so
// at k = 16 it sits near the balance point of HBM and the f32 vector rate.
// This first version is bounded by shared-memory traffic and the halo's
// redundant work ((BR+2k)(BC+2k) vs BR*BC); PERF.md has its times.
//
// Plain C interface (loaded with ctypes): heat_ftcs2d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 16;               // max steps per pass (halo width)
constexpr int BR = 64;                 // output tile rows
constexpr int BC = 96;                 // output tile cols
constexpr int TX = BC + 2 * KMAX;      // threads across the widest band: 128
constexpr int TY = 4;                  // row groups
constexpr int HMAX = BR + 2 * KMAX;
constexpr int WMAX = BC + 2 * KMAX;
constexpr int SMEM_MAX = 2 * HMAX * WMAX * (int)sizeof(float);  // 98304 B

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TX * TY, 2)  // two blocks per SM
ftcs2d_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t m,
              int64_t n, float r, int k, int rlo, int rhi, int clo, int chi) {
  extern __shared__ float smem[];
  const int H = BR + 2 * k;
  const int W = BC + 2 * k;
  float* cur = smem;
  float* nxt = smem + H * W;
  const int64_t r0 = (int64_t)blockIdx.y * BR - k;  // global row of band row 0
  const int64_t c0 = (int64_t)blockIdx.x * BC - k;  // global col of band col 0
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int idx = tid; idx < H * W; idx += TX * TY) {
    const int i = idx / W;
    const int j = idx - i * W;
    const int64_t gr = r0 + i;
    const int64_t gc = c0 + j;
    float v = 0.0f;
    if (gr >= 0 && gr < m && gc >= 0 && gc < n) v = load_f(in + gr * n + gc);
    cur[idx] = v;
  }
  __syncthreads();

  const int x = threadIdx.x;
  const int seg = (H + TY - 1) / TY;
  const int ylo = threadIdx.y * seg;
  const int yhi = min(H, ylo + seg);
  const int64_t gc = c0 + x;
  const bool col_frozen = (gc <= clo) || (gc >= chi);

  for (int s = 0; s < k; ++s) {
    // mini-step s computes rows [s+1, H-s-2] x cols [s+1, W-s-2]
    if (x >= s + 1 && x <= W - s - 2) {
      const int ia = max(ylo, s + 1);
      const int ib = min(yhi, H - s - 1);
      if (ia < ib) {
        float up = cur[(ia - 1) * W + x];
        float c = cur[ia * W + x];
        for (int i = ia; i < ib; ++i) {
          const float dn = cur[(i + 1) * W + x];
          const float lf = cur[i * W + x - 1];
          const float rt = cur[i * W + x + 1];
          const int64_t gr = r0 + i;
          const bool frozen = col_frozen || gr <= rlo || gr >= rhi;
          const float maskr = frozen ? 0.0f : r;
          const float lap = ((up + dn) + lf) + rt - 4.0f * c;
          nxt[i * W + x] = __fmaf_rn(maskr, lap, c);
          up = c;
          c = dn;
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int idx = tid; idx < BR * BC; idx += TX * TY) {
    const int i = idx / BC;
    const int j = idx - i * BC;
    const int64_t gr = r0 + k + i;
    const int64_t gc2 = c0 + k + j;
    if (gr < m && gc2 < n) store_f(out + gr * n + gc2, cur[(i + k) * W + j + k]);
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t m, int64_t n, float r, int k,
           int rlo, int rhi, int clo, int chi, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after opting in (per device,
  // so on every launch: it costs about a microsecond of host time)
  cudaError_t e = cudaFuncSetAttribute(
      ftcs2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)(BR + 2 * k) * (BC + 2 * k) * sizeof(float);
  dim3 grid((unsigned)((n + BC - 1) / BC), (unsigned)((m + BR - 1) / BR));
  dim3 block(TX, TY);
  ftcs2d_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, n, r, k, rlo, rhi,
      clo, chi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for arguments the kernel does not take.
int heat_ftcs2d(int dtype, const void* in, void* out, int64_t m, int64_t n,
                float r, int k, int rlo, int rhi, int clo, int chi,
                void* stream) {
  if (k < 1 || k > KMAX || m < 1 || n < 1 || (m + BR - 1) / BR > 65535 ||
      in == out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, m, n, r, k, rlo, rhi, clo, chi, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, m, n, r, k, rlo, rhi, clo, chi, s);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
