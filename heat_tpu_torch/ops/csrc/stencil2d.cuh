// The 2D FTCS multistep kernel for Hopper (sm_90a): one body for the
// shipped kernel (ftcs2d.cu, one instance) and the kernel lab's candidates
// (lab2d.cu, many), so that an A/B of a candidate against the shipped
// kernel compares like with like, and a redesign is made once.
//
// It computes k masked FTCS steps per launch on an f32 band. Templated on
// the neighbour order, the update form, how often the band is rounded to
// the storage type, the storage type, the halo width KH and the output
// tile BR x BC.
//
// Design: each block owns a BR x BC output tile and loads the
// (BR+2k) x (BC+2k) band around it into dynamic shared memory as f32 (cells
// outside the array load as 0.0f, which is finite, so a frozen cell's
// 0*lap stays 0). It then runs k <= KH mini-steps, ping-ponging two shared
// buffers; the valid region shrinks by one cell per side per step, so
// after k steps exactly the tile is valid. Each thread owns one band
// column and a run of rows, keeping up/centre/down in registers (3 shared
// loads and 1 store per cell-step). KH = 16 serves passes of up to 16
// steps, KH = 32 deeper ones (the reference's thin kernel passes up to 32
// steps, and each pass boundary is a bf16 rounding point); at the 64 x 96
// tile that is 128 x 4 threads and 96 KB (two blocks per SM) or 160 x 4
// threads and 160 KB (one).
//
// Arithmetic per cell and mini-step (maskr = frozen ? 0 : r, r rounded to
// f32; frozen where the GLOBAL row/col index <= lo or >= hi of bounds):
//   ORDER_K1:  s = ((up + dn) + lf) + rt     row-1, row+1, col-1, col+1
//   ORDER_L4:  s = ((dn + up) + rt) + lf     row+1, row-1, col+1, col-1
//   UPD_LAP:   c' = fma(maskr, s - 4c, c)    (4c exact)
//   UPD_DECAY: c' = fma(decay, c, maskr*s), decay = 1 - 4*maskr (exact
//              product, one rounding)
//   EVERY:     c' rounded to the storage type after each step (bf16 RNE;
//              the identity for f32), else once at the store
// Built with -fmad=false so nothing else is contracted; the explicit
// __fmaf_rn still emits its FMA. No fast-math (it flushes subnormals).
//
// Bound on the card: a pass reads and writes the field once
// (2 * itemsize * m * n bytes) and does 7 (lap) or 6 (decay) f32 operations
// per cell-step, so at 16 steps it sits near the balance of HBM and the f32
// rate. This version is bounded instead by shared-memory traffic and the
// halo's redundant work ((BR+2k)(BC+2k) vs BR*BC); PERF.md has its times.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int KMAX = 32;               // max steps per launch (widest halo)
constexpr int TY = 4;                  // row groups
constexpr int SMEM_LIMIT = 232448;     // bytes a block may opt into

enum { ORDER_K1 = 0, ORDER_L4 = 1 };
enum { UPD_LAP = 0, UPD_DECAY = 1 };

template <int KH, int BR, int BC> struct Geometry {
  static constexpr int TX = BC + 2 * KH;  // threads across the widest band
  static constexpr int SMEM_MAX = 2 * (BR + 2 * KH) * (BC + 2 * KH) * (int)sizeof(float);
  static constexpr int MIN_BLOCKS = TX * TY <= 512 ? 2 : 1;
  static_assert(TX * TY <= 1024, "too many threads per block");
  static_assert(SMEM_MAX <= SMEM_LIMIT, "band over the shared memory limit");
};

// v rounded to the storage type and back
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int ORDER, int UPD, bool EVERY, int KH, int BR, int BC>
__global__ void __launch_bounds__(Geometry<KH, BR, BC>::TX * TY,
                                  Geometry<KH, BR, BC>::MIN_BLOCKS)
ftcs2d_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t m,
              int64_t n, float r, int k, int rlo, int rhi, int clo, int chi) {
  constexpr int TX = Geometry<KH, BR, BC>::TX;
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
          const float sum = ORDER == ORDER_K1 ? ((up + dn) + lf) + rt
                                              : ((dn + up) + rt) + lf;
          float v;
          if (UPD == UPD_LAP) {
            v = __fmaf_rn(maskr, sum - 4.0f * c, c);
          } else {
            const float decay = 1.0f - 4.0f * maskr;
            v = __fmaf_rn(decay, c, maskr * sum);
          }
          if (EVERY) v = round_to<T>(v);
          nxt[i * W + x] = v;
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

struct Args {
  const void* in;
  void* out;
  int64_t m, n;
  float r;
  int k, rlo, rhi, clo, chi;
  cudaStream_t stream;
};

// Arguments no instance takes: cudaErrorInvalidValue, else 0.
inline int check_args(const Args& a) {
  if (a.k < 1 || a.k > KMAX || a.m < 1 || a.n < 1 || a.in == a.out)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// dynamic shared memory of a launch at depth k: two f32 bands of the
// BR x BC output tile and its k-cell halo
inline size_t band2_smem(int br, int bc, int k) {
  return 2 * (size_t)(br + 2 * k) * (bc + 2 * k) * sizeof(float);
}

template <typename T, int ORDER, int UPD, bool EVERY, int KH, int BR, int BC>
int launch_inst(const Args& a) {
  auto kernel = ftcs2d_kernel<T, ORDER, UPD, EVERY, KH, BR, BC>;
  // above 48 KB of dynamic shared memory only after opting in (per device,
  // so on every launch: it costs about a microsecond of host time)
  cudaError_t e = cudaFuncSetAttribute(kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Geometry<KH, BR, BC>::SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = band2_smem(BR, BC, a.k);
  if ((a.m + BR - 1) / BR > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((a.n + BC - 1) / BC), (unsigned)((a.m + BR - 1) / BR));
  dim3 block(Geometry<KH, BR, BC>::TX, TY);
  kernel<<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.n, a.r, a.k,
      a.rlo, a.rhi, a.clo, a.chi);
  return (int)cudaGetLastError();
}

// the instance of halo 16 for launches of up to 16 steps, else of halo 32
template <typename T, int ORDER, int UPD, bool EVERY, int BR, int BC>
int launch_kh(const Args& a) {
  if (a.k <= 16) return launch_inst<T, ORDER, UPD, EVERY, 16, BR, BC>(a);
  return launch_inst<T, ORDER, UPD, EVERY, 32, BR, BC>(a);
}

}  // namespace
