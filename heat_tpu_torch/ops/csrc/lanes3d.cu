// Multi-lane 3D FTCS serving kernel for Hopper (sm_90a).
//
// Replaces K5 of heat_tpu/ops/pallas_stencil.py: _lane_pallas_3d (:1279,
// body _make_lane_kernel_3d :1200). The serving engine stacks L independent
// requests as one (L, m, m, m) array, m = bucket side + 2; lane l holds its
// request in the [1, n_l] corner with its own r_l, side n_l and countdown
// rem_l (device vectors). K4's contract in 3D.
//
// Design: one step per launch (the lanes round to storage every step, so a
// launch boundary is not a rounding point and a chunk is k launches). A
// block is a 32-column x 8-mid tile of one lane (blockIdx.y); each thread
// walks its (mid, col) column through every row, keeping row-1, row and
// row+1 in registers and reading the four in-plane neighbours from global
// memory (L1 hits behind the neighbouring threads' centre reads). Walking
// the rows also keeps the fused reductions cheap: a block publishes one
// partial per stat for m^2/256 cells' worth of rows, so a lane takes
// ceil(m/32)*ceil(m/8) atomics per stat, not one per 256 cells (an f32 heat
// sum over that many atomics would drift past the stats' tolerance).
//
// Arithmetic, in the reference lane programs' order (laplacian_interior:
// +1 neighbours in axis order, then -1 neighbours; see cuda_lanes.py):
//   s    = ((((row+1 + mid+1) + col+1) + row-1) + mid-1) + col-1
//   lap  = fma(-6, c, s)                   ONE rounding
//   u    = fma(r_l, lap, c)                ONE rounding
//   u    = round(u) to the storage type    EVERY step (bf16: __float2bfloat16_rn;
//                                           f32: a NaN is written as 0x7fc00000,
//                                           so the bytes do not depend on the
//                                           card's NaN payload rules)
//   c'   = keep ? u : c                    select: a kept cell is copied as
//                                           it is stored, bytes unchanged
// keep: step < rem_l and bc_lo < row, mid, col < n_l + 1 - bc_lo. Built
// with -fmad=false so that nothing else is contracted.
//
// When `boundary` is given (the chunk's last step) the launch also reduces
// the per-lane finite bit and the float32 stats (resid = max|out - in|,
// tmin, tmax, heat over the request region [1, n_l]^3) into the (6, L) int32
// boundary vector, after an init launch has set it to the merge identities
// (lanes_common.cuh).
//
// Bound on the card: a launch reads and writes the stack once
// (2 * itemsize * L * m^3 bytes) and does 9 f32 operations per live cell
// (5 adds, two FMAs of 2 each): bytes bound it. PERF.md has its times.
//
// Plain C interface (loaded with ctypes): heat_lanes3d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lanes_common.cuh"

namespace {

constexpr int BX = 32;                   // columns per block
constexpr int BY = 8;                    // mids per block
constexpr int NWARP = BX * BY / 32;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
lanes3d_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
               const float* __restrict__ r, const int* __restrict__ n,
               const int* __restrict__ rem, int step, int bc_lo,
               int* boundary, int L, int ncol) {
  const int lane = blockIdx.y;
  const int col = (blockIdx.x % ncol) * BX + threadIdx.x;
  const int mid = (blockIdx.x / ncol) * BY + threadIdx.y;
  const size_t plane = (size_t)m * m;
  const T* src = in + (size_t)lane * plane * m;
  T* dst = out + (size_t)lane * plane * m;
  const int n_l = n[lane];
  const int hi = n_l + 1 - bc_lo;
  const float r_l = r[lane];
  // keep = step < rem_l and every coordinate in (bc_lo, hi); the row test
  // is the only one that changes along the walk
  const bool mc_live = step < rem[lane] && mid > bc_lo && mid < hi &&
                       col > bc_lo && col < hi;
  const bool mc_region = mid >= 1 && mid <= n_l && col >= 1 && col <= n_l;

  int fin = 1;
  float resid = 0.0f, tmin = INFINITY, tmax = -INFINITY, heat = 0.0f;
  if (col < m && mid < m) {
    const size_t base = (size_t)mid * m + col;
    float below = 0.0f;                       // row-1 (never read at row 0)
    float c = load_f(src + base);             // row
    for (int row = 0; row < m; ++row) {
      const size_t idx = (size_t)row * plane + base;
      const float above = row + 1 < m ? load_f(src + idx + plane) : 0.0f;
      float v = c;
      if (mc_live && row > bc_lo && row < hi) {
        float s = above;                      // row+1
        s = s + load_f(src + idx + m);        // mid+1
        s = s + load_f(src + idx + 1);        // col+1
        s = s + below;                        // row-1
        s = s + load_f(src + idx - m);        // mid-1
        s = s + load_f(src + idx - 1);        // col-1
        const float lap = __fmaf_rn(-6.0f, c, s);
        v = to_storage<T>(__fmaf_rn(r_l, lap, c));
        store_f(dst + idx, v);
      } else {
        dst[idx] = src[idx];                  // kept: the stored bytes
      }
      if (boundary != nullptr) {
        fin &= isfinite(v) ? 1 : 0;
        if (mc_region && row >= 1 && row <= n_l) {
          resid = fmaxf(resid, fabsf(v - c));
          tmin = fminf(tmin, v);
          tmax = fmaxf(tmax, v);
          heat += v;
        }
      }
      below = c;
      c = above;
    }
  }
  if (boundary == nullptr) return;            // grid-uniform
  publish<NWARP>(boundary, L, lane, fin, resid, tmin, tmax, heat);
}

template <typename T>
int launch(const void* in, void* out, int L, int m, const float* r,
           const int* n, const int* rem, int step, int bc_lo, int* rem_out,
           int* boundary, int ktotal, cudaStream_t stream) {
  const cudaError_t e = init_boundary(rem, rem_out, boundary, L, ktotal, stream);
  if (e != cudaSuccess) return (int)e;
  const int ncol = (m + BX - 1) / BX;
  const int nmid = (m + BY - 1) / BY;
  dim3 grid((unsigned)(ncol * nmid), (unsigned)L);
  dim3 block(BX, BY);
  lanes3d_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, r, n, rem, step,
      bc_lo, boundary, L, ncol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. One step (k must be 1) at the chunk's
// step `offset`; rem_out/boundary non-null only on the chunk's last step
// (ktotal = the chunk's steps). Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for arguments the kernel does not take.
int heat_lanes3d(int dtype, const void* in, void* out, int L, int m,
                 const void* r, const void* n, const void* rem, int k,
                 int offset, int bc_lo, void* rem_out, void* boundary,
                 int ktotal, void* stream) {
  if (k != 1 || m < 3 || m > 46341 || L < 1 || L > 65535 || in == out ||
      (bc_lo != 0 && bc_lo != 1) || (boundary != nullptr) != (rem_out != nullptr) ||
      rem_out == rem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const int* np_ = static_cast<const int*>(n);
  const int* remp = static_cast<const int*>(rem);
  int* ro = static_cast<int*>(rem_out);
  int* bp = static_cast<int*>(boundary);
  if (dtype == 0)
    return launch<float>(in, out, L, m, rp, np_, remp, offset, bc_lo, ro, bp, ktotal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, L, m, rp, np_, remp, offset, bc_lo, ro, bp,
                                 ktotal, s);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
