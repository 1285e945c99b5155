// Multi-lane 2D FTCS serving kernel for Hopper (sm_90a).
//
// Replaces K4 of heat_tpu/ops/pallas_stencil.py: _lane_pallas_2d (:1115,
// body _make_lane_kernel_2d :1050). The serving engine stacks L independent
// requests as one (L, m, m) array, m = bucket side + 2; lane l holds its
// request in the [1, n_l] corner with its own r_l, side n_l and countdown
// rem_l (device vectors). One launch runs k <= KMAX masked, gated steps of
// every lane.
//
// Design: ftcs2d.cu's shared-memory band with the lane as blockIdx.z. Each
// block owns a BR x BC output tile of one lane and loads the
// (BR+2k) x (BC+2k) band around it as f32 (cells outside the lane buffer
// load as 0 and are never live: a live cell's neighbours all lie inside the
// buffer). It runs the k mini-steps ping-ponging two shared buffers, the
// valid region shrinking one cell per side per step. A lane whose countdown
// runs out stops stepping (block-uniform), its cells keep their values.
//
// Arithmetic, in the reference lane programs' order (laplacian_interior:
// +1 neighbours in axis order, then -1 neighbours; see cuda_lanes.py):
//   s    = ((dn + rt) + up) + lf
//   lap  = s + (-4*c)                      (-4*c is exact)
//   u    = fma(r_l, lap, c)                ONE rounding, as the reference's
//                                           compiled update contracts it
//   u    = round(u) to the storage type    EVERY step (bf16: round to nearest
//                                           even, __float2bfloat16_rn, the
//                                           conversion torch's CUDA code uses;
//                                           f32: a NaN is written as
//                                           0x7fc00000, so the bytes do not
//                                           depend on the card's NaN payloads)
//   c'   = live ? u : c                    select, never multiply: a NaN
//                                           stays in its lane, frozen cells
//                                           keep their bytes
// live: bc_lo < row, col < n_l + 1 - bc_lo. Built with -fmad=false so that
// nothing else is contracted.
//
// When `boundary` is given (the chunk's last pass) the kernel also reduces,
// per lane, into the (6, L) int32 boundary vector that an init launch has
// set to the merge identities (lanes_common.cuh): row 1 the finite bit (AND
// over the whole slab), rows 2-5 float32 resid = max|out - pre-final-step|
// (0 when the final mini-step was gated off), tmin, tmax and heat over the
// request region [1, n_l]^2, one atomic per block and stat (publish).
//
// Bound on the card: a pass reads and writes the stack once
// (2 * itemsize * L * m^2 bytes) and does 7 f32 operations per live
// cell-step (3 adds, the exact -4*c, an add, the FMA as 2), so at k = 16 it
// sits near the balance of HBM and the f32 rate. This first version, like
// ftcs2d, is bounded by shared-memory traffic and the halo's redundant
// work; PERF.md has its times.
//
// Plain C interface (loaded with ctypes): heat_lanes2d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lanes_common.cuh"

namespace {

constexpr int KMAX = 16;                 // max steps per launch
constexpr int BR = 64;                   // output tile rows
constexpr int BC = 96;                   // output tile cols
constexpr int TY = 4;                    // row groups
constexpr int TX = BC + 2 * KMAX;        // threads across the widest band
constexpr int NT = TX * TY;              // 512 threads
constexpr int NWARP = NT / 32;
constexpr int SMEM_MAX = 2 * (BR + 2 * KMAX) * (BC + 2 * KMAX) * (int)sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NT, 2)
lanes2d_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
               const float* __restrict__ r, const int* __restrict__ n,
               const int* __restrict__ rem, int k, int offset, int bc_lo,
               int* boundary, int L) {
  extern __shared__ float smem[];
  const int lane = blockIdx.z;
  const int H = BR + 2 * k;
  const int W = BC + 2 * k;
  float* cur = smem;
  float* nxt = smem + H * W;
  const size_t slab = (size_t)m * m;
  const T* src = in + lane * slab;
  T* dst = out + lane * slab;
  const int r0 = blockIdx.y * BR - k;   // buffer row of band row 0
  const int c0 = blockIdx.x * BC - k;   // buffer col of band col 0
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int idx = tid; idx < H * W; idx += NT) {
    const int i = idx / W;
    const int j = idx - i * W;
    const int gr = r0 + i;
    const int gc = c0 + j;
    float v = 0.0f;
    if (gr >= 0 && gr < m && gc >= 0 && gc < m) v = load_f(src + (size_t)gr * m + gc);
    cur[idx] = v;
  }
  __syncthreads();

  const float r_l = r[lane];
  const int n_l = n[lane];
  const int rem_l = rem[lane];
  const int hi = n_l + 1 - bc_lo;
  const int x = threadIdx.x;
  const int seg = (H + TY - 1) / TY;
  const int ylo = threadIdx.y * seg;
  const int yhi = min(H, ylo + seg);
  const int gc = c0 + x;
  const bool col_live = gc > bc_lo && gc < hi;

  int s = 0;
  for (; s < k; ++s) {
    if (offset + s >= rem_l) break;      // block-uniform: the lane is done
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
          const int gr = r0 + i;
          const bool live = col_live && gr > bc_lo && gr < hi;
          const float sum = ((dn + rt) + up) + lf;
          const float lap = sum + (-4.0f * c);
          const float u = to_storage<T>(__fmaf_rn(r_l, lap, c));
          nxt[i * W + x] = live ? u : c;
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
  // after all k steps `nxt` holds the state before the final mini-step
  const bool last_applied = s == k;

  int fin = 1;
  float resid = 0.0f, tmin = INFINITY, tmax = -INFINITY, heat = 0.0f;
  for (int idx = tid; idx < BR * BC; idx += NT) {
    const int i = idx / BC;
    const int j = idx - i * BC;
    const int gr = r0 + k + i;
    const int gc2 = c0 + k + j;
    if (gr < m && gc2 < m) {
      const int b = (i + k) * W + j + k;
      const float v = cur[b];
      store_f(dst + (size_t)gr * m + gc2, v);
      if (boundary != nullptr) {
        fin &= isfinite(v) ? 1 : 0;
        if (gr >= 1 && gr <= n_l && gc2 >= 1 && gc2 <= n_l) {
          if (last_applied) resid = fmaxf(resid, fabsf(v - nxt[b]));
          tmin = fminf(tmin, v);
          tmax = fmaxf(tmax, v);
          heat += v;
        }
      }
    }
  }
  if (boundary != nullptr) publish<NWARP>(boundary, L, lane, fin, resid, tmin, tmax, heat);
}

template <typename T>
int launch(const void* in, void* out, int L, int m, const float* r,
           const int* n, const int* rem, int k, int offset, int bc_lo,
           int* rem_out, int* boundary, int ktotal, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t e = cudaFuncSetAttribute(lanes2d_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  e = init_boundary(rem, rem_out, boundary, L, ktotal, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)(BR + 2 * k) * (BC + 2 * k) * sizeof(float);
  dim3 grid((unsigned)((m + BC - 1) / BC), (unsigned)((m + BR - 1) / BR), (unsigned)L);
  dim3 block(TX, TY);
  lanes2d_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, r, n, rem, k, offset,
      bc_lo, boundary, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. One pass of k steps starting at the
// chunk's step `offset`; rem_out/boundary non-null only on the chunk's last
// pass (ktotal = the chunk's steps). Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for arguments the kernel does not take.
int heat_lanes2d(int dtype, const void* in, void* out, int L, int m,
                 const void* r, const void* n, const void* rem, int k,
                 int offset, int bc_lo, void* rem_out, void* boundary,
                 int ktotal, void* stream) {
  if (k < 1 || k > KMAX || m < 3 || L < 1 || L > 65535 ||
      (m + BR - 1) / BR > 65535 || in == out || (bc_lo != 0 && bc_lo != 1) ||
      (boundary != nullptr) != (rem_out != nullptr) || rem_out == rem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const int* np_ = static_cast<const int*>(n);
  const int* remp = static_cast<const int*>(rem);
  int* ro = static_cast<int*>(rem_out);
  int* bp = static_cast<int*>(boundary);
  if (dtype == 0)
    return launch<float>(in, out, L, m, rp, np_, remp, k, offset, bc_lo, ro, bp, ktotal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, out, L, m, rp, np_, remp, k, offset, bc_lo, ro, bp,
                                 ktotal, s);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
