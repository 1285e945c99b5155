// The 3D (7-point) FTCS multistep kernel for Hopper (sm_90a): one body for
// the shipped kernel (ftcs3d.cu, one instance) and the kernel lab's
// candidates (lab3d.cu), so that an A/B of a candidate against the shipped
// kernel compares like with like, and a redesign is made once.
//
// It computes k <= KMAX masked 7-point FTCS steps per launch on an f32 band
// and rounds to the storage type once per launch. Templated on the
// neighbour order, the update form, the storage type and the output tile
// TZ x TY x TX (row, mid, col).
//
// Design: each block owns a TZ x TY x TX output tile and loads the
// (TZ+2k) x (TY+2k) x (TX+2k) band around it into dynamic shared memory as
// f32 (cells outside the array load as 0.0f, which is finite, so a frozen
// cell's 0*lap stays 0). It runs k mini-steps IN PLACE on that one buffer
// (two buffers at k = 8 would need 384 KB at the 16 x 16 x 32 tile): the
// valid region shrinks by one cell per side per step, and each step sweeps
// the band's row planes in order. A thread owns up to COLS (mid, col)
// columns of the plane; at plane z it reads the in-plane neighbours and
// plane z+1 (not yet written in this step), takes plane z-1's old value
// from a register, computes the new value into a register, and writes it
// back between two barriers. The value read from plane z+1 becomes the
// next plane's centre, so each cell-step costs 5 shared loads and 1 store.
// A tile whose band at k steps needs more shared memory than a block may
// have does not launch (cudaErrorInvalidValue).
//
// Arithmetic per cell and mini-step, each line rounded once (maskr =
// frozen ? 0 : r, r rounded to f32; frozen where the GLOBAL row/mid/col
// index <= lo or >= hi):
//   ORDER_L1:  s = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1
//   ORDER_L2:  s = ((((row-1 + row+1) + mid-1) + mid+1) + col-1) + col+1
//   UPD_LAP:   c' = fma(maskr, fma(-6, c, s), c)
//   UPD_DECAY: c' = fma(decay, c, maskr*s), decay = fma(-6, maskr, 1)
// Built with -fmad=false so nothing else is contracted; the explicit
// __fmaf_rn still emits its FMA. No fast-math (it flushes subnormals).
//
// Bound on the card: a pass reads and writes the field once
// (2 * itemsize * N bytes) and does 9 (lap) or 8 (decay) f32 operations per
// cell-step, so at k = 8 it is bounded by bytes. This version is bounded
// instead by shared-memory traffic, the barriers of the plane sweep, and
// the halo's redundant work ((TZ+2k)(TY+2k)(TX+2k) cells loaded for
// TZ*TY*TX kept); PERF.md has its times.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int KMAX = 8;                 // max steps per launch (halo width)
constexpr int NT = 512;                 // threads per block
constexpr int SMEM_LIMIT = 232448;      // bytes a block may opt into

enum { ORDER_L1 = 0, ORDER_L2 = 1 };
enum { UPD_LAP = 0, UPD_DECAY = 1 };

template <int TY, int TX> struct Plane {
  static constexpr int PMAX = (TY + 2 * KMAX) * (TX + 2 * KMAX);  // plane cells
  static constexpr int COLS = (PMAX + NT - 1) / NT;               // per thread
};

struct Bounds {
  int lo[3];
  int hi[3];
};

template <typename T, int ORDER, int UPD, int TZ, int TY, int TX>
__global__ void __launch_bounds__(NT, 1)
ftcs3d_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t m,
              int64_t mid, int64_t n, float r, int k, Bounds b) {
  constexpr int COLS = Plane<TY, TX>::COLS;
  extern __shared__ float band[];
  const int BZ = TZ + 2 * k;
  const int BY = TY + 2 * k;
  const int BX = TX + 2 * k;
  const int P = BY * BX;
  const int64_t z0 = (int64_t)blockIdx.z * TZ - k;  // global row of band plane 0
  const int64_t y0 = (int64_t)blockIdx.y * TY - k;
  const int64_t x0 = (int64_t)blockIdx.x * TX - k;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < BZ * P; idx += NT) {
    const int z = idx / P;
    const int rem = idx - z * P;
    const int y = rem / BX;
    const int x = rem - y * BX;
    const int64_t gz = z0 + z;
    const int64_t gy = y0 + y;
    const int64_t gx = x0 + x;
    float v = 0.0f;
    if (gz >= 0 && gz < m && gy >= 0 && gy < mid && gx >= 0 && gx < n)
      v = load_f(in + (gz * mid + gy) * n + gx);
    band[idx] = v;
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    // mini-step s updates planes [s+1, BZ-s-2] x mids [s+1, BY-s-2] x
    // cols [s+1, BX-s-2]
    const int zlo = s + 1;
    const int zhi = BZ - s - 2;
    int col[COLS];
    bool active[COLS];
    bool yx_frozen[COLS];
    float up[COLS];
    float c[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      col[j] = tid + j * NT;
      const int y = col[j] / BX;
      const int x = col[j] - y * BX;
      active[j] = col[j] < P && y >= s + 1 && y <= BY - s - 2 && x >= s + 1 &&
                  x <= BX - s - 2;
      const int64_t gy = y0 + y;
      const int64_t gx = x0 + x;
      yx_frozen[j] = gy <= b.lo[1] || gy >= b.hi[1] || gx <= b.lo[2] ||
                     gx >= b.hi[2];
      up[j] = active[j] ? band[(zlo - 1) * P + col[j]] : 0.0f;
      c[j] = active[j] ? band[zlo * P + col[j]] : 0.0f;
    }
    for (int z = zlo; z <= zhi; ++z) {
      const int64_t gz = z0 + z;
      const bool z_frozen = gz <= b.lo[0] || gz >= b.hi[0];
      const float* pl = band + z * P;
      float nv[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        nv[j] = 0.0f;
        if (active[j]) {
          const int i = col[j];
          const float dn = pl[P + i];                      // row+1
          float sum;
          if (ORDER == ORDER_L1) {
            sum = dn + up[j];                              // row+1 + row-1
            sum = sum + pl[i + BX];                        // + mid+1
            sum = sum + pl[i - BX];                        // + mid-1
          } else {
            sum = up[j] + dn;                              // row-1 + row+1
            sum = sum + pl[i - BX];                        // + mid-1
            sum = sum + pl[i + BX];                        // + mid+1
          }
          sum = sum + pl[i - 1];                           // + col-1
          sum = sum + pl[i + 1];                           // + col+1
          const float maskr = (z_frozen || yx_frozen[j]) ? 0.0f : r;
          if (UPD == UPD_LAP) {
            const float lap = __fmaf_rn(-6.0f, c[j], sum);
            nv[j] = __fmaf_rn(maskr, lap, c[j]);
          } else {
            const float decay = __fmaf_rn(-6.0f, maskr, 1.0f);
            nv[j] = __fmaf_rn(decay, c[j], maskr * sum);
          }
          up[j] = c[j];
          c[j] = dn;
        }
      }
      __syncthreads();  // every read of plane z is done
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (active[j]) band[z * P + col[j]] = nv[j];
      __syncthreads();  // plane z is new before plane z+1 reads it
    }
  }

  for (int idx = tid; idx < TZ * TY * TX; idx += NT) {
    const int z = idx / (TY * TX);
    const int rem = idx - z * (TY * TX);
    const int y = rem / TX;
    const int x = rem - y * TX;
    const int64_t gz = z0 + k + z;
    const int64_t gy = y0 + k + y;
    const int64_t gx = x0 + k + x;
    if (gz < m && gy < mid && gx < n)
      store_f(out + (gz * mid + gy) * n + gx,
              band[(z + k) * P + (y + k) * BX + (x + k)]);
  }
}

struct Args {
  const void* in;
  void* out;
  int64_t m, mid, n;
  float r;
  int k;
  Bounds b;
  cudaStream_t stream;
};

// Arguments no instance takes: cudaErrorInvalidValue, else 0.
inline int check_args(const Args& a) {
  if (a.k < 1 || a.k > KMAX || a.m < 1 || a.mid < 1 || a.n < 1 ||
      a.in == a.out)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int ORDER, int UPD, int TZ, int TY, int TX>
int launch_inst(const Args& a) {
  const size_t smem = (size_t)(TZ + 2 * a.k) * (TY + 2 * a.k) * (TX + 2 * a.k) *
                      sizeof(float);
  if (smem > (size_t)SMEM_LIMIT || (a.mid + TY - 1) / TY > 65535 ||
      (a.m + TZ - 1) / TZ > 65535 || (a.n + TX - 1) / TX > 2147483647)
    return (int)cudaErrorInvalidValue;
  auto kernel = ftcs3d_kernel<T, ORDER, UPD, TZ, TY, TX>;
  // above 48 KB of dynamic shared memory only after opting in (per device,
  // so on every launch: it costs about a microsecond of host time)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.n + TX - 1) / TX), (unsigned)((a.mid + TY - 1) / TY),
            (unsigned)((a.m + TZ - 1) / TZ));
  kernel<<<grid, NT, smem, a.stream>>>(static_cast<const T*>(a.in),
                                       static_cast<T*>(a.out), a.m, a.mid, a.n,
                                       a.r, a.k, a.b);
  return (int)cudaGetLastError();
}

}  // namespace
