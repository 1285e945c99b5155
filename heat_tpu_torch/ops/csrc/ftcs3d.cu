// Fused multistep 3D FTCS stencil (7-point) for Hopper (sm_90a).
//
// Replaces the 3D solo TPU kernel of heat_tpu/ops/pallas_stencil.py:
//   K3 _pallas_3d_aligned (:489, pallas_call :510, body _make_kernel_3d :435)
// It computes k <= KMAX masked 7-point FTCS steps per pass on an f32 band
// and rounds to the storage type once per pass. The TPU kernel tiles
// (row, mid) and keeps the whole lane (column) axis in VMEM; a 512-wide
// f32 column plane does not fit a block's shared memory with its halo, so
// here all three axes are tiled.
//
// Design: each block owns a TZ x TY x TX output tile (row, mid, col) and
// loads the (TZ+2k) x (TY+2k) x (TX+2k) band around it into dynamic shared
// memory as f32 (cells outside the array load as 0.0f, which is finite, so
// a frozen cell's 0*lap stays 0). It runs k mini-steps IN PLACE on that one
// buffer (two buffers at k = 8 would need 384 KB): the valid region shrinks
// by one cell per side per step, and each step sweeps the band's row planes
// in order. A thread owns up to COLS (mid, col) columns of the plane; at
// plane z it reads the in-plane neighbours and plane z+1 (not yet written
// in this step), takes plane z-1's old value from a register, computes the
// new value into a register, and writes it back between two barriers. The
// value read from plane z+1 becomes the next plane's centre, so each
// cell-step costs 5 shared loads and 1 store.
//
// Arithmetic, in the Pallas body's order (pallas_stencil.py:470-479), each
// line rounded once:
//   s     = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1
//   lap   = fma(-6, c, s)          the compiled body contracts s - 6*c
//   c'    = fma(maskr, lap, c)     and the masked update
//   maskr = frozen ? 0 : r         (r rounded to f32; frozen where the GLOBAL
//                                    row/mid/col index <= lo or >= hi)
// Built with -fmad=false so nothing else is contracted; the explicit
// __fmaf_rn still emits its FMA. No fast-math (it flushes subnormals).
//
// Bound on the card: a pass must read and write the field once
// (2 * itemsize * N bytes) and does 9 f32 operations per cell-step, so at
// k = 8 it is bounded by bytes. This first version is bounded instead by
// shared-memory traffic, the barriers of the plane sweep, and the halo's
// redundant work ((TZ+2k)(TY+2k)(TX+2k) cells loaded for TZ*TY*TX kept);
// PERF.md has its times.
//
// Plain C interface (loaded with ctypes): heat_ftcs3d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 8;                 // max steps per pass (halo width)
constexpr int TZ = 16;                  // output tile: rows
constexpr int TY = 16;                  //              mids
constexpr int TX = 32;                  //              cols
constexpr int NT = 512;                 // threads per block
constexpr int PMAX = (TY + 2 * KMAX) * (TX + 2 * KMAX);  // plane cells, 1536
constexpr int COLS = (PMAX + NT - 1) / NT;               // columns per thread
constexpr int SMEM_MAX = (TZ + 2 * KMAX) * PMAX * (int)sizeof(float);  // 196608 B

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Bounds {
  int lo[3];
  int hi[3];
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ftcs3d_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t m,
              int64_t mid, int64_t n, float r, int k, Bounds b) {
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
          float sum = dn + up[j];                          // + row-1
          sum = sum + pl[i + BX];                          // + mid+1
          sum = sum + pl[i - BX];                          // + mid-1
          sum = sum + pl[i - 1];                           // + col-1
          sum = sum + pl[i + 1];                           // + col+1
          const float lap = __fmaf_rn(-6.0f, c[j], sum);
          const float maskr = (z_frozen || yx_frozen[j]) ? 0.0f : r;
          nv[j] = __fmaf_rn(maskr, lap, c[j]);
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

template <typename T>
int launch(const void* in, void* out, int64_t m, int64_t mid, int64_t n,
           float r, int k, Bounds b, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only after opting in (per device,
  // so on every launch: it costs about a microsecond of host time)
  cudaError_t e = cudaFuncSetAttribute(
      ftcs3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(TZ + 2 * k) * (TY + 2 * k) * (TX + 2 * k) *
                      sizeof(float);
  dim3 grid((unsigned)((n + TX - 1) / TX), (unsigned)((mid + TY - 1) / TY),
            (unsigned)((m + TZ - 1) / TZ));
  ftcs3d_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, mid, n, r, k, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bounds: (lo, hi) for rows, mids, cols.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for arguments
// the kernel does not take.
int heat_ftcs3d(int dtype, const void* in, void* out, int64_t m, int64_t mid,
                int64_t n, float r, int k, int row_lo, int row_hi, int mid_lo,
                int mid_hi, int col_lo, int col_hi, void* stream) {
  if (k < 1 || k > KMAX || m < 1 || mid < 1 || n < 1 ||
      (mid + TY - 1) / TY > 65535 || (m + TZ - 1) / TZ > 65535 ||
      (n + TX - 1) / TX > 2147483647 || in == out)
    return (int)cudaErrorInvalidValue;
  const Bounds b = {{row_lo, mid_lo, col_lo}, {row_hi, mid_hi, col_hi}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, m, mid, n, r, k, b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(in, out, m, mid, n, r, k, b, s);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
