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
// The kernel is stencil3d.cuh's (design, bound and arithmetic there), at
// the Pallas body's order and form (pallas_stencil.py:470-479), each line
// rounded once:
//   s     = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1  ORDER_L1
//   lap   = fma(-6, c, s)          the compiled body contracts s - 6*c
//   c'    = fma(maskr, lap, c)     and the masked update           UPD_LAP
// on 16 x 16 x 32 output tiles (196608 bytes of band at k = 8). The kernel
// lab's candidates (lab3d.cu) are other instances of the same body.
//
// Plain C interface (loaded with ctypes): heat_ftcs3d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include "stencil3d.cuh"

namespace {

template <typename T>
int launch(const Args& a) {
  return launch_inst<T, ORDER_L1, UPD_LAP, 16, 16, 32>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bounds: (lo, hi) for rows, mids, cols.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for arguments
// the kernel does not take.
int heat_ftcs3d(int dtype, const void* in, void* out, int64_t m, int64_t mid,
                int64_t n, float r, int k, int row_lo, int row_hi, int mid_lo,
                int mid_hi, int col_lo, int col_hi, void* stream) {
  const Args a = {in, out, m, mid, n, r, k,
                  {{row_lo, mid_lo, col_lo}, {row_hi, mid_hi, col_hi}},
                  static_cast<cudaStream_t>(stream)};
  if (int e = check_args(a)) return e;
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
