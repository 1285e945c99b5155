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
// The kernel is stencil2d.cuh's (design, bound and arithmetic there), at
// the Pallas body's order and form (pallas_stencil.py:239-249):
//   lap = ((up + dn) + lf) + rt - 4*c      ORDER_K1
//   c'  = fma(maskr, lap, c)               UPD_LAP, one rounding, as the
//                                          Pallas kernel's compiled update
//                                          contracts it
// rounded to the storage type once per pass, on 64 x 96 output tiles. The
// kernel lab's candidates (lab2d.cu) are other instances of the same body.
//
// Plain C interface (loaded with ctypes): heat_ftcs2d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include "stencil2d.cuh"

namespace {

template <typename T>
int launch(const Args& a) {
  return launch_kh<T, ORDER_K1, UPD_LAP, false, 64, 96>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for arguments the kernel does not take.
int heat_ftcs2d(int dtype, const void* in, void* out, int64_t m, int64_t n,
                float r, int k, int rlo, int rhi, int clo, int chi,
                void* stream) {
  const Args a = {in, out, m, n, r, k, rlo, rhi, clo, chi,
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
