// Candidate 2D FTCS multistep bodies of the kernel lab, for Hopper (sm_90a).
//
// Replaces the kernel lab's 2D Pallas kernels (benchmarks/kernel_lab.py):
//   L3 pallas_thin2d_variant     (:474, pallas_call :486; body :408)
//      variants shrink, rolled, rolledfma, bf16native
//   L4 pallas_2d_coltiled        (:628, pallas_call :662; body :586)
//   L5 pallas_2d_coltiled_rolled (:744, pallas_call :779; body :673)
//      variants f32, fma, bf16native, bf16fma
// They compute k masked FTCS steps on an f32 band and differ in the
// neighbour order, the update form and how often the band is rounded to
// the storage type; their TPU block shapes (row bands, 3x3 halo blocks,
// rolls or shrinking slices) change no byte. Here each (function,
// variant) is an instance of stencil2d.cuh's kernel, the body that ftcs2d.cu
// (the shipped kernel) instantiates too: the candidate (K1, lap, once per
// call) at the 64 x 96 tile IS the shipped kernel, so an A/B of a candidate
// against it compares like with like. The forms (cuda_lab.FORMS):
//   L3 shrink, rolled; L5 f32       ORDER_K1, UPD_LAP (K1's form)
//   L3 rolledfma; L5 fma            ORDER_K1, UPD_DECAY
//   L3 bf16native; L5 bf16native    ORDER_K1, UPD_LAP, every step
//   L5 bf16fma                      ORDER_K1, UPD_DECAY, every step
//   L4                              ORDER_L4, UPD_LAP
// the forms the interpret-mode Pallas bodies compute (their compiled update
// contracts into one fma); "every step" rounds the band to the storage
// type after each step (bf16native/bf16fma hold the band in bf16), the
// others once per call. Each is compiled at two Hopper tiles, 64 x 96 and
// 32 x 192.
//
// Plain C interface (loaded with ctypes): heat_lab2d() launches on the given
// stream, allocates nothing, does not synchronise, and returns the launch's
// cudaError_t.

#include "stencil2d.cuh"

namespace {

// the compiled tiles, in the order of cuda_lab.BLOCKS_2D
template <typename T, int ORDER, int UPD, bool EVERY>
int launch_tile(int tile, const Args& a) {
  if (tile == 0) return launch_kh<T, ORDER, UPD, EVERY, 64, 96>(a);
  if (tile == 1) return launch_kh<T, ORDER, UPD, EVERY, 32, 192>(a);
  return (int)cudaErrorInvalidValue;
}

// the five forms of cuda_lab.FORMS
template <typename T>
int launch_form(int order, int update, int every, int tile, const Args& a) {
  if (order == ORDER_K1 && update == UPD_LAP && !every)
    return launch_tile<T, ORDER_K1, UPD_LAP, false>(tile, a);
  if (order == ORDER_K1 && update == UPD_DECAY && !every)
    return launch_tile<T, ORDER_K1, UPD_DECAY, false>(tile, a);
  if (order == ORDER_K1 && update == UPD_LAP && every)
    return launch_tile<T, ORDER_K1, UPD_LAP, true>(tile, a);
  if (order == ORDER_K1 && update == UPD_DECAY && every)
    return launch_tile<T, ORDER_K1, UPD_DECAY, true>(tile, a);
  if (order == ORDER_L4 && update == UPD_LAP && !every)
    return launch_tile<T, ORDER_L4, UPD_LAP, false>(tile, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; order: 0 = K1, 1 = L4; update: 0 = lap,
// 1 = decay; every: round to storage after each step; tile: index into the
// compiled tiles. Returns a cudaError_t (0 = launched); cudaErrorInvalidValue
// for arguments the kernel does not take.
int heat_lab2d(int dtype, int order, int update, int every, int tile,
               const void* in, void* out, int64_t m, int64_t n, float r, int k,
               int rlo, int rhi, int clo, int chi, void* stream) {
  const Args a = {in, out, m, n, r, k, rlo, rhi, clo, chi,
                  static_cast<cudaStream_t>(stream)};
  if (int e = check_args(a)) return e;
  if (dtype == 0) return launch_form<float>(order, update, every, tile, a);
  if (dtype == 1) return launch_form<__nv_bfloat16>(order, update, every, tile, a);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
