// Candidate 3D FTCS multistep bodies of the kernel lab, for Hopper (sm_90a).
//
// Replaces the kernel lab's 3D Pallas kernels (benchmarks/kernel_lab.py):
//   L1 pallas_3d_tiled  (:171, pallas_call :206; body make_3d_tiled :122)
//   L2 pallas_3d_rolled (:279, pallas_call :314; body make_3d_rolled :229)
//      variants f32, fma
// They compute k masked 7-point FTCS steps on an f32 band, rounded to the
// storage type once per call, and differ in the neighbour order and the
// update form; their TPU block shapes ((row, mid) tiles with 3x3 halo
// blocks, shrinking slices or rolls on every axis) change no byte. Here
// each (function, variant) is compiled in two designs of one function:
// stencil3d_stream.cuh's streamed wavefront, the body that ftcs3d.cu (the
// shipped kernel) instantiates (L1 at its tile IS the shipped kernel, so an
// A/B of a candidate against it compares like with like), and
// stencil3d.cuh's in-place band, the shipped kernel's earlier design. The
// forms (cuda_lab.FORMS):
//   L1            ORDER_L1, UPD_LAP (K3's form)
//   L2 f32        ORDER_L2, UPD_LAP
//   L2 fma        ORDER_L2, UPD_DECAY
// the forms the interpret-mode Pallas bodies compute (their compiled bodies
// contract s - 6c, the update and the hoisted decay into fmas). Each is
// compiled at three Hopper tiles: the streamed design's 256-row segments of
// 32 x 32 (mid, col) tiles (the shipped configuration, at each depth 1..8),
// and the band design's 16 x 16 x 32 and 8 x 16 x 64 output tiles; the
// last fits up to 7 steps (at 8 its band needs 245760 bytes, over the
// 232448 a block may have).
//
// Plain C interface (loaded with ctypes): heat_lab3d() launches on the given
// stream, allocates nothing, does not synchronise, and returns the launch's
// cudaError_t.

#include "stencil3d_stream.cuh"

namespace {

// the compiled tiles, in the order of cuda_lab.BLOCKS_3D
template <typename T, int ORDER, int UPD>
int launch_tile(int tile, const Args& a) {
  if (tile == 0)
    return launch_stream<T, ORDER, UPD, STREAM_LZ, STREAM_TY, STREAM_TX>(a);
  if (tile == 1) return launch_inst<T, ORDER, UPD, 16, 16, 32>(a);
  if (tile == 2) return launch_inst<T, ORDER, UPD, 8, 16, 64>(a);
  return (int)cudaErrorInvalidValue;
}

// the three forms of cuda_lab.FORMS
template <typename T>
int launch_form(int order, int update, int tile, const Args& a) {
  if (order == ORDER_L1 && update == UPD_LAP)
    return launch_tile<T, ORDER_L1, UPD_LAP>(tile, a);
  if (order == ORDER_L2 && update == UPD_LAP)
    return launch_tile<T, ORDER_L2, UPD_LAP>(tile, a);
  if (order == ORDER_L2 && update == UPD_DECAY)
    return launch_tile<T, ORDER_L2, UPD_DECAY>(tile, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; order: 0 = L1, 1 = L2; update: 0 = lap,
// 1 = decay; tile: index into the compiled tiles; bounds: (lo, hi) for
// rows, mids, cols. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for arguments the kernel does not take.
int heat_lab3d(int dtype, int order, int update, int tile, const void* in,
               void* out, int64_t m, int64_t mid, int64_t n, float r, int k,
               int row_lo, int row_hi, int mid_lo, int mid_hi, int col_lo,
               int col_hi, void* stream) {
  const Args a = {in, out, m, mid, n, r, k,
                  {{row_lo, mid_lo, col_lo}, {row_hi, mid_hi, col_hi}},
                  static_cast<cudaStream_t>(stream)};
  if (int e = check_args(a)) return e;
  if (dtype == 0) return launch_form<float>(order, update, tile, a);
  if (dtype == 1) return launch_form<__nv_bfloat16>(order, update, tile, a);
  return (int)cudaErrorInvalidValue;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
