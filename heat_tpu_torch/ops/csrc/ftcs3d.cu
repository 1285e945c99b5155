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
// The kernel is stencil3d_stream.cuh's (design and resources there): rows
// streamed through the block and the k steps pipelined as a wavefront, at
// the Pallas body's order and form (pallas_stencil.py:470-479), each line
// rounded once:
//   s     = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1  ORDER_L1
//   lap   = fma(-6, c, s)          the compiled body contracts s - 6*c
//   c'    = fma(maskr, lap, c)     and the masked update           UPD_LAP
// on 32 x 32 (mid, col) output tiles and segments of up to 256 rows (sized
// so that the blocks fill whole waves of the card), one thread per
// 4 cells of the tile and its halo (576 threads at k = 8). The kernel lab
// (lab3d.cu) compiles the same instances as its first tile, beside
// stencil3d.cuh's in-place band body (this kernel's earlier design), which
// computes the same bytes.
//
// Bound on the card: a pass reads and writes the field once
// (2 * itemsize * N bytes) and does 9 f32 operations per cell-step, so it is
// bounded by bytes up to k = 8. The design spends instead the in-plane
// halo's redundant steps (up to (32+2k)^2 cells stepped for 32^2 kept),
// shared-memory traffic (two float4 loads, one float4 store and two
// shuffles per 4 cells and step) and one barrier per streamed row plane;
// PERF.md has its times.
//
// Plain C interface (loaded with ctypes): heat_ftcs3d() launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// launch's cudaError_t.

#include "stencil3d_stream.cuh"

namespace {

template <typename T>
int launch(const Args& a) {
  return launch_stream<T, ORDER_L1, UPD_LAP, STREAM_LZ, STREAM_TY, STREAM_TX>(a);
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
