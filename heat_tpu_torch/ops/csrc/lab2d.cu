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
// variant) is compiled in two designs of one function:
// stencil2d_stream.cuh's streamed wavefront, the body that ftcs2d.cu (the
// shipped kernel) instantiates (the candidate (K1, lap, once per call) at
// its tile IS the shipped kernel, so an A/B of a candidate against it
// compares like with like), and stencil2d.cuh's band, the shipped kernel's
// earlier design. The forms (cuda_lab.FORMS):
//   L3 shrink, rolled; L5 f32       ORDER_K1, UPD_LAP (K1's form)
//   L3 rolledfma; L5 fma            ORDER_K1, UPD_DECAY
//   L3 bf16native; L5 bf16native    ORDER_K1, UPD_LAP, every step
//   L5 bf16fma                      ORDER_K1, UPD_DECAY, every step
//   L4                              ORDER_L4, UPD_LAP
// the forms the interpret-mode Pallas bodies compute (their compiled update
// contracts into one fma); "every step" rounds the band to the storage
// type after each step (bf16native/bf16fma hold the band in bf16), the
// others once per call. Each is compiled at three Hopper tiles: the
// streamed design's segments of up to 256 rows of a 128-wide region (the
// shipped configuration, at the depths 1, 5, 6, 16 and 32 that the lab's
// experiments run), and the band design's 64 x 96 and 32 x 192 output
// tiles (every depth 1..32).
//
// Plain C interface (loaded with ctypes): heat_lab2d() launches on the given
// stream, allocates nothing, does not synchronise, and returns the launch's
// cudaError_t.

#include "stencil2d_stream.cuh"

namespace {

// the band design's output tiles, BLOCKS_2D[1:] in cuda_lab's order
constexpr int BAND_TILES[2][2] = {{64, 96}, {32, 192}};

// f at the streamed tile's depth k, one of those the lab's experiments run
// (cuda_lab.STREAM_2D_DEPTHS: an instance per depth and form, and all 32
// would take the build minutes)
template <class F>
int at_stream_depth(int k, F f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the compiled tiles, in the order of cuda_lab.BLOCKS_2D: the streamed tile,
// then the band tiles
template <typename T, int ORDER, int UPD, bool EVERY>
int launch_tile(int tile, const Args& a) {
  if (tile == 0)
    return at_stream_depth(a.k, [&](auto K) {
      return launch_stream2_at<T, ORDER, UPD, EVERY, decltype(K)::value>(a);
    });
  if (tile == 1)
    return launch_kh<T, ORDER, UPD, EVERY, BAND_TILES[0][0], BAND_TILES[0][1]>(a);
  if (tile == 2)
    return launch_kh<T, ORDER, UPD, EVERY, BAND_TILES[1][0], BAND_TILES[1][1]>(a);
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

// The compiled tile's geometry at depth k into geo[3]: its rows and
// columns (the streamed tile: the most rows of a segment and the region's
// width; a band tile: its output tile) and the shared memory of a launch
// (the streamed instance's static shared memory as compiled, a band's
// dynamic shared memory), for cuda_lab to hold its own figures to.
// cudaErrorInvalidValue for a tile or depth that is not compiled.
int heat_lab2d_geometry(int tile, int k, int* geo) {
  if (tile == 0)
    return at_stream_depth(k, [&](auto K) {
      constexpr int D = decltype(K)::value;
      cudaFuncAttributes at;
      if (cudaError_t e = cudaFuncGetAttributes(
              &at, ftcs2d_stream_kernel<float, ORDER_K1, UPD_LAP, false, D>))
        return (int)e;
      geo[0] = STREAM2_LZMAX;
      geo[1] = Stream2<D>::RW;
      geo[2] = (int)at.sharedSizeBytes;
      return 0;
    });
  if (tile < 1 || tile > 2 || k < 1 || k > KMAX)
    return (int)cudaErrorInvalidValue;
  geo[0] = BAND_TILES[tile - 1][0];
  geo[1] = BAND_TILES[tile - 1][1];
  geo[2] = (int)band2_smem(geo[0], geo[1], k);
  return 0;
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
