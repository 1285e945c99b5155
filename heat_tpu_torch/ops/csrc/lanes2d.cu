// Multi-lane 2D FTCS serving kernel for Hopper (sm_90a).
//
// Replaces K4 of heat_tpu/ops/pallas_stencil.py: _lane_pallas_2d (:1115,
// body _make_lane_kernel_2d :1050). The serving engine stacks L independent
// requests as one (L, m, m) array, m = bucket side + 2; lane l holds its
// request in the [1, n_l] corner with its own r_l, side n_l and countdown
// rem_l (device vectors). One launch runs k <= 16 masked, gated steps of
// every lane (cuda_lanes.passes launches at most 8 at a time).
//
// Design: stencil2d_stream.cuh's streamed body (the one ftcs2d.cu runs),
// with the lane as blockIdx.z and LaneCells below as its cells. A warp
// streams the rows of a region 128 cells wide (4 cells a thread; its
// middle 128 - 2k columns are output) once, from k rows before its segment
// to k after, and runs the k steps as a wavefront in registers: when row p
// arrives, step t computes row p - t. Column neighbours come from warp
// shuffles; no shared memory, no barrier. Segments of 8 to 256 rows are
// sized so that all lanes' blocks together fill whole waves of the card
// (stream2_lz with the column blocks times L; cuda_lanes.lanes2d_geometry
// mirrors the launch geometry). Each block reads its lane's r_l, n_l and
// rem_l once. k is a template parameter (one instance per depth 1..16 and
// dtype): a runtime k or a break in the step loop would send the
// pipeline's state to local memory.
//
// Arithmetic, in the reference lane programs' order (laplacian_interior:
// +1 neighbours in axis order, then -1 neighbours; see cuda_lanes.py):
//   s    = ((dn + rt) + up) + lf
//   lap  = s + (-4*c)                      (-4*c is exact)
//   u    = fma(r_l, lap, c)                ONE rounding, as the reference's
//                                           compiled update contracts it
//   u    = round(u) to the storage type    EVERY step (bf16: round to nearest
//                                           even, two cells per packed
//                                           conversion; f32: a NaN is written
//                                           as 0x7fc00000, so the bytes do
//                                           not depend on the card's NaN
//                                           payloads)
//   c'   = keep ? u : c                    select, never multiply: a NaN
//                                           stays in its lane, frozen cells
//                                           keep their bytes (one bitwise
//                                           operation on an all-ones or
//                                           all-zeros mask)
// keep = live && offset + s < rem_l, live: bc_lo < row, col < n_l + 1 -
// bc_lo. Built with -fmad=false so that nothing else is contracted. Cells
// outside the lane buffer load as 0 and are never live (a live cell's
// neighbours all lie inside the buffer); stores write the bits as they are
// (every value is one the storage type holds). The f32 NaN rewrite is done
// once, after the pipeline (LaneCells::finish), by the threads that stored
// a non-finite value. A lane's countdown that ends inside the pass gates
// the later steps off through the select (identity steps); a lane with no
// step left in the pass is copied, block-uniformly, before the pipeline
// starts.
//
// When `boundary` is given (the chunk's last pass) the kernel also reduces,
// per lane, into the (6, L) int32 boundary vector that an init launch has
// set to the merge identities (lanes_common.cuh): row 1 the finite bit (AND
// over every stored cell), rows 2-5 float32 resid = max|out -
// pre-final-step|, tmin, tmax and heat over the request region [1, n_l]^2.
// They are taken as step k stores its row: its centre register is the
// value before the final step (equal to out where that step was gated off,
// so resid is 0 there without a test). Heat is summed per row of a
// thread's 4 cells and the rows compensated (Kahan), then across the warp,
// the block (publish) and the blocks (one atomic per block and stat).
//
// Bound on the card: a pass reads and writes the stack once
// (2 * itemsize * L * m^2 bytes) and does 7 f32 operations per live
// cell-step (3 adds, the exact -4*c, an add, the FMA as 2), so at 16 steps
// it sits near the balance of HBM and the f32 rate. The streamed design
// spends about 8 issued instructions per cell-step evaluated (the 7
// operations, the select, a share of the shuffles, loads and stores; bf16
// adds the rounding), times the redundant columns (128 / (128 - 2k)) and
// rows ((LZ + 2k) / LZ); PERF.md has its times, and why a chunk runs two
// 8-step passes rather than one of 16.
//
// The earlier design (PR 3's: a (64+2k) x (96+2k) f32 band in shared
// memory, a barrier per step) is kept as heat_lanes2d_band, with the same
// arguments, to time and hold both on one stack; the serve path never
// reaches it.
//
// Plain C interface (loaded with ctypes): heat_lanes2d() and
// heat_lanes2d_band() launch on the given stream, allocate nothing, do not
// synchronise, and return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lanes_common.cuh"
#include "stencil2d_stream.cuh"

namespace {

constexpr int LANE_KMAX = 16;            // max steps per launch
constexpr int LANE_LZMIN = 8;            // fewest rows a segment

// The lane kernel's cells (stencil2d_stream.cuh's policy interface): the
// lane programs' arithmetic above, and the fused per-lane partials.
template <typename T>
struct LaneCells {
  static constexpr bool LANE = true;
  static constexpr int G = 4;
  float r;             // the lane's r_l
  int rlo, rhi;        // live rows and columns: rlo < index < rhi
  int nreg;            // request region: [1, nreg] on both axes
  int ton;             // steps 1..ton of the pass are on (may exceed k)
  bool fast;           // every step of the pass on
  bool done;           // no step of the pass on: the lane is copied
  bool stats;          // the chunk's last pass: the partials are published
  unsigned live = 0;   // bit c: the thread's cell c lies in a live column
  unsigned region = 0; // bit c: cell c is stored and in a region column
  unsigned lmask[G];   // all ones where cell c's column is live, else 0
  // partials of the stored cells: finite probe, resid, and over the
  // region tmin, tmax, heat and its compensation
  float probe = 0.0f, resid = 0.0f, tmin = INFINITY, tmax = -INFINITY;
  float heat = 0.0f, comp = 0.0f;

  __device__ __forceinline__ void columns(int64_t gx, unsigned keep) {
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int64_t g = gx + c;
      if (g > rlo && g < rhi) live |= 1u << c;
      if ((keep >> c & 1u) && g >= 1 && g <= nreg) region |= 1u << c;
      lmask[c] = live >> c & 1u ? 0xffffffffu : 0u;
    }
  }
  // all ones where step t keeps its updates on row gz (the body without
  // tests runs only where every step and row does)
  template <bool FAST>
  __device__ __forceinline__ unsigned row(int t, int gz) const {
    return FAST || (gz > rlo && gz < rhi && t <= ton) ? 0xffffffffu : 0u;
  }
  // the update u of cell c, before its rounding and select (keep)
  template <bool FAST>
  __device__ __forceinline__ float cell(unsigned, int, float up, float cc,
                                        float dn, float lf, float rt) const {
    const float sum = ((dn + rt) + up) + lf;
    const float lap = sum + (-4.0f * cc);
    return __fmaf_rn(r, lap, cc);
  }
  // the thread's updates u rounded to bf16 two cells at a time (one packed
  // conversion, __floats2bfloat162_rn: round to nearest even, as
  // __float2bfloat16_rn), then kept by a select as one bitwise operation
  // on the masks, not a branch or a predicate per cell
  template <bool FAST>
  __device__ __forceinline__ void keep(unsigned z_keep, float (&u)[G],
                                       const float (&cc)[G]) const {
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int c = 0; c < G; c += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(u[c], u[c + 1]);
        const unsigned b = *reinterpret_cast<const unsigned*>(&h);
        u[c] = __uint_as_float(b << 16);             // .x, the low half
        u[c + 1] = __uint_as_float(b & 0xffff0000u);
      }
    }
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const unsigned k = FAST ? lmask[c] : lmask[c] & z_keep;
      u[c] = __uint_as_float((__float_as_uint(u[c]) & k) |
                             (__float_as_uint(cc[c]) & ~k));
    }
  }
  // step k's row gz before its store (or a copied row, pre = v): the
  // partials. The finite probe turns NaN at the first non-finite v (v * 0),
  // on every pass (finish() reads it); the rest only on the last. resid
  // over every stored cell: a cell that is not live keeps its value, so
  // outside the live region |v - pre| is 0 or NaN, which fmaxf skips; so
  // it is the max over the region.
  __device__ __forceinline__ void output(int gz, const float (&v)[G],
                                         const float (&pre)[G],
                                         unsigned keep) {
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (keep >> c & 1u) probe = __fmaf_rn(v[c], 0.0f, probe);
    if (!stats) return;
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (keep >> c & 1u) resid = fmaxf(resid, fabsf(v[c] - pre[c]));
    if (region != 0 && gz >= 1 && gz <= nreg) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        if (region >> c & 1u) {
          tmin = fminf(tmin, v[c]);
          tmax = fmaxf(tmax, v[c]);
          s += v[c];
        }
      }
      const float y = s - comp;
      const float t = heat + y;
      comp = (t - heat) - y;
      heat = t;
    }
  }
  // Once the pipeline is done: an f32 NaN that a live cell computed is
  // written as 0x7fc00000. A live cell is computed at the pass's first
  // step and a NaN stays NaN at every later one; only its payload depends
  // on when it is rewritten, so this gives the bytes of a rewrite at every
  // step. Only a thread that stored a non-finite value has one to rewrite.
  template <class Row>
  __device__ __forceinline__ void finish(Row row, int zs, int nout,
                                         unsigned keep) {
    if constexpr (std::is_same<T, float>::value) {
      if (!isnan(probe)) return;
      for (int q = 0; q < nout; ++q) {
        const int gz = zs + q;
        if (gz <= rlo || gz >= rhi) continue;
        T* p = row(gz);
#pragma unroll
        for (int c = 0; c < G; ++c)
          if ((keep & live) >> c & 1u && isnan(p[c]))
            p[c] = __int_as_float(0x7fc00000);
      }
    }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(Stream2<K>::THREADS, Stream2<K>::MINB)
lanes2d_stream_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
                      const float* __restrict__ r, const int* __restrict__ n,
                      const int* __restrict__ rem, int offset, int bc_lo,
                      int lz, int* boundary, int L) {
  const int lane = blockIdx.z;
  const int64_t slab = (int64_t)m * m;
  const int n_l = __ldg(n + lane);
  const int left = __ldg(rem + lane) - offset;   // steps of the pass on
  LaneCells<T> cells;
  cells.r = __ldg(r + lane);
  cells.rlo = bc_lo;
  cells.rhi = n_l + 1 - bc_lo;
  cells.nreg = n_l;
  cells.ton = left;
  cells.fast = left >= K;
  cells.done = left < 1;
  cells.stats = boundary != nullptr;
  stream2_body<T, K>(cells, in + lane * slab, out + lane * slab, m, m, lz);
  if (boundary != nullptr)
    publish<Stream2<K>::BW>(boundary, L, lane, isnan(cells.probe) ? 0 : 1,
                            cells.resid, cells.tmin, cells.tmax,
                            cells.heat);
}

// The launch geometry at depth K (cuda_lanes.lanes2d_geometry mirrors it):
// the region's width and output columns, a block's output columns, the
// segment's rows and the grid (column blocks, segments, lanes).
struct LaneGeo {
  int region, out_cols, block_cols, lz, gx, gy, gz;
};

template <int K>
int lanes2d_geo(int L, int m, int64_t slots, LaneGeo* g) {
  using S = Stream2<K>;
  g->region = S::RW;
  g->out_cols = S::BC;
  g->block_cols = S::S * S::BC;
  g->lz = stream2_lz<K>(m, m, g->block_cols, slots, L, LANE_LZMIN);
  if (g->lz < 1) return (int)cudaErrorInvalidValue;   // over 65535 segments
  g->gx = (m + g->block_cols - 1) / g->block_cols;
  g->gy = (m + g->lz - 1) / g->lz;
  g->gz = L;
  return 0;
}

// blocks of the depth-K instance resident on the card at once, asked once
template <typename T, int K>
int lane_slots(int64_t* slots) {
  static int64_t cached = 0;
  if (cached < 1) {
    if (int e = stream2_slots(lanes2d_stream_kernel<T, K>, Stream2<K>::THREADS,
                              &cached))
      return e;
  }
  *slots = cached;
  return 0;
}

struct LaneArgs {
  const void* in;
  void* out;
  int L, m;
  const float* r;
  const int* n;
  const int* rem;
  int k, offset, bc_lo;
  int* rem_out;
  int* boundary;
  int ktotal;
  cudaStream_t stream;
};

template <typename T, int K>
int launch_stream_at(const LaneArgs& a) {
  int64_t slots = 0;
  if (int e = lane_slots<T, K>(&slots)) return e;
  LaneGeo g;
  if (int e = lanes2d_geo<K>(a.L, a.m, slots, &g)) return e;
  if (cudaError_t e = init_boundary(a.rem, a.rem_out, a.boundary, a.L,
                                    a.ktotal, a.stream))
    return (int)e;
  lanes2d_stream_kernel<T, K><<<dim3(g.gx, g.gy, g.gz), Stream2<K>::THREADS,
                                0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.r, a.n,
      a.rem, a.offset, a.bc_lo, g.lz, a.boundary, a.L);
  return (int)cudaGetLastError();
}

// f at the run-time depth k (1 .. LANE_KMAX), as a compile-time constant
template <int K = 1, class F>
int at_depth(int k, F f) {
  if (k == K) return f(std::integral_constant<int, K>{});
  if constexpr (K < LANE_KMAX) return at_depth<K + 1>(k, f);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_stream(const LaneArgs& a) {
  return at_depth(a.k, [&](auto K) {
    return launch_stream_at<T, decltype(K)::value>(a);
  });
}

// ---------------------------------------------------------------------------
// The earlier design (heat_lanes2d_band): ftcs2d's PR 1 shared-memory band
// with the lane as blockIdx.z. Each block owns a BR x BC output tile of one
// lane and loads the (BR+2k) x (BC+2k) band around it as f32, then runs
// the k mini-steps ping-ponging two shared buffers, the valid region
// shrinking one cell per side per step. A lane whose countdown runs out
// stops stepping (block-uniform). Same arithmetic, same boundary vector.
namespace band {

constexpr int BR = 64;                   // output tile rows
constexpr int BC = 96;                   // output tile cols
constexpr int TY = 4;                    // row groups
constexpr int TX = BC + 2 * LANE_KMAX;   // threads across the widest band
constexpr int NT = TX * TY;              // 512 threads
constexpr int NWARP = NT / 32;
constexpr int SMEM_MAX =
    2 * (BR + 2 * LANE_KMAX) * (BC + 2 * LANE_KMAX) * (int)sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NT, 2)
lanes2d_band_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
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
int launch(const LaneArgs& a) {
  if ((a.m + BR - 1) / BR > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only after opting in
  cudaError_t e = cudaFuncSetAttribute(lanes2d_band_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  e = init_boundary(a.rem, a.rem_out, a.boundary, a.L, a.ktotal, a.stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 2 * (size_t)(BR + 2 * a.k) * (BC + 2 * a.k) * sizeof(float);
  dim3 grid((unsigned)((a.m + BC - 1) / BC), (unsigned)((a.m + BR - 1) / BR),
            (unsigned)a.L);
  dim3 block(TX, TY);
  lanes2d_band_kernel<T><<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.r, a.n,
      a.rem, a.k, a.offset, a.bc_lo, a.boundary, a.L);
  return (int)cudaGetLastError();
}

}  // namespace band

// The arguments, or cudaErrorInvalidValue for those no launch takes.
int lane_args(int k, const void* in, void* out, int L, int m, const void* r,
              const void* n, const void* rem, int offset, int bc_lo,
              void* rem_out, void* boundary, int ktotal, void* stream,
              LaneArgs* a) {
  if (k < 1 || k > LANE_KMAX || m < 3 || L < 1 || L > 65535 || in == out ||
      (bc_lo != 0 && bc_lo != 1) ||
      (boundary != nullptr) != (rem_out != nullptr) || rem_out == rem)
    return (int)cudaErrorInvalidValue;
  *a = {in, out, L, m, static_cast<const float*>(r), static_cast<const int*>(n),
        static_cast<const int*>(rem), k, offset, bc_lo,
        static_cast<int*>(rem_out), static_cast<int*>(boundary), ktotal,
        static_cast<cudaStream_t>(stream)};
  return 0;
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
  LaneArgs a;
  if (int e = lane_args(k, in, out, L, m, r, n, rem, offset, bc_lo, rem_out,
                        boundary, ktotal, stream, &a))
    return e;
  if (dtype == 0) return launch_stream<float>(a);
  if (dtype == 1) return launch_stream<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// The earlier band design, with heat_lanes2d's arguments and function.
int heat_lanes2d_band(int dtype, const void* in, void* out, int L, int m,
                      const void* r, const void* n, const void* rem, int k,
                      int offset, int bc_lo, void* rem_out, void* boundary,
                      int ktotal, void* stream) {
  LaneArgs a;
  if (int e = lane_args(k, in, out, L, m, r, n, rem, offset, bc_lo, rem_out,
                        boundary, ktotal, stream, &a))
    return e;
  if (dtype == 0) return band::launch<float>(a);
  if (dtype == 1) return band::launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// heat_lanes2d's launch geometry for L lanes of m x m at depth k (dtype as
// heat_lanes2d's) into geo[8]: region width, its output columns, a block's
// output columns, segment rows, grid x, y, z and the resident blocks it
// was sized for (`slots`, or where slots < 1 the card's for that instance).
int heat_lanes2d_geometry(int dtype, int L, int m, int k, int64_t slots,
                          int64_t* geo) {
  if (k < 1 || k > LANE_KMAX || m < 3 || L < 1 || L > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return at_depth(k, [&](auto K) {
    constexpr int D = decltype(K)::value;
    int64_t s = slots;
    if (s < 1) {
      const int e = dtype == 0 ? lane_slots<float, D>(&s)
                               : lane_slots<__nv_bfloat16, D>(&s);
      if (e) return e;
    }
    LaneGeo g;
    if (int e = lanes2d_geo<D>(L, m, s, &g)) return e;
    const int64_t v[8] = {g.region, g.out_cols, g.block_cols, g.lz,
                          g.gx,     g.gy,       g.gz,         s};
    for (int i = 0; i < 8; ++i) geo[i] = v[i];
    return 0;
  });
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
