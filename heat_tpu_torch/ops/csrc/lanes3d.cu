// Multi-lane 3D FTCS serving kernel for Hopper (sm_90a).
//
// Replaces K5 of heat_tpu/ops/pallas_stencil.py: _lane_pallas_3d (:1279,
// body _make_lane_kernel_3d :1200). The serving engine stacks L independent
// requests as one (L, m, m, m) array, m = bucket side + 2; lane l holds its
// request in the [1, n_l] corner with its own r_l, side n_l and countdown
// rem_l (device vectors). K4's contract in 3D. One launch runs k <= 8
// masked, gated steps of every lane (cuda_lanes.passes launches PASS_3D at a
// time).
//
// Design: stencil3d_stream.cuh's streamed body (the one ftcs3d.cu runs),
// with LaneCells below as its cells and the lane sharing the grid's x axis
// with the column tiles (lane = blockIdx.x / tiles: within the grid's
// limits for every L <= 65535). A block owns a (mid, col) output tile and a
// segment of rows of one lane, streams the rows of its region, the tile and
// a k-cell halo, once from k rows before the segment to k after, and runs
// the k steps as a wavefront: when plane p has arrived, step t computes
// plane p - t. A thread keeps 4 cells of a region row and, per step, their
// row-1 and row values in registers; the mid+-1 neighbours come from a
// plane buffer per step in shared memory, the col+-1 ones from warp
// shuffles; one barrier per streamed plane. The tile is sized to the
// bucket: at most 48 x 48 at k <= 4 (one block of up to 800 threads per SM;
// at 8 x 258^3 it beat 40 x 40 and the solo kernel's 32 x 32, PERF.md) and
// 32 x 32 above, cut to ceil(m / tiles) on each axis so that no last tile
// holds 2 cells (258 = 6 tiles of 43); the
// segment's rows are chosen so that all lanes' blocks fill whole waves of
// the card (cuda_lanes.lanes3d_geometry mirrors the geometry, and
// heat_lanes3d_geometry exports it). Each block reads its lane's r_l, n_l
// and rem_l once. k is a template parameter (one instance per depth 1..8
// and dtype): a runtime k or a break in the step loop would send the
// pipeline's state to local memory.
//
// Arithmetic, in the reference lane programs' order (laplacian_interior:
// +1 neighbours in axis order, then -1 neighbours; see cuda_lanes.py):
//   s    = ((((row+1 + mid+1) + col+1) + row-1) + mid-1) + col-1
//   lap  = fma(-6, c, s)                   ONE rounding
//   u    = fma(r_l, lap, c)                ONE rounding
//   u    = round(u) to the storage type    EVERY step, before u enters a
//                                           register or the plane buffer
//                                           (bf16: round to nearest even, two
//                                           cells per packed conversion; f32:
//                                           a NaN is written as 0x7fc00000,
//                                           so the bytes do not depend on the
//                                           card's NaN payloads)
//   c'   = keep ? u : c                    select, never multiply: one
//                                           bitwise operation on an all-ones
//                                           or all-zeros mask, so a kept cell
//                                           keeps its bits (NaN payload and
//                                           all) and a NaN stays in its lane
// keep = live && offset + t - 1 < rem_l for step t of the pass, live:
// bc_lo < row, mid, col < n_l + 1 - bc_lo. Built with -fmad=false so that
// nothing else is contracted. Values enter and leave the pipeline with
// their bits as they are (a bf16 widens by a shift, stores take the upper
// half). Cells outside the lane buffer load as 0 and are never live (a
// live cell's neighbours all lie inside the buffer). A lane's countdown
// that ends inside the pass gates the later steps off through the select
// (identity steps); a lane with no step left in the pass is copied,
// block-uniformly, without the pipeline.
//
// When `boundary` is given (the chunk's last pass) the kernel also reduces,
// per lane, into the (6, L) int32 boundary vector that an init launch has
// set to the merge identities (lanes_common.cuh): row 1 the finite bit (AND
// over every stored cell), rows 2-5 float32 resid = max|out -
// pre-final-step|, tmin, tmax and heat over the request region [1, n_l]^3.
// They are taken as step k stores its plane: its centre register is the
// value before the final step (equal to out where that step was gated off,
// so resid is 0 there without a test). Heat is summed per plane over a
// thread's 4 cells and the planes compensated (Kahan), then across the
// warp, the block (publish) and the blocks (one atomic per block and stat).
//
// Bound on the card: a chunk must read and write the stack once
// (2 * itemsize * L * m^3 bytes) and do 9 f32 operations per live cell-step
// (5 adds, two FMAs of 2 each), so a 16-step chunk is bounded by its bytes
// in f32 and by its operations in bf16; each pass moves the stack once
// more. The streamed design spends the in-plane halo's redundant steps
// ((t+2k)^2 cells stepped for t^2 kept), shared-memory traffic (two float4
// loads, one float4 store and two shuffles per 4 cells and step), the
// select and the per-step rounding, and one barrier per streamed plane;
// PERF.md has its times, and the depth a chunk's passes take.
//
// The earlier design (one step per launch, a thread walking its (mid, col)
// column through the rows) is kept as heat_lanes3d_step, with the
// same arguments (k must be 1), to time and hold both on one stack; the
// serve path never reaches it.
//
// Plain C interface (loaded with ctypes): heat_lanes3d() and
// heat_lanes3d_step() launch on the given stream, allocate nothing, do not
// synchronise, and return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lanes_common.cuh"
#include "stencil3d_stream.cuh"

namespace {

constexpr int LANE_KMAX = KMAX;          // max steps per launch (8)
constexpr int LANE_LZMIN = 8;            // fewest rows a segment
constexpr int LANE_LZMAX = 1024;         // most rows a segment

// The lane kernel's shape at depth K: the largest (mid, col) tile TM and
// the streamed body's configuration (threads, shared memory) for it.
template <int K>
struct LaneShape {
  static constexpr int TM = K <= 4 ? 48 : 32;
  using S = Stream<K, TM, TM>;
  static constexpr int NT = S::NT;
  static_assert(S::SMEM + 1024 <= (size_t)SMEM_LIMIT,
                "the plane buffers and publish's arrays fit a block");
};

// The lane kernel's cells (stencil3d_stream.cuh's policy interface): the
// lane programs' arithmetic above, and the fused per-lane partials.
template <typename T>
struct LaneCells {
  static constexpr bool LANE = true;
  float r;             // the lane's r_l
  int rlo, rhi;        // live rows, mids and columns: rlo < index < rhi
  int nreg;            // request region: [1, nreg] on every axis
  int ton;             // steps 1..ton of the pass are on (may exceed k)
  bool done;           // no step of the pass on: the lane is copied
  bool stats;          // the chunk's last pass: the partials are published
  unsigned region = 0; // bit c: cell c is stored and in a region (mid, col)
  unsigned lmask[4];   // all ones where cell c's (mid, col) is live, else 0
  // partials of the stored cells: finite bit, resid, and over the region
  // tmin, tmax, heat and its compensation
  int fin = 1;
  float resid = 0.0f, tmin = INFINITY, tmax = -INFINITY;
  float heat = 0.0f, comp = 0.0f;

  __device__ __forceinline__ void columns(int64_t gy, int64_t gx,
                                          unsigned keep) {
    const bool y_live = gy > rlo && gy < rhi;
    const bool y_region = gy >= 1 && gy <= nreg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t g = gx + c;
      lmask[c] = y_live && g > rlo && g < rhi ? 0xffffffffu : 0u;
      if ((keep >> c & 1u) && y_region && g >= 1 && g <= nreg)
        region |= 1u << c;
    }
  }
  // all ones where step t keeps its updates on row gz
  __device__ __forceinline__ unsigned row(int t, int64_t gz) const {
    return gz > rlo && gz < rhi && t <= ton ? 0xffffffffu : 0u;
  }
  // the update u of a cell, before its rounding and select (keep)
  __device__ __forceinline__ float cell(unsigned, int, float up, float cc,
                                        float dn, float mm, float mp,
                                        float left, float right) const {
    float s = dn + mp;                 // row+1 + mid+1
    s = s + right;                     // + col+1
    s = s + up;                        // + row-1
    s = s + mm;                        // + mid-1
    s = s + left;                      // + col-1
    const float lap = __fmaf_rn(-6.0f, cc, s);
    return __fmaf_rn(r, lap, cc);
  }
  // the thread's updates u rounded to the storage type (bf16 two cells at
  // a time: one packed conversion, __floats2bfloat162_rn, round to nearest
  // even as __float2bfloat16_rn; f32 a NaN as 0x7fc00000), then kept by a
  // select as one bitwise operation on the masks
  __device__ __forceinline__ void keep(unsigned z, float (&u)[4],
                                       const float (&cc)[4]) const {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        u[c] = isnan(u[c]) ? __int_as_float(0x7fc00000) : u[c];
    } else {
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(u[c], u[c + 1]);
        const unsigned b = *reinterpret_cast<const unsigned*>(&h);
        u[c] = __uint_as_float(b << 16);             // .x, the low half
        u[c + 1] = __uint_as_float(b & 0xffff0000u);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned k = lmask[c] & z;
      u[c] = __uint_as_float((__float_as_uint(u[c]) & k) |
                             (__float_as_uint(cc[c]) & ~k));
    }
  }
  // step k's row gz before its store (or a copied row, pre = v): the
  // partials, on the chunk's last pass only. resid over every stored cell:
  // a cell that is not live keeps its value, so outside the live region
  // |v - pre| is 0 or NaN, which fmaxf skips; so it is the max over the
  // region (the live cells lie inside it).
  __device__ __forceinline__ void output(int64_t gz, const float (&v)[4],
                                         const float (&pre)[4],
                                         unsigned keep) {
    if (!stats) return;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (keep >> c & 1u) {
        fin &= isfinite(v[c]) ? 1 : 0;
        resid = fmaxf(resid, fabsf(v[c] - pre[c]));
      }
    }
    if (region != 0 && gz >= 1 && gz <= nreg) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
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
};

template <typename T, int K>
__global__ void __launch_bounds__(LaneShape<K>::NT, 1)
lanes3d_stream_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
                      const float* __restrict__ r, const int* __restrict__ n,
                      const int* __restrict__ rem, int offset, int bc_lo,
                      int tile, int tiles, int lz, int* boundary, int L) {
  constexpr int TM = LaneShape<K>::TM;
  const int lane = blockIdx.x / tiles;
  const int bx = blockIdx.x - lane * tiles;
  const int64_t slab = (int64_t)m * m * m;
  const int n_l = __ldg(n + lane);
  const int left = __ldg(rem + lane) - offset;   // steps of the pass on
  LaneCells<T> cells;
  cells.r = __ldg(r + lane);
  cells.rlo = bc_lo;
  cells.rhi = n_l + 1 - bc_lo;
  cells.nreg = n_l;
  cells.ton = left;
  cells.done = left < 1;
  cells.stats = boundary != nullptr;
  stream3_body<T, K, TM, TM>(cells, in + lane * slab, out + lane * slab, m,
                             m, m, lz, tile, tile, bx, blockIdx.y,
                             blockIdx.z);
  if (boundary != nullptr)
    publish<LaneShape<K>::NT / 32>(boundary, L, lane, cells.fin, cells.resid,
                                   cells.tmin, cells.tmax, cells.heat);
}

// The launch geometry at depth K (cuda_lanes.lanes3d_geometry mirrors it):
// the largest tile, the tile's side, the segment's rows, the block's
// threads and the grid (column tiles x lanes, mid tiles, segments).
struct LaneGeo {
  int tile_max, tile, lz, threads;
  int64_t gx, gy, gz;
};

// Tiles of at most TM on each in-plane axis, cut to ceil(m / tiles); a
// block holds its SM's place for all its lz + 2K rows, so a grid of W waves
// of `slots` blocks takes about W * (lz + 2K) row-times: the lz of
// min(8, m)..min(1024, m) that makes that least (the longest of equals).
template <int K>
int lanes3d_geo(int L, int m, int64_t slots, LaneGeo* g) {
  constexpr int TM = LaneShape<K>::TM;
  const int tiles = (m + TM - 1) / TM;
  g->tile_max = TM;
  g->tile = (m + tiles - 1) / tiles;
  g->threads = LaneShape<K>::NT;
  const int64_t blocks = (int64_t)tiles * tiles * L;   // per segment row
  const int lo = m < LANE_LZMIN ? m : LANE_LZMIN;
  const int hi = m < LANE_LZMAX ? m : LANE_LZMAX;
  int64_t best = -1;
  int lz = 0;
  for (int l = lo; l <= hi; ++l) {
    const int64_t segs = (m + l - 1) / l;
    if (segs > 65535) continue;
    const int64_t cost = (blocks * segs + slots - 1) / slots * (l + 2 * K);
    if (best < 0 || cost <= best) best = cost, lz = l;
  }
  if (lz < 1) return (int)cudaErrorInvalidValue;   // over 65535 segments
  g->lz = lz;
  g->gx = (int64_t)tiles * L;
  g->gy = tiles;
  g->gz = (m + lz - 1) / lz;
  if (g->gx > 2147483647 || g->gy > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int K>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(lanes3d_stream_kernel<T, K>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)LaneShape<K>::S::SMEM);
}

// blocks of the depth-K instance resident on the card at once, asked once
template <typename T, int K>
int lane_slots(int64_t* slots) {
  static int64_t cached = 0;
  if (cached < 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaError_t e = allow_smem<T, K>()) return (int)e;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lanes3d_stream_kernel<T, K>, LaneShape<K>::NT,
            LaneShape<K>::S::SMEM))
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    cached = (int64_t)sms * per_sm;
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
int launch_lanes_at(const LaneArgs& a) {
  int64_t slots = 0;
  if (int e = lane_slots<T, K>(&slots)) return e;
  LaneGeo g;
  if (int e = lanes3d_geo<K>(a.L, a.m, slots, &g)) return e;
  // above 48 KB of dynamic shared memory only after opting in (per device,
  // so on every launch)
  if (cudaError_t e = allow_smem<T, K>()) return (int)e;
  if (cudaError_t e = init_boundary(a.rem, a.rem_out, a.boundary, a.L,
                                    a.ktotal, a.stream))
    return (int)e;
  lanes3d_stream_kernel<T, K>
      <<<dim3((unsigned)g.gx, (unsigned)g.gy, (unsigned)g.gz), g.threads,
         LaneShape<K>::S::SMEM, a.stream>>>(
          static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.r, a.n,
          a.rem, a.offset, a.bc_lo, g.tile, (int)g.gy, g.lz, a.boundary, a.L);
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
int launch_lanes(const LaneArgs& a) {
  return at_depth(a.k, [&](auto K) {
    return launch_lanes_at<T, decltype(K)::value>(a);
  });
}

// ---------------------------------------------------------------------------
// The earlier design (heat_lanes3d_step): one step per launch. A block is a
// 32-column x 8-mid tile of one lane (blockIdx.y); each thread walks its
// (mid, col) column through every row, keeping row-1, row and row+1 in
// registers and reading the four in-plane neighbours from global memory.
// Same arithmetic, same boundary vector.
namespace one_step {

constexpr int BX = 32;                   // columns per block
constexpr int BY = 8;                    // mids per block
constexpr int NWARP = BX * BY / 32;

template <typename T>
__global__ void __launch_bounds__(BX * BY)
lanes3d_kernel(const T* __restrict__ in, T* __restrict__ out, int m,
               const float* __restrict__ r, const int* __restrict__ n,
               const int* __restrict__ rem, int step, int bc_lo,
               int* boundary, int L, int ncol) {
  const int lane = blockIdx.y;
  const int col = (blockIdx.x % ncol) * BX + threadIdx.x;
  const int mid = (blockIdx.x / ncol) * BY + threadIdx.y;
  const size_t plane = (size_t)m * m;
  const T* src = in + (size_t)lane * plane * m;
  T* dst = out + (size_t)lane * plane * m;
  const int n_l = n[lane];
  const int hi = n_l + 1 - bc_lo;
  const float r_l = r[lane];
  // keep = step < rem_l and every coordinate in (bc_lo, hi); the row test
  // is the only one that changes along the walk
  const bool mc_live = step < rem[lane] && mid > bc_lo && mid < hi &&
                       col > bc_lo && col < hi;
  const bool mc_region = mid >= 1 && mid <= n_l && col >= 1 && col <= n_l;

  int fin = 1;
  float resid = 0.0f, tmin = INFINITY, tmax = -INFINITY, heat = 0.0f;
  if (col < m && mid < m) {
    const size_t base = (size_t)mid * m + col;
    float below = 0.0f;                       // row-1 (never read at row 0)
    float c = load_f(src + base);             // row
    for (int row = 0; row < m; ++row) {
      const size_t idx = (size_t)row * plane + base;
      const float above = row + 1 < m ? load_f(src + idx + plane) : 0.0f;
      float v = c;
      if (mc_live && row > bc_lo && row < hi) {
        float s = above;                      // row+1
        s = s + load_f(src + idx + m);        // mid+1
        s = s + load_f(src + idx + 1);        // col+1
        s = s + below;                        // row-1
        s = s + load_f(src + idx - m);        // mid-1
        s = s + load_f(src + idx - 1);        // col-1
        const float lap = __fmaf_rn(-6.0f, c, s);
        v = to_storage<T>(__fmaf_rn(r_l, lap, c));
        store_f(dst + idx, v);
      } else {
        dst[idx] = src[idx];                  // kept: the stored bytes
      }
      if (boundary != nullptr) {
        fin &= isfinite(v) ? 1 : 0;
        if (mc_region && row >= 1 && row <= n_l) {
          resid = fmaxf(resid, fabsf(v - c));
          tmin = fminf(tmin, v);
          tmax = fmaxf(tmax, v);
          heat += v;
        }
      }
      below = c;
      c = above;
    }
  }
  if (boundary == nullptr) return;            // grid-uniform
  publish<NWARP>(boundary, L, lane, fin, resid, tmin, tmax, heat);
}

template <typename T>
int launch(const LaneArgs& a) {
  if (a.k != 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = init_boundary(a.rem, a.rem_out, a.boundary, a.L,
                                      a.ktotal, a.stream);
  if (e != cudaSuccess) return (int)e;
  const int ncol = (a.m + BX - 1) / BX;
  const int nmid = (a.m + BY - 1) / BY;
  dim3 grid((unsigned)(ncol * nmid), (unsigned)a.L);
  dim3 block(BX, BY);
  lanes3d_kernel<T><<<grid, block, 0, a.stream>>>(
      static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.r, a.n,
      a.rem, a.offset, a.bc_lo, a.boundary, a.L, ncol);
  return (int)cudaGetLastError();
}

}  // namespace one_step

// The arguments, or cudaErrorInvalidValue for those no launch takes.
int lane_args(int k, const void* in, void* out, int L, int m, const void* r,
              const void* n, const void* rem, int offset, int bc_lo,
              void* rem_out, void* boundary, int ktotal, void* stream,
              LaneArgs* a) {
  if (k < 1 || k > LANE_KMAX || m < 3 || m > 46341 || L < 1 || L > 65535 ||
      in == out || (bc_lo != 0 && bc_lo != 1) ||
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

// dtype: 0 = float32, 1 = bfloat16. One pass of k <= 8 steps starting at
// the chunk's step `offset`; rem_out/boundary non-null only on the chunk's
// last pass (ktotal = the chunk's steps). Returns a cudaError_t (0 =
// launched); cudaErrorInvalidValue for arguments the kernel does not take.
int heat_lanes3d(int dtype, const void* in, void* out, int L, int m,
                 const void* r, const void* n, const void* rem, int k,
                 int offset, int bc_lo, void* rem_out, void* boundary,
                 int ktotal, void* stream) {
  LaneArgs a;
  if (int e = lane_args(k, in, out, L, m, r, n, rem, offset, bc_lo, rem_out,
                        boundary, ktotal, stream, &a))
    return e;
  if (dtype == 0) return launch_lanes<float>(a);
  if (dtype == 1) return launch_lanes<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// The earlier one-step design, with heat_lanes3d's arguments and function
// (k must be 1).
int heat_lanes3d_step(int dtype, const void* in, void* out, int L, int m,
                      const void* r, const void* n, const void* rem, int k,
                      int offset, int bc_lo, void* rem_out, void* boundary,
                      int ktotal, void* stream) {
  LaneArgs a;
  if (int e = lane_args(k, in, out, L, m, r, n, rem, offset, bc_lo, rem_out,
                        boundary, ktotal, stream, &a))
    return e;
  if (dtype == 0) return one_step::launch<float>(a);
  if (dtype == 1) return one_step::launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// heat_lanes3d's launch geometry for L lanes of m^3 at depth k (dtype as
// heat_lanes3d's) into geo[8]: the largest tile, the tile's side, segment
// rows, threads a block, grid x, y, z and the resident blocks it was sized
// for (`slots`, or where slots < 1 the card's for that instance).
int heat_lanes3d_geometry(int dtype, int L, int m, int k, int64_t slots,
                          int64_t* geo) {
  if (k < 1 || k > LANE_KMAX || m < 3 || m > 46341 || L < 1 || L > 65535 ||
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
    if (int e = lanes3d_geo<D>(L, m, s, &g)) return e;
    const int64_t v[8] = {g.tile_max, g.tile, g.lz, g.threads,
                          g.gx,       g.gy,   g.gz, s};
    for (int i = 0; i < 8; ++i) geo[i] = v[i];
    return 0;
  });
}

const char* heat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
