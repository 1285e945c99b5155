// The 2D FTCS multistep kernel for Hopper (sm_90a), streamed along the row
// axis with the k steps pipelined in registers: the shipped kernel
// (ftcs2d.cu) and the first tile of the kernel lab (lab2d.cu). It computes
// the function of stencil2d.cuh's band kernel, byte for byte, in another
// order. The body (stream2_body) takes its cells' arithmetic from a
// policy: SoloCells below for those kernels, lanes2d.cu's LaneCells for
// the serving engine's lane kernel (per-lane r, side and countdown,
// select-kept updates rounded every step, fused partials), one body for
// both.
//
// Design. A region is RW = 32 * G * NW cells wide: NW warps of 32 threads,
// each thread owning G neighbouring cells of a region row. Its output strip
// is the BC = RW - 2k columns in the middle. A block of BW warps holds
// BW / NW regions side by side (adjacent output strips) and owns a segment
// of LZ rows of each. It streams the rows of its regions once, from k rows
// before the segment to k rows after it, so the rows cost (LZ+2k)/LZ and
// the columns RW/BC. The k steps run as a wavefront: when region row p has
// arrived, step 1 computes row p-1, step 2 row p-2, ..., step k row p-k,
// which is an output row.
//
// A thread keeps, for each step t < k, step t's values of its cells in
// three rows: q-1 and q, where step t+1 computes row q next, and q+1, which
// step t computes in this same iteration just before step t+1 needs it. So
// the row-1, centre and row+1 values are registers: three arrays that
// rotate roles every iteration (the loop runs three iterations a trip), so
// no value is ever copied. The col-1 and col+1 neighbours are the thread's
// own centre values, or a neighbouring lane's (a warp shuffle). With NW = 1
// a warp spans its region: no shared memory, no barrier, the warps of a
// block independent. With NW > 1 the first and last lane of a warp read the
// neighbouring warp's edge values from shared memory, which each step
// writes for the next iteration (three buffers, one per phase of the
// rotation), so one barrier per streamed row suffices. Step t is valid on
// the cells at least t from the region's edge (its dependence cone); every
// cell is computed, and those outside the cone get values that only such
// cells read (a lane at the region's edge shuffles its own value in).
//
// Row p+3 is loaded three iterations ahead, and kept in the storage type's
// bits until a step takes it (a bf16 row widened at the load would hold
// the warp there for the load's latency). A step starts once its first
// valid row can be computed (iteration 2t). Two bodies: one tests, per
// step, the warm-up and whether the row is frozen; the other, for the
// iterations past the warm-up whose k rows are all free, tests nothing and
// takes maskr = r of the column (k <= 16 only, for the build's time; it
// makes a 16-step pass 1.17-1.22x faster, PERF.md).
//
// Cells outside the array load as 0.0f and are then stepped like any other
// cell, as in the band kernel, so the bytes kept are the same function.
// Every cell, frozen or not, takes the multiply-mask update, so a NaN that
// reaches a frozen cell spreads into it as in the Pallas body.
//
// Arithmetic per cell and step (maskr = frozen ? 0 : r, r rounded to f32;
// frozen where the GLOBAL row/col index <= lo or >= hi of bounds), each
// line rounded once, under -fmad=false:
//   ORDER_K1:  s = ((up + dn) + lf) + rt     row-1, row+1, col-1, col+1
//   ORDER_L4:  s = ((dn + up) + rt) + lf     row+1, row-1, col+1, col-1
//   UPD_LAP:   c' = fma(maskr, s - 4c, c)    (4c exact)
//   UPD_DECAY: c' = fma(decay, c, maskr*s), decay = 1 - 4*maskr (exact)
//   EVERY:     c' rounded to the storage type after each step (bf16 RNE;
//              the identity for f32), else once at the store
//
// Configurations (Stream2; k is a template parameter: the pipeline's
// state, 2k values per cell, must stay in registers, and a runtime k or a
// break in the step loop sends it to local memory; a launch picks one of
// 32 instances at run time). Blocks of four warps:
//   k = 1..16:  G = 4, NW = 1: a 128-wide region per warp, 96 output
//               columns at k = 16 (1.33x the columns kept); the state is
//               8k registers a thread (128 at k = 16, of 232-254 used: two
//               blocks, 8 warps per SM), no shared memory;
//   k = 17..32: G = 2, NW = 4: a 256-wide region over four warps, 192
//               output columns at k = 32; 4k registers of state, and
//               96 * k bytes of edge values in static shared memory.
// Segments of 16 to 256 rows, chosen per field so that the grid fills whole
// waves of the card (stream2_lz: 171 at 4096^2 and k = 16, 1.19x the rows
// kept, one wave; 249 at 32768^2, 1.13x).
//
// Bound on the card: a pass reads and writes the field once and does 7
// (lap) or 6 (decay) f32 operations per cell-step, so at 16 steps it sits
// near the balance of HBM and the f32 rate. The design spends instead
// about 9 issued instructions per cell-step evaluated in the body without
// tests (the 7 operations, a share of the shuffles and of the loads and
// stores), 11 in the one with tests, times the redundant columns and rows
// above, at about two warps per scheduler; PERF.md has its times.

#pragma once

#include <type_traits>

#include "stencil2d.cuh"

namespace {

// the shipped configuration (ftcs2d.cu, and the first tile of the lab,
// cuda_lab.STREAM_2D = (STREAM2_LZMAX, STREAM2_RW)): segments of up to 256
// rows (stream2_lz) of a region 128 cells wide at k <= 16 (256 wide, four
// warps, at k > 16); rows loaded STREAM2_AHEAD iterations ahead (a divisor
// of the state's three-way rotation; 3 measured faster than 1, PERF.md)
constexpr int STREAM2_LZMAX = 256;
constexpr int STREAM2_RW = 128;
constexpr int STREAM2_AHEAD = 3;

// The shape at depth K: cells a thread G, warps a region NW, warps a block
// BW, blocks per SM for __launch_bounds__ MINB (the registers a thread may
// have: the state, 2K*G, and about 96 more at 4 cells a thread, 64 at 2).
template <int K>
struct Stream2 {
  static constexpr int G = K <= 16 ? 4 : 2;
  static constexpr int NW = K <= 16 ? 1 : 4;
  static constexpr int BW = 4;
  static constexpr int MINB_R =
      65536 / (32 * BW * (2 * K * G + (G == 4 ? 96 : 64)));
  static constexpr int MINB = MINB_R < 1 ? 1 : MINB_R > 8 ? 8 : MINB_R;
  static constexpr int RW = 32 * G * NW;          // region cols
  static constexpr int BC = RW - 2 * K;           // output cols per region
  static constexpr int THREADS = 32 * BW;         // BW warps a block
  static constexpr int S = BW / NW;               // regions per block
  // the edge values a warp hands its neighbours: [phase][step][side][warp]
  static constexpr int EDGES = NW > 1 ? 3 * K * 2 * BW : 1;
  // a second body without the warm-up and frozen-row tests, for the
  // iterations that need neither (only at k <= 16: the build's time)
  static constexpr bool FAST = K <= 16;
  static_assert(BC > 0, "region narrower than its halo");
  static_assert(S >= 1 && S * NW == BW, "regions fill the block");
  static_assert(K > 16 || RW == STREAM2_RW,
                "cuda_lab.STREAM_2D names the region width");
};

// A row's G cells as loaded, in the storage type's bits: f32 values, or
// bf16 pairs packed in 32 bits. The rows loaded ahead are kept so and
// widened to f32 only where a step takes them: widened at the load, the
// first use would hold the warp there for the load's whole latency.
template <typename T, int G> struct Raw;
template <int G> struct Raw<float, G> {
  float v[G];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < G; ++c) v[c] = 0.0f;
  }
  // G = 4 cells at a 16-byte aligned p
  __device__ __forceinline__ void vec(const float* p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  // G = 4 cells at an 8-byte aligned p, in two halves
  __device__ __forceinline__ void pair(const float* p) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  // cell c where bit c of in is set, else 0
  __device__ __forceinline__ void cells(const float* p, unsigned in) {
#pragma unroll
    for (int c = 0; c < G; ++c) v[c] = in >> c & 1u ? __ldg(p + c) : 0.0f;
  }
  // G = 4 cells at p, in the widest loads p's alignment allows
  __device__ __forceinline__ void aligned(const float* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (a % 16 == 0) vec(p);
    else if (a % 8 == 0) pair(p);
    else cells(p, 0xfu);
  }
  __device__ __forceinline__ void widen(float (&f)[G]) const {
#pragma unroll
    for (int c = 0; c < G; ++c) f[c] = v[c];
  }
};
template <int G> struct Raw<__nv_bfloat16, G> {
  unsigned v[G / 2];             // cells 2j (low half) and 2j+1 (high half)
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < G / 2; ++j) v[j] = 0u;
  }
  // G = 4 cells at an 8-byte aligned p
  __device__ __forceinline__ void vec(const __nv_bfloat16* p) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = q.x; v[1] = q.y;
  }
  __device__ __forceinline__ void cells(const __nv_bfloat16* p, unsigned in) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      const unsigned lo = in >> (2 * j) & 1u ? __ldg(h + 2 * j) : 0u;
      const unsigned hi = in >> (2 * j + 1) & 1u ? __ldg(h + 2 * j + 1) : 0u;
      v[j] = lo | hi << 16;
    }
  }
  // G = 4 cells at a 4-byte aligned p, in two halves
  __device__ __forceinline__ void pair(const __nv_bfloat16* p) {
    v[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    v[1] = __ldg(reinterpret_cast<const unsigned*>(p + 2));
  }
  // G = 4 cells at p, in the widest loads p's alignment allows
  __device__ __forceinline__ void aligned(const __nv_bfloat16* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (a % 8 == 0) vec(p);
    else if (a % 4 == 0) pair(p);
    else cells(p, 0xfu);
  }
  // a bf16 widens exactly: its bits are the f32's upper half
  __device__ __forceinline__ void widen(float (&f)[G]) const {
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      f[2 * j] = __uint_as_float(v[j] << 16);
      f[2 * j + 1] = __uint_as_float(v[j] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  unsigned h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = __bfloat16_as_ushort(__float2bfloat16_rn(v[c]));
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

// The cells of a row whose values the storage type holds exactly (the lane
// kernel rounds to it every step), written with their bits as they are: a
// bf16 value is the upper half of its f32, so a kept cell, NaN payload and
// all, keeps its bytes. 4 cells at p where bit c of keep is set, in the
// widest stores p's alignment allows.
__device__ __forceinline__ void store_exact(float* p, const float (&v)[4],
                                            unsigned keep) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (keep == 0xfu && a % 16 == 0) {
    store4(p, v);
  } else if (keep == 0xfu && a % 8 == 0) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (keep >> c & 1u) p[c] = v[c];
  }
}
__device__ __forceinline__ void store_exact(__nv_bfloat16* p,
                                            const float (&v)[4],
                                            unsigned keep) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) h[c] = __float_as_uint(v[c]) >> 16;
  if (keep == 0xfu && a % 8 == 0) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
  } else if (keep == 0xfu && a % 4 == 0) {
    reinterpret_cast<unsigned*>(p)[0] = h[0] | h[1] << 16;
    reinterpret_cast<unsigned*>(p)[1] = h[2] | h[3] << 16;
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (keep >> c & 1u) q[c] = (unsigned short)h[c];
  }
}

// The cells' side of the body (the rest is the same for every kernel that
// streams a 2D field). A policy supplies:
//   LANE              false for the solo kernels, true for the lane kernel
//                     (lanes2d.cu): there vector loads and stores are
//                     chosen per row by address (a lane's rows start at
//                     any offset) and write the bits as they are, and a
//                     lane that has no step left in the pass is copied
//                     instead of stepped
//   fast, rlo, rhi    whether the body without tests may run, and on
//                     which rows: rlo < row < rhi
//   columns(gx, keep) the thread's column setup (cells gx .. gx+G-1;
//                     bit c of keep: cell c is stored)
//   row<FAST>(t, gz)  step t's per-row state on global row gz
//   cell<FAST>(z, c, up, cc, dn, lf, rt)  step's new value of cell c
//   keep<FAST>(z, v, cc)  (LANE) the step's new values of the thread's
//                     cells, once all are computed (cc: the old ones)
//   output(gz, v, pre, keep)  step K's row gz (pre: its values before
//                     step K), or a copied row (pre = v), before its store
//   finish(row, zs, nout, keep)  (LANE) once the pipeline is done, with
//                     row(gz) the thread's cells of stored row gz
// The solo kernels' cells: the multiply-mask on the field's bounds, in
// ORDER / UPD / EVERY's form (above).
template <typename T, int ORDER, int UPD, bool EVERY, int G>
struct SoloCells {
  static constexpr bool LANE = false;
  static constexpr bool fast = true;
  const float r;
  const int rlo, rhi, clo, chi;
  float rc[G];     // r, or 0 where the col index freezes
  float dec[G];    // UPD_DECAY's 1 - 4*maskr on free rows

  __device__ SoloCells(float r_, int rlo_, int rhi_, int clo_, int chi_)
      : r(r_), rlo(rlo_), rhi(rhi_), clo(clo_), chi(chi_) {}

  __device__ __forceinline__ void columns(int64_t gx, unsigned) {
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int64_t g = gx + c;
      rc[c] = (g <= clo || g >= chi) ? 0.0f : r;
      dec[c] = 1.0f - 4.0f * rc[c];
    }
  }
  // whether step t's row gz is frozen
  template <bool FAST>
  __device__ __forceinline__ bool row(int, int gz) const {
    return !FAST && (gz <= rlo || gz >= rhi);
  }
  template <bool FAST>
  __device__ __forceinline__ float cell(bool z_frozen, int c, float up,
                                        float cc, float dn, float lf,
                                        float rt) const {
    const float sum = ORDER == ORDER_K1 ? ((up + dn) + lf) + rt
                                        : ((dn + up) + rt) + lf;
    const float maskr = z_frozen ? 0.0f : rc[c];
    float v;
    if (UPD == UPD_LAP) {
      v = __fmaf_rn(maskr, sum - 4.0f * cc, cc);
    } else {
      const float decay = z_frozen ? 1.0f : dec[c];
      v = __fmaf_rn(decay, cc, maskr * sum);
    }
    if (EVERY) v = round_to<T>(v);
    return v;
  }
  __device__ __forceinline__ void output(int, float (&)[G], const float (&)[G],
                                         unsigned) {}
};

// The streamed body at depth K over an m x n field, segments of lz rows,
// with the cells' arithmetic from `cells` (see above). Every thread of the
// block calls it; a warp whose region lies past the field returns at once.
template <typename T, int K, class Cells>
__device__ __forceinline__ void stream2_body(Cells& cells,
                                             const T* __restrict__ in,
                                             T* __restrict__ out, int64_t m,
                                             int64_t n, int lz) {
  using S = Stream2<K>;
  constexpr int G = S::G, NW = S::NW, BW = S::BW, AHEAD = STREAM2_AHEAD;
  static_assert(3 % AHEAD == 0, "the ring of rows ahead follows the phase");
  static_assert(!Cells::LANE || NW == 1, "lanes stream one warp a region");
  __shared__ float edge[S::EDGES];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp % NW;                       // warp within its region
  // first output column of this warp's region
  const int64_t c0 = ((int64_t)blockIdx.x * S::S + warp / NW) * S::BC;
  if (NW == 1 && c0 >= n) return;                 // no barrier to keep
  const int zs = (int)blockIdx.y * lz;            // first output row
  const int nout = (int)(m - zs < lz ? m - zs : lz);
  const int np = nout + 2 * K;                    // rows streamed

  // the thread's cells: region cols x .. x+G-1, global gx .. gx+G-1
  const int x = G * (32 * wr + lane);
  const int64_t gx = c0 - K + x;
  unsigned in_x = 0, keep = 0;   // bit c: inside the array / kept
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const int64_t g = gx + c;
    if (g >= 0 && g < n) {
      in_x |= 1u << c;
      if (x + c >= K && x + c < K + S::BC) keep |= 1u << c;
    }
  }
  cells.columns(gx, keep);
  // a whole group of 4 inside the array on an aligned address moves as
  // one vector: for the solo kernels decided once per field, for lanes per
  // row by the row's address (16 bytes: one vector; 8 bytes in f32 or 4 in
  // bf16: two)
  constexpr unsigned ALL = (1u << G) - 1;
  const bool vec = !Cells::LANE && G == 4 && n % 4 == 0 && gx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_in = vec && in_x == ALL;
  const bool vec_out = vec && keep == ALL;

  // edge exchange between the warps of a region (NW > 1): a step's new row
  // in the iteration's phase; lane 0 reads the left warp's right edge,
  // lane 31 the right warp's left edge
  auto eidx = [](int ph, int s, int side, int w) {
    return ((ph * K + s) * 2 + side) * BW + w;
  };
  const bool take_l = NW > 1 && lane == 0 && wr > 0;
  const bool take_r = NW > 1 && lane == 31 && wr < NW - 1;
  const int wl = take_l ? warp - 1 : warp;
  const int wrr = take_r ? warp + 1 : warp;
  auto put_edges = [&](int ph, int s, const float (&v)[G]) {
    if (NW > 1) {
      if (lane == 0) edge[eidx(ph, s, 0, warp)] = v[0];
      if (lane == 31) edge[eidx(ph, s, 1, warp)] = v[G - 1];
    }
  };

  auto load = [&](int p, Raw<T, G>& dst) {
    const int gz = zs - K + p;
    const T* row = in + (int64_t)gz * n + gx;
    if (gz < 0 || gz >= m) {
      dst.zero();
    } else if constexpr (G == 4) {
      if (vec_in) {
        dst.vec(row);
      } else if (Cells::LANE && in_x == ALL) {
        dst.aligned(row);
      } else {
        dst.cells(row, in_x);
      }
    } else {
      dst.cells(row, in_x);
    }
  };
  auto store = [&](int gz, const float (&v)[G]) {
    T* row = out + (int64_t)gz * n + gx;
    if constexpr (Cells::LANE) {
      store_exact(row, v, keep);
      return;
    }
    if constexpr (G == 4) {
      if (vec_out) {
        store4(row, v);
        return;
      }
    }
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (keep >> c & 1u) store_f(row + c, v[c]);
  };

  if constexpr (Cells::LANE) {
    // a lane with no step left: its output rows copied, COPY rows loaded
    // at a time
    if (cells.done) {
      constexpr int COPY = 8;
      for (int q0 = 0; q0 < nout; q0 += COPY) {
        Raw<T, G> raw[COPY];
#pragma unroll
        for (int u = 0; u < COPY; ++u)
          if (q0 + u < nout) load(K + q0 + u, raw[u]);
#pragma unroll
        for (int u = 0; u < COPY; ++u) {
          if (q0 + u < nout) {
            float v[G];
            raw[u].widen(v);
            cells.output(zs + q0 + u, v, v, keep);
            store(zs + q0 + u, v);
          }
        }
      }
      return;
    }
  }

  // The pipeline's state: three arrays that rotate roles every iteration
  // (so nothing is copied): for each step t < K and cell, step t's values
  // of rows q-1 (OLD) and q (CUR), where step t+1 computes row q next, and
  // row q+1 (NEW), which step t computes in this iteration.
  float s0[K][G], s1[K][G], s2[K][G];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int c = 0; c < G; ++c) s0[t][c] = s1[t][c] = s2[t][c] = 0.0f;

  // One streamed row p, in rotation phase PH: step 0 takes region row p
  // (loaded AHEAD iterations ago into nx, which then receives row
  // p+AHEAD), step t computes row p-t once that is a row of its dependence
  // cone (p >= 2t; before that its inputs are not yet there). Rows past
  // the last are streamed only to keep the rotation whole; none is stored.
  // FAST: an iteration past the warm-up (p >= 2K), before the end (p <
  // np), whose K rows lie in (rlo, rhi), needs none of these tests.
  auto iteration = [&](auto ph, auto fast, int p, float (&old)[K][G],
                       float (&cur)[K][G], float (&nw)[K][G], Raw<T, G>& nx) {
    constexpr int PH = decltype(ph)::value;
    constexpr bool FAST = decltype(fast)::value;
    nx.widen(nw[0]);
    if (p + AHEAD < np) load(p + AHEAD, nx);
    put_edges(PH, 0, nw[0]);
    const int gp = zs - K + p;      // global row of region row p
#pragma unroll
    for (int t = 1; t <= K; ++t) {
      if (!FAST && p < 2 * t) continue;  // (no break: it stops the unroll)
      const int gz = gp - t;        // global row this step computes
      const auto z = cells.template row<FAST>(t, gz);
      // the centres are cur[t - 1], row q = p - t
      float cl = __shfl_up_sync(0xffffffffu, cur[t - 1][G - 1], 1);
      float cr = __shfl_down_sync(0xffffffffu, cur[t - 1][0], 1);
      if (NW > 1) {
        const float el = edge[eidx((PH + 2) % 3, t - 1, 1, wl)];
        const float er = edge[eidx((PH + 2) % 3, t - 1, 0, wrr)];
        cl = take_l ? el : cl;
        cr = take_r ? er : cr;
      }
      float v[G];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float up = old[t - 1][c];    // row-1
        const float cc = cur[t - 1][c];    // centre
        const float dn = nw[t - 1][c];     // row+1
        const float lf = c == 0 ? cl : cur[t - 1][c == 0 ? 0 : c - 1];
        const float rt = c == G - 1 ? cr : cur[t - 1][c == G - 1 ? 0 : c + 1];
        v[c] = cells.template cell<FAST>(z, c, up, cc, dn, lf, rt);
      }
      if constexpr (Cells::LANE) cells.template keep<FAST>(z, v, cur[t - 1]);
      if (t < K) {
#pragma unroll
        for (int c = 0; c < G; ++c) nw[t][c] = v[c];
        put_edges(PH, t, v);
      } else if (FAST || p < np) {
        // step K's row p-K is output row p-2K of the segment
        cells.output(gz, v, cur[K - 1], keep);
        store(gz, v);
      }
    }
    if (NW > 1) __syncthreads();  // this iteration's edges written and read
  };

  // the rows loaded ahead: row p+AHEAD of phase PH in nx[PH % AHEAD]
  Raw<T, G> nx[AHEAD];
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) load(a, nx[a]);  // np >= 2K + 1 >= 3
  using Fast = std::integral_constant<bool, true>;
  using Test = std::integral_constant<bool, false>;
  // whether iteration p may take the body without tests: p >= 2K, p < np,
  // and region rows p-K .. p-1 (global gp-K .. gp-1) all in (rlo, rhi)
  auto fast_at = [&](int p) {
    const int gp = zs - K + p;
    return S::FAST && cells.fast && p >= 2 * K && p < np &&
           gp - K > cells.rlo && gp - 1 < cells.rhi;
  };
  auto phase = [&](auto ph, int p, float (&old)[K][G], float (&cur)[K][G],
                   float (&nw)[K][G]) {
    Raw<T, G>& x = nx[decltype(ph)::value % AHEAD];
    if constexpr (S::FAST) {
      if (fast_at(p)) {
        iteration(ph, Fast{}, p, old, cur, nw, x);
        return;
      }
    }
    iteration(ph, Test{}, p, old, cur, nw, x);
  };
  for (int p = 0; p < np; p += 3) {
    phase(std::integral_constant<int, 0>{}, p, s0, s1, s2);
    phase(std::integral_constant<int, 1>{}, p + 1, s1, s2, s0);
    phase(std::integral_constant<int, 2>{}, p + 2, s2, s0, s1);
  }
  if constexpr (Cells::LANE)
    cells.finish([&](int gz) { return out + (int64_t)gz * n + gx; }, zs, nout,
                 keep);
}

// The solo kernel: k masked steps of one field (ftcs2d.cu, lab2d.cu).
template <typename T, int ORDER, int UPD, bool EVERY, int K>
__global__ void __launch_bounds__(Stream2<K>::THREADS, Stream2<K>::MINB)
ftcs2d_stream_kernel(const T* __restrict__ in, T* __restrict__ out,
                     int64_t m, int64_t n, float r, int lz, int rlo, int rhi,
                     int clo, int chi) {
  SoloCells<T, ORDER, UPD, EVERY, Stream2<K>::G> cells(r, rlo, rhi, clo, chi);
  stream2_body<T, K>(cells, in, out, m, n, lz);
}

// Rows per block segment for `fields` m x n fields (the lane kernel's
// lanes; 1 for the solo kernels), cols output columns a block, slots blocks
// resident on the card at once: a block holds its SM's place for all its
// LZ + 2K rows, so a grid of W waves takes about W * (LZ + 2K) row-times;
// the LZ of lzmin..256 that makes that least (the longest of equals) fills
// the last wave instead of leaving SMs idle. On an H100 at 4096^2 and
// k = 16 that is 171 (264 blocks, one wave), at 32768^2 249. The lane
// kernel goes down to 8 rows: its small buckets (8 x 258^2) have too few
// rows to fill the card with 16 (cuda_lanes.lanes2d_geometry mirrors it).
template <int K>
int stream2_lz(int64_t m, int64_t n, int64_t cols, int64_t slots,
               int64_t fields = 1, int lzmin = 16) {
  const int64_t cb = (n + cols - 1) / cols * fields;
  int64_t best = -1;
  int lz = 0;
  for (int l = lzmin; l <= STREAM2_LZMAX; ++l) {
    const int64_t segs = (m + l - 1) / l;
    if (segs > 65535) continue;
    const int64_t cost = (cb * segs + slots - 1) / slots * (l + 2 * K);
    if (best < 0 || cost <= best) best = cost, lz = l;
  }
  return lz;
}

// blocks of a kernel resident on the card at once, into slots
template <class Kernel>
int stream2_slots(Kernel kernel, int threads, int64_t* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, 0))
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *slots = (int64_t)sms * per_sm;
  return 0;
}

// The streamed kernel at depth K, its segment length chosen for the field
// (stream2_lz) from the card's resident blocks, asked at the instance's
// first launch.
template <typename T, int ORDER, int UPD, bool EVERY, int K>
int launch_stream2_at(const Args& a) {
  using S = Stream2<K>;
  auto kernel = ftcs2d_stream_kernel<T, ORDER, UPD, EVERY, K>;
  const int64_t cols = (int64_t)S::S * S::BC;   // output cols per block
  static int64_t slots = 0;
  if (slots < 1) {
    if (int e = stream2_slots(kernel, S::THREADS, &slots)) return e;
  }
  const int lz = stream2_lz<K>(a.m, a.n, cols, slots);
  if (lz < 1) return (int)cudaErrorInvalidValue;  // over 65535 segments
  const int64_t gx = (a.n + cols - 1) / cols;
  const int64_t gy = (a.m + lz - 1) / lz;
  if (gy * lz > 2147483647 || gx > 2147483647)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), S::THREADS, 0, a.stream>>>(
          static_cast<const T*>(a.in), static_cast<T*>(a.out), a.m, a.n, a.r,
          lz, a.rlo, a.rhi, a.clo, a.chi);
  return (int)cudaGetLastError();
}

// ... at the run-time depth a.k (K .. KMAX)
template <typename T, int ORDER, int UPD, bool EVERY, int K = 1>
int launch_stream2(const Args& a) {
  if (a.k == K) return launch_stream2_at<T, ORDER, UPD, EVERY, K>(a);
  if constexpr (K < KMAX)
    return launch_stream2<T, ORDER, UPD, EVERY, K + 1>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
