// The 3D (7-point) FTCS multistep kernel for Hopper (sm_90a), streamed
// along the row axis with the k steps pipelined: the shipped kernel
// (ftcs3d.cu) and one tile of the kernel lab (lab3d.cu). It computes the
// function of stencil3d.cuh's band kernel, byte for byte, in another order.
// The body (stream3_body) takes its cells' arithmetic from a policy:
// SoloCells below for those kernels, lanes3d.cu's LaneCells for the serving
// engine's lane kernel (per-lane r, side and countdown, select-kept updates
// rounded every step, fused partials), one body for both.
//
// Design. A block owns a TY x TX (mid, col) output tile and a segment of lz
// rows. It streams the rows of its input region, R = (TY+2k) x (TX+2k)
// cells per plane, through the block once, from k rows before the segment
// to k rows after it: the redundant halo is in-plane only, and the rows
// cost (lz+2k)/lz. The solo launch sizes lz (8 to LZ rows, stream3_lz) so
// that the blocks fill whole waves of the card: a field with few tiles (a
// thin rim region of the sharded backend's overlap exchange) gets short
// segments and enough blocks. The k steps run as a wavefront: when input plane p has
// arrived, step 1 computes plane p-1, step 2 plane p-2, ..., step k plane
// p-k, which is the output.
//
// A thread owns a group of 4 neighbouring cells of one R row (a float4 in
// shared memory) for every step, so the row-1, centre and row+1 values a
// step needs are in its registers: for each step t-1 < k it keeps planes
// q-1 and q, and plane q+1 is the value step t-1 computed a moment before
// in this same iteration (two register arrays that swap roles each
// iteration, so nothing is copied). The col-1 and col+1 neighbours are the
// group's own centre values, or a neighbouring lane's (a warp shuffle; the
// first and last lane of a warp read theirs from shared memory). The mid-1
// and mid+1 rows come from shared memory, one float4 each: each step t < k
// writes its new plane into a buffer of its own, two per step alternating
// with the iteration, and step t+1 reads it in the next iteration. So one
// barrier per streamed plane suffices: at iteration p a step reads the
// buffers written at p-1 and writes the others, whose last readers ran at
// p-1. Step t is valid on the cells at least t from R's edge (its
// dependence cone); a warp whose rows all lie outside it skips the step,
// and the other warps compute it for all their cells (no branch per cell;
// the cells outside the cone are read only by cells outside the next
// step's cone, and each buffer has a guard so that no read leaves it). A
// step starts once its first valid plane can be computed (iteration 2t).
//
// Cells outside the array load as 0.0f and are then stepped like any other
// cell, as in the band kernel, so the bytes kept are the same function.
// Under SoloCells every cell, frozen or not, takes the multiply-mask update,
// so a NaN that reaches a frozen cell spreads into it as in the Pallas body.
//
// SoloCells' arithmetic per cell and step, each line rounded once (maskr =
// frozen ? 0 : r; frozen where the GLOBAL row/mid/col index <= lo or >= hi):
//   ORDER_L1:  s = ((((row+1 + row-1) + mid+1) + mid-1) + col-1) + col+1
//   ORDER_L2:  s = ((((row-1 + row+1) + mid-1) + mid+1) + col-1) + col+1
//   UPD_LAP:   c' = fma(maskr, fma(-6, c, s), c)
//   UPD_DECAY: c' = fma(decay, c, maskr*s), decay = fma(-6, maskr, 1)
// Built with -fmad=false; no fast-math.
//
// Resources at the shipped 32 x 32 tile, k = 8: R is 48 x 48 cells, 576
// threads of 4 cells; the buffers 8 steps x 2 x (2304 + 2 x 52 guard) x 4 =
// 154112 bytes of shared memory, and the pipeline's state 8k values per
// thread in registers: one block per SM. At k <= 4 (2 or 3 blocks per SM)
// the block is smaller. k is a template parameter (the state's size), so a
// launch picks one of eight instances at run time; a runtime k or a break in
// the step loop would send the state to local memory.

#pragma once

#include "stencil3d.cuh"

namespace {

// the shipped configuration (ftcs3d.cu, and the first tile of the lab,
// cuda_lab.BLOCKS_3D[0] = (LZ, TY, TX))
constexpr int STREAM_LZ = 256;
constexpr int STREAM_TY = 32;
constexpr int STREAM_TX = 32;

template <int K, int TY, int TX>
struct Stream {
  static constexpr int RY = TY + 2 * K;           // region rows (mids)
  static constexpr int RX = TX + 2 * K;           // region cols
  static constexpr int RXP = (RX + 3) / 4 * 4;    // a row in shared memory
  static constexpr int NG = RY * (RXP / 4);       // 4-cell groups
  static constexpr int NT = (NG + 31) / 32 * 32;  // threads, one group each
  static constexpr int MINB = K <= 2 ? 3 : K <= 4 ? 2 : 1;  // blocks per SM
  // a plane buffer: the threads' 4 * NT cells between two guards, so that
  // every cell's neighbours lie inside it (multiples of 4: float4 aligned)
  static constexpr int GUARD = RXP + 4;
  static constexpr int PB = 4 * NT + 2 * GUARD;
  static constexpr size_t SMEM = (size_t)K * 2 * PB * sizeof(float);
};

// The cells' side of the body (the rest is the same for every kernel that
// streams a 3D field). A policy supplies:
//   LANE               false for the solo kernels, true for the lane kernel
//                      (lanes3d.cu): there the stores write the bits as
//                      they are, and a lane with no step left in the pass
//                      is copied instead of stepped
//   done               (LANE) no step of the pass is on
//   columns(gy, gx, keep)  the thread's setup (mid gy, cols gx .. gx+3;
//                      bit c of keep: cell c is stored)
//   row(t, gz)         step t's state on global row gz
//   cell(z, c, up, cc, dn, mm, mp, left, right)  step's new value of cell
//                      c from its centre and its row-1, row+1, mid-1,
//                      mid+1, col-1 and col+1 neighbours
//   keep(z, v, cc)     (LANE) the step's new values of the thread's cells,
//                      once all are computed (cc: the old ones)
//   output(gz, v, pre, keep)  step K's row gz (pre: its values before step
//                      K), or a copied row (pre = v), before its store
// The solo kernels' cells: the multiply-mask on the field's bounds, in
// ORDER / UPD's form (above).
template <int ORDER, int UPD>
struct SoloCells {
  static constexpr bool LANE = false;
  const float r;
  const Bounds& b;  // the kernel's parameter, read where it is used
  float ryx[4];     // r, or 0 where the mid or col index freezes the cell

  __device__ SoloCells(float r_, const Bounds& b_) : r(r_), b(b_) {}

  __device__ __forceinline__ void columns(int64_t gy, int64_t gx, unsigned) {
    const bool y_frozen = gy <= b.lo[1] || gy >= b.hi[1];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ryx[c] = (y_frozen || gx + c <= b.lo[2] || gx + c >= b.hi[2]) ? 0.0f : r;
  }
  // whether row gz is frozen
  __device__ __forceinline__ bool row(int, int64_t gz) const {
    return gz <= b.lo[0] || gz >= b.hi[0];
  }
  __device__ __forceinline__ float cell(bool z_frozen, int c, float up,
                                        float cc, float dn, float mm,
                                        float mp, float left,
                                        float right) const {
    float sum;
    if (ORDER == ORDER_L1) {
      sum = dn + up;                   // row+1 + row-1
      sum = sum + mp;                  // + mid+1
      sum = sum + mm;                  // + mid-1
    } else {
      sum = up + dn;                   // row-1 + row+1
      sum = sum + mm;                  // + mid-1
      sum = sum + mp;                  // + mid+1
    }
    sum = sum + left;                  // + col-1
    sum = sum + right;                 // + col+1
    const float maskr = z_frozen ? 0.0f : ryx[c];
    if (UPD == UPD_LAP) {
      const float lap = __fmaf_rn(-6.0f, cc, sum);
      return __fmaf_rn(maskr, lap, cc);
    }
    const float decay = __fmaf_rn(-6.0f, maskr, 1.0f);
    return __fmaf_rn(decay, cc, maskr * sum);
  }
  __device__ __forceinline__ void output(int64_t, const float (&)[4],
                                         const float (&)[4], unsigned) {}
};

// A stored value as f32 and back with its bits as they are (a bf16 value is
// the upper half of its f32; every value a lane kernel stores is one the
// storage type holds), so a kept cell, NaN payload and all, keeps its bytes
// (a conversion instruction may rewrite a NaN's payload).
__device__ __forceinline__ float load_bits(const float* p) { return *p; }
__device__ __forceinline__ float load_bits(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}
__device__ __forceinline__ void store_bits(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_bits(__nv_bfloat16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      (unsigned short)(__float_as_uint(v) >> 16);
}

// The streamed body at depth K over an m x mid x n field, with the cells'
// arithmetic from `cells` (see above): block (bx, by, bz) owns the ty x tx
// (mid, col) output tile (ty <= TY, tx <= TX: the solo kernels take the
// whole tile, the lane kernel sizes it to the field) and the segment of lz
// rows. Threads whose region rows or columns lie past ty + 2K or tx + 2K
// load nothing, and a warp with no row in the smaller region skips every
// step. Every thread of the block calls it.
template <typename T, int K, int TY, int TX, class Cells>
__device__ __forceinline__ void stream3_body(Cells& cells,
                                             const T* __restrict__ in,
                                             T* __restrict__ out, int64_t m,
                                             int64_t mid, int64_t n, int lz,
                                             int ty, int tx, unsigned bx,
                                             unsigned by, unsigned bz) {
  using S = Stream<K, TY, TX>;
  constexpr int RXP = S::RXP;
  extern __shared__ float4 smem4[];  // [step 0..K-1][parity][PB floats]
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t zs = (int64_t)bz * lz;    // first output row
  // planes streamed: global rows zs-K .. zs+nout+K-1
  const int nout = (int)(m - zs < lz ? m - zs : lz);
  const int np = nout + 2 * K;
  const int64_t plane = mid * n;
  const int ry = ty + 2 * K;              // the region's rows and cols used
  const int rx = tx + 2 * K;

  // the group: R row y, cols x .. x+3; in shared memory at 4 * tid
  const int y = tid / (RXP / 4);
  const int x = 4 * (tid - y * (RXP / 4));
  const int64_t gy = (int64_t)by * ty - K + y;
  const int64_t gx = (int64_t)bx * tx - K + x;
  const int64_t goff = gy * n + gx;   // the group's offset in a row plane
  const bool y_in = tid < S::NG && (!Cells::LANE || y < ry) && gy >= 0 &&
                    gy < mid;
  // the warp's largest distance of a row from R's edge: a step t whose
  // cone (distance >= t) misses all the warp's rows is skipped by the warp
  const int wy = __reduce_max_sync(0xffffffffu, y < ry - 1 - y
                                                     ? y
                                                     : ry - 1 - y);
  const bool y_keep = y >= K && y < K + ty;
  bool in_yx[4];   // inside the array's (mid, col) extent
  bool keep[4];    // in the output tile and the array
  unsigned kept = 0;   // the same as bits: bit c is keep[c]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    in_yx[c] = y_in && x + c < rx && gx + c >= 0 && gx + c < n;
    keep[c] = in_yx[c] && y_keep && x + c >= K && x + c < K + tx;
    kept |= keep[c] ? 1u << c : 0u;
  }
  cells.columns(gy, gx, kept);

  if constexpr (Cells::LANE) {
    // a lane with no step left: its output cells copied (block-uniform)
    if (cells.done) {
#pragma unroll 4
      for (int q = 0; q < nout; ++q) {
        const int64_t gz = zs + q;
        const T* src = in + gz * plane + goff;
        T* dst = out + gz * plane + goff;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = keep[c] ? load_bits(src + c) : 0.0f;
        cells.output(gz, v, v, kept);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (keep[c]) store_bits(dst + c, v[c]);
      }
      return;
    }
  }

  // The pipeline's state: for each step t < K and cell, step t's values of
  // planes q-1 and q, where step t+1 computes plane q next. The two arrays
  // swap roles every iteration: the one holding q-1 receives q+1.
  float sa[K][4];
  float sb[K][4];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) sa[t][c] = sb[t][c] = 0.0f;

  float next[4];  // input plane p+1, loaded one iteration ahead
  auto load = [&](int p) {
    const int64_t gz = zs - K + p;
    const bool z_in = gz >= 0 && gz < m;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* src = in + gz * plane + goff + c;
      if constexpr (Cells::LANE)
        next[c] = z_in && in_yx[c] ? load_bits(src) : 0.0f;
      else
        next[c] = z_in && in_yx[c] ? load_f(src) : 0.0f;
    }
  };

  // One streamed plane p: step 0 takes input plane p, step t computes
  // plane p-t. Every cell is computed, and cells nearer R's edge than t
  // (outside step t's dependence cone) get values that only such cells
  // read; no cell outside the output tile is stored.
  auto iteration = [&](int p, int par, float (&older)[K][4],
                       float (&newer)[K][4]) {
    float f[4];  // the newest value of each cell
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = next[c];
    smem4[(par * S::PB + S::GUARD) / 4 + tid] =
        make_float4(f[0], f[1], f[2], f[3]);
    if (p + 1 < np) load(p + 1);
#pragma unroll
    for (int t = 1; t <= K; ++t) {
      if (p < 2 * t) {
        // step t has no valid plane yet: step t-1's new plane shifts in
        // once step t-1 has one
        if (p >= 2 * t - 2) {
#pragma unroll
          for (int c = 0; c < 4; ++c) older[t - 1][c] = f[c];
        }
        continue;
      }
      if (wy < t) continue;  // and so are the later steps
      const int64_t gz = zs - K + p - t;  // global row of the plane computed
      const auto z = cells.row(t, gz);
      // step t-1's plane q (written in the last iteration), at the group
      const float* pl =
          smem + ((t - 1) * 2 + (par ^ 1)) * S::PB + S::GUARD + 4 * tid;
      const float4 up4 = *reinterpret_cast<const float4*>(pl - RXP);  // mid-1
      const float4 dn4 = *reinterpret_cast<const float4*>(pl + RXP);  // mid+1
      const float mm[4] = {up4.x, up4.y, up4.z, up4.w};
      const float mp[4] = {dn4.x, dn4.y, dn4.z, dn4.w};
      // the centres are newer[t - 1], plane q
      float cl = __shfl_up_sync(0xffffffffu, newer[t - 1][3], 1);  // x-1
      float cr = __shfl_down_sync(0xffffffffu, newer[t - 1][0], 1);  // x+4
      if (lane == 0) cl = pl[-1];
      if (lane == 31) cr = pl[4];
      float nv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float left = c == 0 ? cl : newer[t - 1][c == 0 ? 0 : c - 1];
        const float right = c == 3 ? cr : newer[t - 1][c == 3 ? 3 : c + 1];
        // row-1, centre, row+1 (plane q-1, q, q+1), then the in-plane ones
        nv[c] = cells.cell(z, c, older[t - 1][c], newer[t - 1][c], f[c],
                           mm[c], mp[c], left, right);
      }
      if constexpr (Cells::LANE) cells.keep(z, nv, newer[t - 1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        older[t - 1][c] = f[c];  // q+1 now; the array holds q-1 next time
        f[c] = nv[c];
      }
      if (t < K) {
        smem4[((t * 2 + par) * S::PB + S::GUARD) / 4 + tid] =
            make_float4(nv[0], nv[1], nv[2], nv[3]);
      } else {
        // newer[K - 1] still holds the plane's values before step K
        cells.output(gz, nv, newer[K - 1], kept);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (keep[c]) {
            T* dst = out + gz * plane + goff + c;
            if constexpr (Cells::LANE) store_bits(dst, nv[c]);
            else store_f(dst, nv[c]);
          }
        }
      }
    }
    __syncthreads();  // this iteration's planes are written and read
  };

  load(0);
  for (int p = 0; p < np; p += 2) {
    iteration(p, 0, sa, sb);
    if (p + 1 < np) iteration(p + 1, 1, sb, sa);
  }
}

// The solo kernel: k masked steps of one field (ftcs3d.cu, lab3d.cu), on
// TY x TX tiles and lz-row segments.
template <typename T, int ORDER, int UPD, int K, int TY, int TX>
__global__ void __launch_bounds__(Stream<K, TY, TX>::NT,
                                  Stream<K, TY, TX>::MINB)
ftcs3d_stream_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t m,
                     int64_t mid, int64_t n, float r, int lz, Bounds b) {
  SoloCells<ORDER, UPD> cells(r, b);
  stream3_body<T, K, TY, TX>(cells, in, out, m, mid, n, lz, TY, TX,
                             blockIdx.x, blockIdx.y, blockIdx.z);
}

// The segment rows of a solo pass: a block holds its SM's place for all its
// lz + 2K planes, so a grid of W waves of `slots` blocks takes about
// W * (lz + 2K) plane-times; the lz of min(8, m)..min(lzmax, m) that makes
// that least (the longest of equals), as stream2_lz and lanes3d choose
// theirs. 0 where every lz needs over 65535 segments.
template <int K>
int stream3_lz(int64_t m, int64_t tiles, int64_t slots, int lzmax) {
  const int lo = m < 8 ? (int)m : 8;
  const int hi = m < lzmax ? (int)m : lzmax;
  int64_t best = -1;
  int lz = 0;
  for (int l = lo; l <= hi; ++l) {
    const int64_t segs = (m + l - 1) / l;
    if (segs > 65535) continue;
    const int64_t cost = (tiles * segs + slots - 1) / slots * (l + 2 * K);
    if (best < 0 || cost <= best) best = cost, lz = l;
  }
  return lz;
}

template <typename T, int ORDER, int UPD, int K, int LZ, int TY, int TX>
int launch_stream_k(const Args& a) {
  using S = Stream<K, TY, TX>;
  if (S::SMEM > (size_t)SMEM_LIMIT || (a.mid + TY - 1) / TY > 65535 ||
      (a.n + TX - 1) / TX > 2147483647)
    return (int)cudaErrorInvalidValue;
  auto kernel = ftcs3d_stream_kernel<T, ORDER, UPD, K, TY, TX>;
  // (per device: shards of one process may sit on several cards)
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM))
    return (int)e;
  // blocks of this instance resident on the card at once, asked once
  static int64_t slots = 0;
  if (slots < 1) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, S::NT, S::SMEM))
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    slots = (int64_t)sms * per_sm;
  }
  const int64_t gx = (a.n + TX - 1) / TX, gy = (a.mid + TY - 1) / TY;
  const int lz = stream3_lz<K>(a.m, gx * gy, slots, LZ);
  if (lz < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)((a.m + lz - 1) / lz));
  kernel<<<grid, S::NT, S::SMEM, a.stream>>>(static_cast<const T*>(a.in),
                                             static_cast<T*>(a.out), a.m,
                                             a.mid, a.n, a.r, lz, a.b);
  return (int)cudaGetLastError();
}

// The streaming kernel at run-time depth a.k (1..KMAX), up to LZ rows per
// block segment and a TY x TX (mid, col) output tile.
template <typename T, int ORDER, int UPD, int LZ, int TY, int TX>
int launch_stream(const Args& a) {
  switch (a.k) {
    case 1: return launch_stream_k<T, ORDER, UPD, 1, LZ, TY, TX>(a);
    case 2: return launch_stream_k<T, ORDER, UPD, 2, LZ, TY, TX>(a);
    case 3: return launch_stream_k<T, ORDER, UPD, 3, LZ, TY, TX>(a);
    case 4: return launch_stream_k<T, ORDER, UPD, 4, LZ, TY, TX>(a);
    case 5: return launch_stream_k<T, ORDER, UPD, 5, LZ, TY, TX>(a);
    case 6: return launch_stream_k<T, ORDER, UPD, 6, LZ, TY, TX>(a);
    case 7: return launch_stream_k<T, ORDER, UPD, 7, LZ, TY, TX>(a);
    case 8: return launch_stream_k<T, ORDER, UPD, 8, LZ, TY, TX>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
