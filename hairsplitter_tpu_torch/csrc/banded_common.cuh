// The int32 banded edit-distance row shared by the two modes of K2:
// `banded_dp.cu` (check mode: the backpointer or run-encoding plane, the row
// at i == qlen, the column minimum) and `banded_fused.cu` (the main path: DP,
// readout and traceback in one kernel). Both step the band through `dp_row`
// and fold the j == tlen column through `lane_col_update` / `col_decode`, so
// the two cannot drift.
//
// One warp owns one alignment. The band is W = 128 cells (dl = 64), four
// consecutive cells per lane, kept in x-space (x = D - b) so that the D-run
// recurrence (a LEFT move costs 1 and moves one cell up the band) is a plain
// running min over the band: a serial min over the lane's four cells, then a
// five-step shuffle scan of the lane aggregates.
//
// Written once for two builds. On the card a `PerLane<T>` is one register of
// the thread and `HS_EACH_LANE` runs its body once, for the thread's own
// lane; the `warp_*` functions are the warp's exchange points (shuffles,
// scans, reductions). With -DHS_HOST_EMULATION (g++, a machine without a
// GPU) a `PerLane<T>` holds all 32 lanes, `HS_EACH_LANE` steps them in turn
// and the exchange points work on the 32 values, so the same control flow
// and arithmetic can be tested on the host. Whatever lanes exchange through
// shared memory must therefore sit in different `HS_EACH_LANE` blocks with
// a `warp_sync()` between them.

#pragma once

#include <climits>
#include <cstdint>

#include "host_emulation.cuh"

#if defined(HS_HOST_EMULATION)
#define HS_EACH_LANE for (int lane = 0; lane < 32; ++lane)
#else
#define HS_EACH_LANE if (const int lane = static_cast<int>(threadIdx.x & 31u); true)
#endif

namespace hsb {

constexpr int W = 128;      // band cells
constexpr int DL = W / 2;   // band apex: cell b of row i is target column j = i + b - DL
constexpr int CPL = W / 32; // cells per lane
constexpr int32_t INF = 1 << 20;
constexpr int T_SENTINEL = 6;
constexpr unsigned FULL = 0xFFFFFFFFu;
// bits of a lane's class byte: bit c = cell c's value equals its diagonal
// candidate, bit 4 + c = it equals its up candidate. The backpointer takes
// the diagonal first: DIAG = bit c, UP = bit 4 + c without bit c, LEFT = neither.
constexpr int UP_SHIFT = 4;
// column-minimum key of "no cell yet": value INF, lowest priority
constexpr uint32_t COL_NONE = (static_cast<uint32_t>(INF) << 8) | 0xFFu;

#if defined(HS_HOST_EMULATION)
template <class T>
struct PerLane {
  T v[32];
  T& operator[](int lane) { return v[lane]; }
  const T& operator[](int lane) const { return v[lane]; }
};
#else
template <class T>
struct PerLane {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
};
#endif

struct Cells { int32_t c[CPL]; };  // a lane's four band cells

// ---------------------------------------------------------------- small arithmetic

__device__ __forceinline__ int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

__device__ __forceinline__ int32_t min3(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimin3_s32(a, b, c);  // one instruction on Hopper
#else
  const int32_t ab = a < b ? a : b;
  return ab < c ? ab : c;
#endif
}

// max(min(a + b, c), 0)
__device__ __forceinline__ int32_t add_min_relu(int32_t a, int32_t b, int32_t c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmin_s32_relu(a, b, c);  // one instruction on Hopper
#else
  const int32_t m = imin(a + b, c);
  return m > 0 ? m : 0;
#endif
}

// cells.c[k] for a run-time k in [0, CPL): selects, so the cells stay in registers
__device__ __forceinline__ int32_t pick(const Cells& cells, int k) {
  int32_t v = cells.c[0];
#pragma unroll
  for (int c = 1; c < CPL; ++c) v = k == c ? cells.c[c] : v;
  return v;
}

// ---------------------------------------------------------------- the warp's exchange points

__device__ __forceinline__ void warp_sync() {
#if !defined(HS_HOST_EMULATION)
  __syncwarp();
#endif
}

// dst[lane] = src[lane + 1]; the last lane keeps its own value
__device__ __forceinline__ void warp_shfl_down1(PerLane<int32_t>& dst, const PerLane<int32_t>& src) {
#if defined(HS_HOST_EMULATION)
  for (int l = 0; l < 32; ++l) dst[l] = src[l < 31 ? l + 1 : l];
#else
  dst.v = __shfl_down_sync(FULL, src.v, 1);
#endif
}

// before[lane] = min of agg over the lanes below it (INT_MAX for lane 0)
__device__ __forceinline__ void warp_prefix_min(const PerLane<int32_t>& agg, PerLane<int32_t>& before) {
#if defined(HS_HOST_EMULATION)
  int32_t run = INT_MAX;
  for (int l = 0; l < 32; ++l) {
    before[l] = run;
    run = agg[l] < run ? agg[l] : run;
  }
#else
  // a lane below the shift distance gets its own value back, which leaves
  // its min unchanged: no lane test in the scan
  int32_t a = agg.v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) a = imin(a, __shfl_up_sync(FULL, a, d));
  const int32_t b = __shfl_up_sync(FULL, a, 1);
  before.v = (threadIdx.x & 31u) == 0u ? INT_MAX : b;
#endif
}

__device__ __forceinline__ uint32_t warp_reduce_min(const PerLane<uint32_t>& v) {
#if defined(HS_HOST_EMULATION)
  uint32_t r = v[0];
  for (int l = 1; l < 32; ++l) r = v[l] < r ? v[l] : r;
  return r;
#else
  return __reduce_min_sync(FULL, v.v);
#endif
}

__device__ __forceinline__ uint32_t warp_reduce_max(const PerLane<uint32_t>& v) {
#if defined(HS_HOST_EMULATION)
  uint32_t r = v[0];
  for (int l = 1; l < 32; ++l) r = v[l] > r ? v[l] : r;
  return r;
#else
  return __reduce_max_sync(FULL, v.v);
#endif
}

// the value lane `src` holds (src in [0, 32), the same for every lane)
__device__ __forceinline__ int32_t warp_shfl_from(const PerLane<int32_t>& v, int src) {
#if defined(HS_HOST_EMULATION)
  return v[src];
#else
  return __shfl_sync(FULL, v.v, src);
#endif
}

// ---------------------------------------------------------------- the DP row

// Row 0 (leading deletions) in x-space: D = j for 0 <= j <= tlen, else INF.
__device__ __forceinline__ void lane_row0(int lane, int tlen, Cells& x) {
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int b = lane * CPL + c;
    const int j0 = b - DL;
    x.c[c] = ((j0 >= 0 && j0 <= tlen) ? j0 : INF) - b;
  }
}

// A lane's candidates of row i from the previous row `x`: per cell the
// diagonal (tword holds the four target codes under the lane's cells, qrep
// the query code in every byte), the up move from cell b + 1 (x_next is the
// next lane's first cell), and the running min of both over the lane's cells.
//   D_up[b] = D_prev[b + 1] + 1  ->  x_up[b] = x_prev[b + 1] + 2
__device__ __forceinline__ void lane_candidates(int lane, const Cells& x, uint32_t tword, uint32_t qrep,
                                                int32_t x_next, Cells& diag, Cells& up, Cells& s) {
  // 0xFF (-1 as a signed byte) where the codes differ: x + (-1)(-1) by one
  // byte dot product per cell
  const int ne = static_cast<int>(__vcmpne4(tword, qrep));
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    diag.c[c] = __dp4a(ne, static_cast<int>(0xFFu << (8 * c)), x.c[c]);
    if (c < CPL - 1)
      up.c[c] = x.c[c + 1] + 2;
    else
      up.c[c] = lane == 31 ? INF + 1 - (W - 1) : x_next + 2;
    s.c[c] = c == 0 ? imin(diag.c[c], up.c[c]) : min3(diag.c[c], up.c[c], s.c[c - 1]);
  }
}

// Which cells of a row are forced to INF.
//   MASK_BOTH  every cell outside 0 <= j <= tlen and, with past_q, the whole
//              row: the plain version's mask, cell for cell (check mode);
//   MASK_NONE  no cell. Every cell with j <= tlen still gets the plain
//              version's value and class bits. A cell with j < 0 comes out at
//              INF by itself: its diagonal, up and D-run candidates all come
//              from cells with j < 0 (columns j - 1 and j of the row before,
//              lower cells of its own row), which are INF in row 0 and so, by
//              induction, in every row, and the cap at INF does the rest. A
//              cell with j > tlen keeps whatever the recurrence gives it, but
//              no cell with j <= tlen reads it, for the same reason: a cell's
//              candidates never come from a column above its own.
enum RowMask { MASK_BOTH, MASK_NONE };

// Finishes the lane's cells of row i: the D-run min with everything below
// the lane (`before`), the mask (valid cells clamp at INF), and each cell's
// two class bits. Leaves the row in `x`; returns the lane's class byte.
template <RowMask MASK>
__device__ __forceinline__ uint32_t lane_finish(int lane, Cells& x, const Cells& diag, const Cells& up,
                                                const Cells& s, int32_t before, int i, int tlen, bool past_q) {
  uint32_t cls = 0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int b = lane * CPL + c;
    bool invalid = false;
    // MASK_BOTH in one unsigned compare: j < 0 wraps
    if (MASK == MASK_BOTH) invalid = static_cast<unsigned>(b + i - DL) > static_cast<unsigned>(tlen) || past_q;
    const int32_t r = invalid ? INF - b : min3(s.c[c], before, INF - b);
    cls |= (static_cast<uint32_t>(r == diag.c[c]) << c) | (static_cast<uint32_t>(r == up.c[c]) << (UP_SHIFT + c));
    x.c[c] = r;
  }
  return cls;
}

// One query row i (1-based) of the warp's alignment: x becomes row i, cls
// each lane's class byte. `past_q` (i > qlen) is only read with MASK_BOTH.
template <RowMask MASK>
__device__ __forceinline__ void dp_row(PerLane<Cells>& x, const PerLane<uint32_t>& tword, uint32_t qrep,
                                       int i, int tlen, bool past_q, PerLane<uint32_t>& cls) {
  PerLane<int32_t> x0, x_next, agg, before;
  PerLane<Cells> diag, up, s;
  HS_EACH_LANE { x0[lane] = x[lane].c[0]; }
  warp_shfl_down1(x_next, x0);
  HS_EACH_LANE {
    lane_candidates(lane, x[lane], tword[lane], qrep, x_next[lane], diag[lane], up[lane], s[lane]);
    agg[lane] = s[lane].c[CPL - 1];
  }
  warp_prefix_min(agg, before);  // the exact D-run recurrence: a prefix min over the band
  HS_EACH_LANE {
    cls[lane] = lane_finish<MASK>(lane, x[lane], diag[lane], up[lane], s[lane], before[lane], i, tlen, past_q);
  }
}

// ---------------------------------------------------------------- the j == tlen column

// Row i crosses the j == tlen column at cell b_col = tlen - i + DL. Its
// owner folds the cell's D into its key `(D << 8) | (W - 1 - b)`: the warp's
// minimum key is the least D and, among equals, the LARGEST cell, which is
// the earliest row (i = tlen + DL - b).
__device__ __forceinline__ void lane_col_update(int lane, const Cells& x, int i, int tlen, uint32_t& key) {
  const int b_col = tlen - i + DL;
  const int k = b_col - lane * CPL;
  if (static_cast<unsigned>(k) < static_cast<unsigned>(CPL)) {
    const uint32_t mine = (static_cast<uint32_t>(pick(x, k) + b_col) << 8) | static_cast<uint32_t>(W - 1 - b_col);
    key = mine < key ? mine : key;
  }
}

// The warp's minimum key -> (colmin_val, colmin_i); no reachable cell -> (INF, 0).
__device__ __forceinline__ void col_decode(uint32_t key, int tlen, int32_t& val, int32_t& row) {
  val = static_cast<int32_t>(key >> 8);
  const int b = W - 1 - static_cast<int>(key & 0xFFu);
  row = val >= INF ? 0 : tlen + DL - b;
}

}  // namespace hsb
