// Stage 3's window statistics for Hopper (sm_90a): the column stats and the
// window error counts of every pileup window block of a job in ONE launch.
//
// Replaces no Pallas kernel: the JAX package computes the same function with
// jnp (`hairsplitter_tpu/ops/variants.py:column_stats` and
// `window_error_stats`, vmapped) or with their numpy twins on the host. The
// plain PyTorch version is `ops/variants.py:window_stats_plain`; the numpy
// twins are `column_stats_host` and `window_error_stats_host` in the same
// module. For every block and column it writes what `window_stats_batch`
// returns: the top-3 trimer codes by (count descending, code ascending),
// their counts, the column's coverage, and per block the mismatched and the
// covered cells (a covered cell whose central base, code / 25, differs from
// the contig's code at the column).
//
// Input: the blocks as one ragged batch, read at their own row counts. flat
// int8 [sum of rows, P] holds every block's rows one after another, offsets
// int64 [nb + 1] says where each block starts, codes int8 [nb, P] are the
// contig's codes under each block. Codes are 0..124 or TRIMER_ABSENT (127).
//
// What bounds it on this card: bytes. A cell is one byte read and about ten
// integer instructions (a compare, a shared-memory increment, the central
// base); a column adds 125 bins to clear and scan. At 26 blocks of 64 rows
// and 8,192 columns the kernel reads 13.8 MB and writes 6.1 MB, some 6 us
// at 3.35 TB/s: what it saves is the host's sort, not device time. It
// stays well above that bound: a block of 64 threads keeps 7 blocks an SM,
// too few loads in flight to fill the memory system, and each column's 250
// shared-memory accesses to clear and scan its bins do not shrink with rows.
//
// What the design does about it:
//  * One thread owns one column of one block and walks the block's rows, so
//    the 32 threads of a warp read 32 neighbouring bytes of a row at each
//    step. The loop loads 16 rows before it counts them, so that a thread
//    has 16 loads in flight: on an H100 (700 W), with 4 the kernel took
//    0.061 ms at 26 x 64 x 8,192 and 0.235 ms at 2 x 2,000 x 8,192, with 16
//    0.053 and 0.146 ms (with 32, 82 registers for 1-7% more).
//  * Each column keeps its 125-bin histogram in shared memory, laid out bin
//    by bin with the block's 64 columns side by side (bin b of column c at
//    b * 64 + c): a warp's 32 increments fall on 32 distinct banks whatever
//    codes its cells hold. Counters are int32, wide enough for any block. No
//    thread touches another's bins, so the block needs no barrier.
//  * The top-3 is one scan over the bins in ascending code order with strict
//    `>`, so that a tie goes to the smaller code, as the sort of the twins does.
//  * The block's mismatch and cover sums leave by one `__reduce_add_sync`
//    per warp and one 64-bit atomic add per warp; the launcher clears the
//    sums first (integer sums: the order of the atomics changes nothing).
//  * A block is 64 threads with 32,000 B of shared memory: 7 blocks an SM.

#include <cstdint>
#include <cstring>

#include "host_emulation.cuh"

namespace {

constexpr int TILE = 64;       // columns (= threads) of one block
constexpr int BINS = 125;      // N_TRIMERS
constexpr int ABSENT = 127;    // TRIMER_ABSENT
constexpr int AHEAD = 16;      // rows loaded before they are counted

struct ColumnSums {
  uint32_t mism;
  uint32_t cells;
};

// Column `col` of block `b`: its histogram in hist[bin * TILE + lane], then
// the top-3 and the coverage, written to the outputs. Returns the column's
// mismatched and covered cells (0 for a column past P).
__device__ __forceinline__ ColumnSums column_stats(
    int lane, int b, int col, const int8_t* __restrict__ flat, int64_t row0, int64_t n_rows, int P,
    const int8_t* __restrict__ codes, int32_t* hist, int32_t* top_codes, int32_t* top_counts,
    int32_t* coverage) {
  ColumnSums sums{0u, 0u};
  if (col >= P) return sums;
  for (int bin = 0; bin < BINS; ++bin) hist[bin * TILE + lane] = 0;
  const int code = codes[static_cast<size_t>(b) * P + col];
  const int8_t* cell = flat + static_cast<size_t>(row0) * P + col;
  int64_t r = 0;
  for (; r + AHEAD <= n_rows; r += AHEAD) {
    int v[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) v[k] = cell[static_cast<size_t>(r + k) * P];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (v[k] == ABSENT) continue;
      ++sums.cells;
      sums.mism += (v[k] / 25 != code);
      if (static_cast<unsigned>(v[k]) < static_cast<unsigned>(BINS)) ++hist[v[k] * TILE + lane];
    }
  }
  for (; r < n_rows; ++r) {
    const int v = cell[static_cast<size_t>(r) * P];
    if (v == ABSENT) continue;
    ++sums.cells;
    sums.mism += (v / 25 != code);
    if (static_cast<unsigned>(v) < static_cast<unsigned>(BINS)) ++hist[v * TILE + lane];
  }
  int c1 = -1, c2 = -1, c3 = -1, k1 = 0, k2 = 0, k3 = 0;
  for (int bin = 0; bin < BINS; ++bin) {
    const int c = hist[bin * TILE + lane];
    if (c > c1) {
      c3 = c2; k3 = k2; c2 = c1; k2 = k1; c1 = c; k1 = bin;
    } else if (c > c2) {
      c3 = c2; k3 = k2; c2 = c; k2 = bin;
    } else if (c > c3) {
      c3 = c; k3 = bin;
    }
  }
  const size_t at = static_cast<size_t>(b) * P + col;
  top_codes[3 * at] = k1;
  top_codes[3 * at + 1] = k2;
  top_codes[3 * at + 2] = k3;
  top_counts[3 * at] = c1;
  top_counts[3 * at + 1] = c2;
  top_counts[3 * at + 2] = c3;
  coverage[at] = static_cast<int32_t>(sums.cells);
  return sums;
}

#if !defined(HS_HOST_EMULATION)

__global__ void __launch_bounds__(TILE) window_stats_kernel(
    const int8_t* __restrict__ flat,       // [sum of rows, P]
    const int64_t* __restrict__ offsets,   // [nb + 1]
    const int8_t* __restrict__ codes,      // [nb, P]
    int P, int tiles,
    int32_t* __restrict__ top_codes,       // [nb, P, 3]
    int32_t* __restrict__ top_counts,      // [nb, P, 3]
    int32_t* __restrict__ coverage,        // [nb, P]
    unsigned long long* __restrict__ mism,   // [nb], cleared by the launcher
    unsigned long long* __restrict__ cells) {  // [nb], cleared by the launcher
  __shared__ int32_t hist[BINS * TILE];
  const int b = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * TILE + threadIdx.x;
  const int64_t row0 = offsets[b];
  const ColumnSums s = column_stats(threadIdx.x, b, col, flat, row0, offsets[b + 1] - row0, P, codes, hist,
                                    top_codes, top_counts, coverage);
  const uint32_t m = __reduce_add_sync(0xFFFFFFFFu, s.mism);
  const uint32_t c = __reduce_add_sync(0xFFFFFFFFu, s.cells);
  if ((threadIdx.x & 31) == 0 && c != 0) {
    atomicAdd(mism + b, static_cast<unsigned long long>(m));
    atomicAdd(cells + b, static_cast<unsigned long long>(c));
  }
}

#endif

}  // namespace

#if defined(HS_HOST_EMULATION)

// The kernel's blocks and threads run one after another on the host; a
// block's shared histograms start as garbage, as on the card.
extern "C" int hs_window_stats_host(const int8_t* flat, const int64_t* offsets, const int8_t* codes, int nb,
                                    int P, int32_t* top_codes, int32_t* top_counts, int32_t* coverage,
                                    int64_t* mism, int64_t* cells) {
  if (nb < 0 || P <= 0) return 1;
  int32_t hist[BINS * TILE];
  const int tiles = (P + TILE - 1) / TILE;
  for (int b = 0; b < nb; ++b) {
    mism[b] = cells[b] = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      std::memset(hist, 0xAB, sizeof(hist));
      for (int lane = 0; lane < TILE; ++lane) {
        const ColumnSums s = column_stats(lane, b, tile * TILE + lane, flat, offsets[b],
                                          offsets[b + 1] - offsets[b], P, codes, hist, top_codes,
                                          top_counts, coverage);
        mism[b] += s.mism;
        cells[b] += s.cells;
      }
    }
  }
  return 0;
}

#else

// Launch on `stream` (after clearing the two sums on it). Returns 1 for a
// shape it does not take, else the launch's cudaGetLastError() (0 = launched).
extern "C" int hs_window_stats(const int8_t* flat, const int64_t* offsets, const int8_t* codes, int nb, int P,
                               int32_t* top_codes, int32_t* top_counts, int32_t* coverage, int64_t* mism,
                               int64_t* cells, void* stream) {
  if (nb < 0 || P <= 0) return 1;
  if (nb == 0) return 0;
  const int tiles = (P + TILE - 1) / TILE;
  if (static_cast<int64_t>(nb) * tiles > 0x7FFFFFFF) return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(mism, 0, sizeof(int64_t) * nb, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(cells, 0, sizeof(int64_t) * nb, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_stats_kernel<<<nb * tiles, TILE, 0, s>>>(
      flat, offsets, codes, P, tiles, top_codes, top_counts, coverage,
      reinterpret_cast<unsigned long long*>(mism), reinterpret_cast<unsigned long long*>(cells));
  return static_cast<int>(cudaGetLastError());
}

#endif
