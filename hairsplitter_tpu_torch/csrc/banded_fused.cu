// K2, main-path mode: the int32 banded edit-distance DP, the end-cell readout
// and the traceback walk in ONE kernel for Hopper (sm_90a).
//
// Replaces, on the `use_myers=False` mapping path, the Pallas TPU kernel
// `hairsplitter_tpu/ops/align_pallas.py:_dp_kernel` (with emit_enc) together
// with the XLA programs the JAX package runs around it
// (`ops/align_device.py:readout_device` and `traceback_scan`, composed in
// `_align_traceback_rows_impl(kernel="pallas")`). From the code tensors
// q [N, B], t [N, T] and q_lens, t_lens, modes it writes the fused buffer
// uint8 [N, 16 + B] of `align_traceback_rows(kernel="pallas")` byte for byte:
// int32 cost, clip, start_i, start_b, then one token `d | up << 7` per query
// row. The plain PyTorch version is `ops/align_device.py:banded_fused_plain`.
// The check mode, `banded_dp.cu`, emits what the Pallas kernel emits and
// shares the row recurrence with this file through `banded_common.cuh`.
//
// What bounds it on this card: integer operations on one dependent chain per
// row, not bytes. A row is 128 cells of compare, add and min plus a prefix
// min over the band that the next row waits on; an alignment moves B + T + 12
// bytes in and 16 + B bytes out. Written as three steps (kernel, readout,
// eager walk) the same function also moved a [N, B, 128] int16 plane through
// device memory (256 B per row and alignment) and launched 256 gathers.
//
// What the design does about it:
//  * One warp owns one alignment from the codes to its output row; four band
//    cells per lane, the state in x-space, so the D-run recurrence is a
//    running min: `banded_common.cuh:dp_row`, with Hopper's three-input min,
//    the diagonal's mismatch added by one byte dot product per cell, and a
//    prefix-min scan without lane tests.
//  * Classes, not codes, and on chip. The walk needs of a row only, for the
//    cell it stands on, the nearest non-LEFT cell at or below it and whether
//    that cell is UP. A lane keeps that of its four cells in one byte (per
//    cell: equals its diagonal candidate, equals its up candidate; the walk
//    reads UP where only the second holds); four rows make a word, stored to a
//    per-warp scratch in shared memory (32 B per row, 8 KB per alignment at
//    B = 256). No plane, no prefix max over the band in the forward pass.
//  * The loop stops at row min(qlen, B); the extension row is then simply
//    the last row, still in registers. The target codes under a lane's cells
//    slide by one byte per row: two aligned words per lane, one shared-memory
//    read per four rows and one funnel shift per row; the query code of four
//    rows is one broadcast read.
//  * The readout in the warp: the corner by one shuffle from its owner; the
//    extension row's best cell and the column minimum by one
//    `__reduce_min_sync` each over keys that carry the tie rule (lowest cell
//    for the row, earliest row for the column); then `readout_device`'s
//    selects, identical in every lane.
//  * The walk in the warp: per row every lane masks its non-LEFT cells to
//    those at or below the band position and forms a key of its lane, those
//    cells and its UP bits; one `__reduce_max_sync` picks the largest such
//    cell of the band, which is what the run code that `traceback_scan`
//    reads from the plane names. Tokens collect in shared memory
//    (the query's staging area, free by then) and the 16 + B bytes leave as
//    one coalesced copy.
//  * A block is one warp with 8.9 KB of shared memory at B = 256, up to 25
//    blocks per SM. Alignments differ in length, and a block's shared memory
//    is held until its slowest warp has ended: with four warps a block the
//    drawn jobs ran a fifth slower.
//  * No cell is masked. The plain version forces the cells outside
//    0 <= j <= tlen to INF; here a cell with j < 0 comes out at INF by itself
//    and a cell with j > tlen is never read by a cell with j <= tlen
//    (`banded_common.cuh:RowMask`), which saves four compares and selects a
//    row and lane.
//
// Exactness. (1) Stopping at min(qlen, B): rows i > qlen are INF in the plain
// version, never become `row_at_q`, enter the column minimum only as INF
// (which never wins its strict compare) and are never walked, because a walk
// starts at start_i <= qlen. For qlen > B (a length the packer never makes)
// all B rows run, the extension row is all INF as in the plain version, and
// the column stays live. qlen == 0 runs no row: the extension row is row 0.
// (2) Classes instead of codes: the plain version's `enc[r][b]` is the prefix
// max over cells c <= b of `((c + 1) << 1) | is_up(c)` on non-LEFT cells, 0
// on LEFT ones. The key grows with c, so that maximum is the key of the
// largest non-LEFT cell c <= b, or 0 when there is none, which is what the
// lanes' masks and the warp's maximum key find from the class bits; the class
// bits themselves come from the same compares as the plain version's
// backpointers. (3) No mask: every cell with j <= tlen holds the plain
// version's value and class bits (`banded_common.cuh:RowMask`), and nothing
// else is read: the readout masks the extension row to 0 <= j <= tlen, the
// corner and the column cells lie at j == tlen, and a walk starts on such a
// cell and only moves to cells at or below it in the band, i.e. to columns
// at or below its own.
//
// Codes: any int8 codes; a cell matches when the query and target codes are
// equal. Target positions outside [0, T) read the sentinel 6.

#include <cstdint>

#if defined(HS_HOST_EMULATION)
#include <algorithm>
#include <vector>
#endif

#include "banded_common.cuh"

namespace {

using hsb::Cells;
using hsb::CPL;
using hsb::DL;
using hsb::INF;
using hsb::PerLane;
using hsb::W;

constexpr int WARPS = 1;     // alignments per block
constexpr int HEADER = 16;   // bytes of int32 cost, clip, start_i, start_b before the tokens
constexpr int T_SLACK = 16;  // bytes staged past B + W: the sliding window reads one word ahead

// Shared memory of one warp, every part a multiple of 16 bytes (B is one of 16):
//   [HEADER + B]       the output row: header, then the query codes and,
//                      once the forward pass is over, the tokens
//   [B + W + T_SLACK]  the padded target: ts[k] = t[k - DL], sentinel outside
//   [B / 4][32] words  the class scratch: byte k of word [g][lane] is the
//                      lane's class byte of row 4 g + k + 1
__host__ __device__ __forceinline__ size_t warp_smem_bytes(int B) {
  return static_cast<size_t>(HEADER + B) + static_cast<size_t>(B + W + T_SLACK) + static_cast<size_t>(B) * 32;
}

// A lane's key of one row for the walk at band position b: 0 if none of its
// non-LEFT cells lies at or below b, else `lane << 8 | those cells << 4 | its
// UP bits`. Keys order by lane and then by the lane's highest cell, so the
// warp's maximum key belongs to the largest non-LEFT cell at or below b.
// `nonleft` and `up` hold the row's class nibbles in their low four bits
// (higher bits are ignored).
__device__ __forceinline__ uint32_t lane_walk_key(int lane, uint32_t nonleft, uint32_t up, int b) {
  const int t = hsb::add_min_relu(b, 1 - lane * CPL, CPL);  // how many of the lane's cells lie at or below b
  const uint32_t x = nonleft & ((1u << t) - 1u);
  const uint32_t key = (static_cast<uint32_t>(lane) << 8) | (x << 4) | (up & 0xFu);
  return x ? key : 0u;
}

// The walk of one alignment, by its warp: rows start_i .. 1 over the class
// scratch, a group of four rows per scratch word; one token `d | up << 7` per
// visited row into `tok32` (0 for the rows above start_i in its first group;
// the words of higher groups are left alone). start_i may not pass the rows
// the scratch holds; start_b may be any value, and a band position outside
// [0, W) finds no cell, as it reads the run code 0 in the plain version.
__device__ __forceinline__ void walk_warp(const uint32_t* cls32, int start_i, int start_b, uint32_t* tok32) {
  int b = start_b;
  for (int g = (start_i - 1) >> 2; g >= 0; --g) {
    PerLane<uint32_t> nl4, up4;  // the group's non-LEFT and UP nibbles, a byte per row
    HS_EACH_LANE {
      const uint32_t w = cls32[g * 32 + lane];
      const uint32_t eq_up = (w >> hsb::UP_SHIFT) & 0x0F0F0F0Fu;
      nl4[lane] = (w & 0x0F0F0F0Fu) | eq_up;
      up4[lane] = eq_up & ~w;  // the diagonal goes first
    }
    uint32_t tk = 0u;  // the group's tokens; rows above start_i stay 0
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      if (4 * g + k + 1 > start_i) continue;
      PerLane<uint32_t> keys;
      HS_EACH_LANE { keys[lane] = lane_walk_key(lane, nl4[lane] >> (8 * k), up4[lane] >> (8 * k), b); }
      uint32_t key = hsb::warp_reduce_max(keys);
      if (b < 0 || b >= W) key = 0u;
      // the plain version's enc[r - 1][b] is ((nl + 1) << 1) | up, or 0: then nl = 0, up = 0
      const uint32_t x = (key >> 4) & 0xFu;
      const int c = x ? 31 - __clz(x) : 0;
      const int nl = key ? static_cast<int>(key >> 8) * CPL + c : 0;  // the cell the run ends at
      const int up = static_cast<int>((key >> c) & 1u);  // 0 when there is no key
      const int d = b - nl > 0 ? b - nl : 0;
      tk |= static_cast<uint32_t>((d | (up << 7)) & 0xFF) << (8 * k);
      b = nl + up;
    }
    HS_EACH_LANE { if (lane == 0) tok32[g] = tk; }
  }
}

// Four query rows, 4 g + 1 .. 4 g + 4 (without FULL: only those up to `rows`):
// one broadcast read of their query codes and one read per lane of the next target word, then
// per row the DP step, the class byte and, for an extension job, the column
// fold; one scratch word per lane. `w1` carries the target word one ahead.
template <bool FULL>
__device__ __forceinline__ void forward_group(int g, int rows, int tlen, bool is_ext, const uint32_t* qs32,
                                              const uint32_t* ts32, uint32_t* cls32, PerLane<Cells>& x,
                                              PerLane<uint32_t>& col_key, PerLane<uint32_t>& w1) {
  const uint32_t qw = qs32[g];
  PerLane<uint32_t> w0, acc;  // the target word under the lane's cells; the group's class bytes
  HS_EACH_LANE {
    w0[lane] = w1[lane];
    w1[lane] = ts32[g + lane + 1];
    acc[lane] = 0u;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * g + k + 1;
    if (!FULL && i > rows) break;
    const uint32_t qrep = __byte_perm(qw, 0u, 0x1111u * k);  // byte k in every byte
    PerLane<uint32_t> tword, cls;
    HS_EACH_LANE { tword[lane] = __funnelshift_r(w0[lane], w1[lane], 8u * k); }
    hsb::dp_row<hsb::MASK_NONE>(x, tword, qrep, i, tlen, false, cls);
    HS_EACH_LANE {
      acc[lane] |= cls[lane] << (8 * k);
      if (is_ext) hsb::lane_col_update(lane, x[lane], i, tlen, col_key[lane]);  // only an extension reads the column
    }
  }
  HS_EACH_LANE { cls32[g * 32 + lane] = acc[lane]; }
}

// The whole of one alignment, by one warp: staging, forward DP, end-cell
// choice, backward walk, output copy. `sm` is the warp's shared memory,
// `out_row` its 16 + B bytes of the fused buffer.
__device__ __forceinline__ void align_warp(int B, int T, const int8_t* qn, const int8_t* tn,
                                           int qlen, int tlen, int mode, uint8_t* sm, uint8_t* out_row) {
  uint8_t* row_buf = sm;
  uint8_t* qs = row_buf + HEADER;
  uint8_t* ts = row_buf + HEADER + B;
  uint32_t* cls32 = reinterpret_cast<uint32_t*>(ts + B + W + T_SLACK);
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* ts32 = reinterpret_cast<const uint32_t*>(ts);

  const int rows = qlen < 0 ? 0 : (qlen > B ? B : qlen);  // rows the forward pass steps
  const bool is_ext = mode == 1;

  // ---- stage the query and as much of the padded target as the rows read:
  // group g of four rows reads words g + lane and g + lane + 1
  const int t_need = ((rows + 3) & ~3) + W + 4;
  HS_EACH_LANE {
    for (int c = lane; c < B / 16; c += 32)
      reinterpret_cast<uint4*>(qs)[c] = reinterpret_cast<const uint4*>(qn)[c];
    for (int k = lane; k < t_need; k += 32) {
      const int j = k - DL;
      ts[k] = (j >= 0 && j < T) ? static_cast<uint8_t>(tn[j]) : static_cast<uint8_t>(hsb::T_SENTINEL);
    }
  }
  hsb::warp_sync();

  // ---- forward: rows 1 .. rows, four per group
  PerLane<Cells> x;          // the last row in x-space
  PerLane<uint32_t> col_key; // the lane's best cell of the j == tlen column
  PerLane<uint32_t> w1;      // the target word one ahead of the lane's cells
  HS_EACH_LANE {
    hsb::lane_row0(lane, tlen, x[lane]);
    col_key[lane] = hsb::COL_NONE;
    w1[lane] = ts32[lane];
  }
  const int full = rows >> 2;  // groups of four whole rows
  for (int g = 0; g < full; ++g) forward_group<true>(g, rows, tlen, is_ext, qs32, ts32, cls32, x, col_key, w1);
  if (rows & 3) forward_group<false>(full, rows, tlen, is_ext, qs32, ts32, cls32, x, col_key, w1);

  // ---- row i == qlen (x, when the loop ended on it): the corner cell and the
  // first-index argmin over 0 <= j <= tlen, by keys `(D << 8) | b`
  const bool have_row = qlen >= 0 && qlen <= B;
  const int b_corner = tlen - qlen + DL;
  PerLane<uint32_t> row_key;
  PerLane<int32_t> corner_cand;
  HS_EACH_LANE {
    uint32_t best = 0xFFFFFFFFu;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = lane * CPL + c;
      const int j = qlen + b - DL;
      const int32_t d = (have_row && j >= 0 && j <= tlen) ? x[lane].c[c] + b : INF;
      const uint32_t key = (static_cast<uint32_t>(d) << 8) | static_cast<uint32_t>(b);
      best = key < best ? key : best;
    }
    row_key[lane] = best;
    corner_cand[lane] = hsb::pick(x[lane], b_corner & (CPL - 1)) + lane * CPL + (b_corner & (CPL - 1));
  }
  const uint32_t rk = hsb::warp_reduce_min(row_key);
  const int32_t rowbest = static_cast<int32_t>(rk >> 8);
  const int b_row = static_cast<int>(rk & 0xFFu);
  int32_t corner = INF;
  if (have_row && b_corner >= 0 && b_corner < W) corner = hsb::warp_shfl_from(corner_cand, b_corner / CPL);
  int32_t colmin_val = INF, colmin_i = 0;
  if (is_ext) hsb::col_decode(hsb::warp_reduce_min(col_key), tlen, colmin_val, colmin_i);

  // ---- end cell: global corner / extension row / target-exhausted column
  const bool use_col = is_ext && colmin_val < rowbest;
  const int32_t cost = is_ext ? (rowbest < colmin_val ? rowbest : colmin_val) : corner;
  int start_i = use_col ? colmin_i : qlen;
  int start_b = use_col ? tlen - colmin_i + DL : (is_ext ? b_row : b_corner);
  int clip = use_col ? qlen - colmin_i : 0;
  if (cost >= INF) {  // unreachable end cell: empty walk
    start_i = 0;
    start_b = DL;
    clip = 0;
  }

  // ---- the output row's header; the query is spent, its bytes become the
  // tokens: rows above start_i stay 0
  hsb::warp_sync();
  HS_EACH_LANE {
    for (int c = lane; c < B / 16; c += 32) reinterpret_cast<uint4*>(qs)[c] = make_uint4(0u, 0u, 0u, 0u);
    if (lane == 0)
      *reinterpret_cast<uint4*>(row_buf) =
          make_uint4(static_cast<uint32_t>(cost), static_cast<uint32_t>(clip),
                     static_cast<uint32_t>(start_i), static_cast<uint32_t>(start_b));
  }
  hsb::warp_sync();

  // ---- backward: rows start_i .. 1
  walk_warp(cls32, start_i, start_b, reinterpret_cast<uint32_t*>(qs));
  hsb::warp_sync();

  // ---- one coalesced copy of the row
  HS_EACH_LANE {
    for (int c = lane; c < (HEADER + B) / 16; c += 32)
      reinterpret_cast<uint4*>(out_row)[c] = reinterpret_cast<const uint4*>(row_buf)[c];
  }
}

#if !defined(HS_HOST_EMULATION)

__global__ void __launch_bounds__(WARPS * 32) banded_fused_kernel(
    const int8_t* __restrict__ q,       // [N, B]
    const int8_t* __restrict__ t,       // [N, T]
    const int32_t* __restrict__ q_lens,
    const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ modes,
    int N, int B, int T,
    uint8_t* __restrict__ out) {        // [N, 16 + B]
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // the whole warp leaves together: no exchange is left short
  align_warp(B, T, q + static_cast<size_t>(n) * B, t + static_cast<size_t>(n) * T, q_lens[n], t_lens[n],
             modes[n], smem + warp * warp_smem_bytes(B), out + static_cast<size_t>(n) * (HEADER + B));
}

#endif

}  // namespace

// Dynamic shared memory of one block at chunk B.
extern "C" int hs_banded_fused_smem_bytes(int B) { return static_cast<int>(WARPS * warp_smem_bytes(B)); }

#if defined(HS_HOST_EMULATION)

// The kernel's blocks and warps run one after another on the host, each warp
// with its 32 lanes stepped in turn between the exchange points.
extern "C" int hs_banded_fused_host(const int8_t* q, const int8_t* t, const int32_t* q_lens,
                                    const int32_t* t_lens, const int32_t* modes, int N, int B, int T,
                                    uint8_t* out) {
  if (B <= 0 || B % 16 != 0 || T < 0) return 1;
  std::vector<uint4> smem_words(WARPS * warp_smem_bytes(B) / 16);
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words.data());
  for (int block = 0; block * WARPS < N; ++block) {
    std::memset(smem, 0xAB, WARPS * warp_smem_bytes(B));  // nothing may rely on unstaged bytes
    for (int warp = 0; warp < WARPS; ++warp) {
      const int n = block * WARPS + warp;
      if (n >= N) continue;
      align_warp(B, T, q + static_cast<size_t>(n) * B, t + static_cast<size_t>(n) * T, q_lens[n], t_lens[n],
                 modes[n], smem + warp * warp_smem_bytes(B), out + static_cast<size_t>(n) * (HEADER + B));
    }
  }
  return 0;
}

// The walk alone, over a given backpointer plane bp [N, B, W] (0 diag, 1 up,
// 2 left) from given start cells: its class scratch is filled as the forward
// pass would fill it, so that the walk can be tested on planes and starts no
// alignment produces (a row without a non-LEFT cell at or below the walk, a
// start outside the band). toks [N, B]; start_i within [0, B].
extern "C" int hs_banded_walk_host(const uint8_t* bp, const int32_t* start_i, const int32_t* start_b,
                                   int N, int B, uint8_t* toks) {
  if (B <= 0 || B % 4 != 0) return 1;
  std::vector<uint32_t> cls32(static_cast<size_t>(B) * 8), tok32(B / 4);
  for (int n = 0; n < N; ++n) {
    if (start_i[n] < 0 || start_i[n] > B) return 1;
    for (int r = 0; r < B; ++r)
      for (int lane = 0; lane < 32; ++lane) {
        uint32_t cls = 0;
        for (int c = 0; c < CPL; ++c) {
          const uint8_t op = bp[(static_cast<size_t>(n) * B + r) * W + lane * CPL + c];
          cls |= (static_cast<uint32_t>(op == 0) << c) | (static_cast<uint32_t>(op == 1) << (hsb::UP_SHIFT + c));
        }
        uint32_t& word = cls32[(r >> 2) * 32 + lane];
        word = (word & ~(0xFFu << (8 * (r & 3)))) | (cls << (8 * (r & 3)));
      }
    std::fill(tok32.begin(), tok32.end(), 0u);
    walk_warp(cls32.data(), start_i[n], start_b[n], tok32.data());
    std::memcpy(toks + static_cast<size_t>(n) * B, tok32.data(), B);
  }
  return 0;
}

#else

// Launch on `stream`. Needs B a multiple of 16 and q and out 16-byte aligned.
// Returns 1 for a shape it does not take, else the launch's cudaGetLastError()
// (0 = launched).
extern "C" int hs_banded_fused(const int8_t* q, const int8_t* t, const int32_t* q_lens,
                               const int32_t* t_lens, const int32_t* modes, int N, int B, int T,
                               uint8_t* out, void* stream) {
  if (B <= 0 || B % 16 != 0 || T < 0) return 1;
  if (N <= 0) return 0;
  const size_t smem = WARPS * warp_smem_bytes(B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  banded_fused_kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, t, q_lens, t_lens, modes, N, B, T, out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of the fused kernel per SM at this chunk (for reports).
extern "C" int hs_banded_fused_occupancy(int B) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, banded_fused_kernel, WARPS * 32,
                                                WARPS * warp_smem_bytes(B));
  return blocks;
}

#endif
