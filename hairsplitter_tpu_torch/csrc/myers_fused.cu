// K1, main-path mode: the Myers bit-vector banded DP, the end-cell readout
// and the traceback walk in ONE kernel for Hopper (sm_90a).
//
// Replaces, on the main path, the Pallas TPU kernel `hairsplitter_tpu/ops/
// align_myers_pallas.py:_myers_kernel` together with the XLA programs the JAX
// package runs around it (`myers_word_readout`, `align_device.py:
// readout_device`, `traceback_scan_words`). From the code tensors q [N, B],
// t [N, T] and q_lens, t_lens, modes it writes the fused buffer
// uint8 [N, 16 + B] of `align_traceback_rows(kernel="myers")` byte for byte:
// int32 cost, clip, start_i, start_b, then one token `d | up << 7` per query
// row. The plain PyTorch version is `ops/align_device.py:
// myers_fused_plain`.
//
// What bounds it on this card: integer instructions, not bytes. A forward row
// is ~150 machine instructions per alignment (~200 with the column minimum
// of an extension job), a walked row ~70 on one dependent chain, against 2 B
// of input, 1 B of output and 32 B of scratch written and read back. An SM
// sub-partition issues one 32-wide integer instruction every two cycles, so
// the forward pass sets the time; the walk adds its latency, the scratch
// little as long as its stores fill whole sectors.
//
// What the design does about it:
//  * One thread owns one alignment for the whole kernel. P, M and the four
//    target-window planes live in its registers (`myers_common.cuh:myers_row`, the
//    recurrence shared with the check-mode kernel `myers_rows.cu`), and so do
//    the readout's running quantities: the band anchor score0, the running
//    minimum of the j == tlen column (earliest row wins ties) and, after the
//    last row, the extension row's first-index argmin and the corner. P and M
//    are never stored; the loop stops at row qlen.
//  * Only the nonleft / isup words reach device memory, in a scratch buffer
//    [B, N, 2, 4] that the same thread writes going forward and reads going
//    back. A lane's two words of a row fill one 32-byte sector of their own,
//    so a warp whose lanes have stopped at different rows (their queries
//    differ in length) still writes whole sectors: with the two streams in
//    separate buffers a lane wrote half a sector, and every sector whose
//    other half belonged to a finished lane cost a read-modify-write. A
//    warp's row is 1 KB contiguous in both directions. The walk
//    finds the nearest non-LEFT cell at or left of its band position with a
//    mask and `__clz`, and reads eight rows ahead of the one it is on (the
//    addresses do not depend on the walk), so the loads overlap.
//  * Inputs are staged once per block with `cp.async` (16 B per request)
//    straight from the mapper's [N, B] / [N, T] layout — no transposed copy.
//    Query rows get a 16-byte pad (stride B + 16), so the 16-byte reads of a
//    quarter warp fall on distinct banks; the thread reads 16 rows' codes per
//    shared-memory read. The target tile is copied flat (its rows are T = 319
//    bytes, odd, so lanes spread over the banks) and read as aligned words
//    realigned with a funnel shift, 4 codes per read.
//  * A block is one warp of 32 alignments with 18.5 KB of shared memory, so
//    8,192 jobs make 256 blocks (all 132 SMs busy) and up to 12 blocks fit an
//    SM; registers are not the limit at that occupancy.
//  * Tokens are packed 16 to a uint4 store; rows above start_i are zero.
//
// Codes: bases 0..3; anything else matches nothing. The target is read as if
// padded with dl sentinels on the left and sentinels past its width T.

#include <cstdint>
#include <cstring>

#if defined(HS_HOST_EMULATION)
#include <vector>
#endif

#include "myers_common.cuh"

namespace {

using hs::DL;
constexpr int W = 128;       // band cells
constexpr int ALN = 32;      // alignments (= threads) per block: one warp
constexpr int Q_PAD = 16;    // bytes of padding after a staged query row
constexpr int T_SLACK = 16;  // bytes readable past the staged target tile
constexpr int INF = 1 << 20;
constexpr int AHEAD = 8;     // rows the walk loads at once

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
#if defined(HS_HOST_EMULATION)
  std::memcpy(smem_dst, gmem_src, 16);
#else
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem_src) : "memory");
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if !defined(HS_HOST_EMULATION)
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
#endif
}

__host__ __device__ __forceinline__ size_t q_tile_bytes(int B) { return static_cast<size_t>(ALN) * (B + Q_PAD); }

// Thread `tid` of the block's ALN issues its share of the copies of the
// block's input tile: `rows` query rows into the padded layout, the target
// rows flat. Both tiles start 16-byte aligned (ALN rows of any width do).
__device__ __forceinline__ void stage_tile(int tid, int rows, const int8_t* q_tile, const int8_t* t_tile,
                                           int B, int T, uint8_t* sq, uint8_t* st) {
  const int q_chunks = B / 16;
  for (int c = tid; c < rows * q_chunks; c += ALN) {
    const int row = c / q_chunks, col = c - row * q_chunks;
    cp_async16(sq + row * (B + Q_PAD) + col * 16, q_tile + static_cast<size_t>(c) * 16);
  }
  const int t_bytes = rows * T;
  const int t_chunks = t_bytes / 16;
  for (int c = tid; c < t_chunks; c += ALN) cp_async16(st + c * 16, t_tile + static_cast<size_t>(c) * 16);
  const int tail = t_chunks * 16 + tid;  // the last, partial 16 bytes
  if (tail < t_bytes) st[tail] = static_cast<uint8_t>(t_tile[tail]);
}

// bits [1 .. b_col] of band word w (bit 0 of the band is the anchor itself)
__device__ __forceinline__ uint32_t prefix_mask(int b_col, int w) {
  const int off = b_col - 32 * w;
  uint32_t m = off < 0 ? 0u : (off >= 31 ? 0xFFFFFFFFu : ((2u << off) - 1u));
  if (w == 0) m &= 0xFFFFFFFEu;
  return m;
}

// What the forward pass carries from row to row beside the band state.
struct ForwardState {
  int rows;        // rows to step: min(qlen, B)
  int score0;      // C_i[0], the band's anchor cell
  int colmin_val;  // best cell of the j == tlen column (extension jobs only)
  int colmin_i;
};

// Sixteen query rows from r0 on (fewer at the end): one shared-memory read
// of the query codes and five of the target words, then per row the DP step,
// the two scratch stores and the readout's running quantities. EARLY as in
// `myers_row`: r0 < DL.
template <bool EARLY>
__device__ __forceinline__ void forward_chunk(hs::MyersState& s, ForwardState& f, int r0,
                                              const uint8_t* qrow, const uint32_t* tw, uint32_t t_shift,
                                              int T, int tlen, bool is_ext,
                                              uint4* tb_rows, size_t stride, int n) {
  const uint4 qv = *reinterpret_cast<const uint4*>(qrow + r0);
  const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
  const int k0 = (DL + r0) >> 2;
  uint32_t tc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) tc[m] = __funnelshift_r(tw[k0 + m], tw[k0 + m + 1], t_shift);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int r = r0 + k;
    if (r >= f.rows) break;
    const int i = r + 1;
    const int qc = static_cast<int>((qw[k >> 2] >> (8 * (k & 3))) & 0xFFu);
    const int inj = DL + r < T ? static_cast<int>((tc[k >> 2] >> (8 * (k & 3))) & 0xFFu) : 6;
    uint32_t nl[4], up[4];
    hs::myers_row<true, EARLY>(s, qc, inj, i, nl, up);
    const size_t o = 2 * (r * stride + n);  // the lane's own 32-byte sector of row r
    tb_rows[o] = make_uint4(nl[0], nl[1], nl[2], nl[3]);
    tb_rows[o + 1] = make_uint4(up[0], up[1], up[2], up[3]);
    f.score0 += 1 + static_cast<int>(s.P[0] & 1u) - static_cast<int>(s.M[0] & 1u);
    const int b_col = tlen - i + DL;
    if (is_ext && b_col >= 0 && b_col < W) {  // only an extension's end cell can lie on the column
      int v = f.score0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t m = prefix_mask(b_col, w);
        v += __popc(s.P[w] & m) - __popc(s.M[w] & m);
      }
      v = v < INF ? v : INF;
      if (v < f.colmin_val) {  // strict: the earliest row wins ties
        f.colmin_val = v;
        f.colmin_i = i;
      }
    }
  }
}

// The whole of one alignment: forward DP with the readout folded in, end-cell
// choice, backward walk. `lane` is the alignment's slot in the staged tile,
// `n` its index in the batch.
__device__ __forceinline__ void align_one(int lane, int n, int N, int B, int T,
                                          const uint8_t* sq, const uint8_t* st_tile,
                                          int qlen, int tlen, int mode,
                                          uint4* tb_rows, uint8_t* out) {
  const uint8_t* qrow = sq + lane * (B + Q_PAD);
  const int t_off = lane * T;
  const uint32_t t_shift = 8u * (t_off & 3);
  const uint32_t* tw = reinterpret_cast<const uint32_t*>(st_tile + (t_off & ~3));
  const size_t stride = static_cast<size_t>(N);

  hs::MyersState s;
  hs::myers_init(s);
#pragma unroll
  for (int k = 0; k < DL / 4; ++k) {
    const uint32_t c4 = __funnelshift_r(tw[k], tw[k + 1], t_shift);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 4 * k + m;
      hs::myers_seed_plane(s, j, j < T ? static_cast<int>((c4 >> (8 * m)) & 0xFFu) : 6);
    }
  }

  // ---- forward: rows 1 .. min(qlen, B)
  ForwardState f;
  f.rows = qlen < 0 ? 0 : (qlen > B ? B : qlen);
  f.score0 = DL;
  f.colmin_val = INF;
  f.colmin_i = 0;
  const bool is_ext = mode == 1;
  const int early_rows = f.rows < DL ? f.rows : DL;  // rows whose band reaches j <= 0
  for (int r0 = 0; r0 < early_rows; r0 += 16)
    forward_chunk<true>(s, f, r0, qrow, tw, t_shift, T, tlen, is_ext, tb_rows, stride, n);
  for (int r0 = DL; r0 < f.rows; r0 += 16)
    forward_chunk<false>(s, f, r0, qrow, tw, t_shift, T, tlen, is_ext, tb_rows, stride, n);
  const int score0 = f.score0, colmin_val = f.colmin_val, colmin_i = f.colmin_i;

  // ---- row i == qlen: corner cell and first-index argmin over 0 <= j <= tlen.
  // With qlen == 0 the initial P/M give row 0 itself (score j at j >= 0).
  const int b_corner = tlen - qlen + DL;
  int corner = INF, rowbest = INF, b_row = 0;
  if (qlen <= B) {
    const int b_lo = DL - qlen > 0 ? DL - qlen : 0;          // j >= 0
    const int b_hi = b_corner < W - 1 ? b_corner : W - 1;    // j <= tlen
    int run = score0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t pw = s.P[w], mw = s.M[w];
      if (w == 0) { pw &= 0xFFFFFFFEu; mw &= 0xFFFFFFFEu; }
      for (int bit = 0; bit < 32; ++bit) {
        const int b = 32 * w + bit;
        run += static_cast<int>((pw >> bit) & 1u) - static_cast<int>((mw >> bit) & 1u);
        const int v = run < INF ? run : INF;
        if (b >= b_lo && b <= b_hi && v < rowbest) {
          rowbest = v;
          b_row = b;
        }
        if (b == b_corner) corner = v;
      }
    }
  }

  // ---- end cell: global corner / extension row / target-exhausted column
  const bool use_col = is_ext && colmin_val < rowbest;
  const int cost = is_ext ? (rowbest < colmin_val ? rowbest : colmin_val) : corner;
  int start_i = use_col ? colmin_i : qlen;
  int start_b = use_col ? tlen - colmin_i + DL : (is_ext ? b_row : b_corner);
  int clip = use_col ? qlen - colmin_i : 0;
  if (cost >= INF) {  // unreachable end cell: empty walk
    start_i = 0;
    start_b = DL;
    clip = 0;
  }
  uint8_t* out_row = out + static_cast<size_t>(n) * (16 + B);
  *reinterpret_cast<uint4*>(out_row) =
      make_uint4(static_cast<uint32_t>(cost), static_cast<uint32_t>(clip),
                 static_cast<uint32_t>(start_i), static_cast<uint32_t>(start_b));

  // ---- backward: rows start_i .. 1, one token per row; rows above are 0
  int b = start_b;
  for (int g = B / 16 - 1; g >= 0; --g) {
    uint32_t tk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int half = 16 / AHEAD - 1; half >= 0; --half) {
      const int r_lo = 16 * g + AHEAD * half + 1;  // lowest row of this batch
      if (r_lo > start_i) continue;
      uint4 nlv[AHEAD], upv[AHEAD];
#pragma unroll
      for (int k = 0; k < AHEAD; ++k) {
        if (r_lo + k <= start_i) {
          const size_t o = 2 * ((r_lo + k - 1) * stride + n);
          nlv[k] = tb_rows[o];
          upv[k] = tb_rows[o + 1];
        } else {
          nlv[k] = make_uint4(0u, 0u, 0u, 0u);
          upv[k] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int k = AHEAD - 1; k >= 0; --k) {
        if (r_lo + k > start_i) continue;
        const uint32_t x0 = nlv[k].x & (b < 0 ? 0u : (b >= 31 ? 0xFFFFFFFFu : ((2u << b) - 1u)));
        const uint32_t x1 = nlv[k].y & (b < 32 ? 0u : (b >= 63 ? 0xFFFFFFFFu : ((2u << (b - 32)) - 1u)));
        const uint32_t x2 = nlv[k].z & (b < 64 ? 0u : (b >= 95 ? 0xFFFFFFFFu : ((2u << (b - 64)) - 1u)));
        const uint32_t x3 = nlv[k].w & (b < 96 ? 0u : (b >= 127 ? 0xFFFFFFFFu : ((2u << (b - 96)) - 1u)));
        // last non-zero word, then its highest set bit
        uint32_t xw = x0, uw = upv[k].x;
        int base = 0;
        if (x1) { xw = x1; uw = upv[k].y; base = 32; }
        if (x2) { xw = x2; uw = upv[k].z; base = 64; }
        if (x3) { xw = x3; uw = upv[k].w; base = 96; }
        int pos = 0, isup = 0;
        if (xw) {
          const int hsb = 31 - __clz(xw);
          pos = base + hsb;
          isup = static_cast<int>((uw >> hsb) & 1u);
        }
        const int d = b - pos > 0 ? b - pos : 0;
        const uint32_t tok = static_cast<uint32_t>((d | (isup << 7)) & 0xFF);
        const int idx = AHEAD * half + k;  // byte of this row within the 16-row group
        tk[idx >> 2] |= tok << (8 * (idx & 3));
        b = pos + isup;
      }
    }
    *reinterpret_cast<uint4*>(out_row + 16 + 16 * g) = make_uint4(tk[0], tk[1], tk[2], tk[3]);
  }
}

#if !defined(HS_HOST_EMULATION)

__global__ void __launch_bounds__(ALN) myers_fused_kernel(
    const int8_t* __restrict__ q,       // [N, B]
    const int8_t* __restrict__ t,       // [N, T]
    const int32_t* __restrict__ q_lens,
    const int32_t* __restrict__ t_lens,
    const int32_t* __restrict__ modes,
    int N, int B, int T,
    uint4* tb_rows,                     // scratch [B, N, 2] x 4 words, written then read back
    uint8_t* __restrict__ out) {        // [N, 16 + B]
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  uint8_t* st = smem + q_tile_bytes(B);
  const int base = blockIdx.x * ALN;
  const int rows = N - base < ALN ? N - base : ALN;
  stage_tile(threadIdx.x, rows, q + static_cast<size_t>(base) * B, t + static_cast<size_t>(base) * T,
             B, T, sq, st);
  cp_async_wait_all();
  __syncwarp();
  const int n = base + threadIdx.x;
  if (n >= N) return;
  align_one(threadIdx.x, n, N, B, T, sq, st, q_lens[n], t_lens[n], modes[n], tb_rows, out);
}

#endif

size_t smem_bytes(int B, int T) {
  const size_t t_tile = (static_cast<size_t>(ALN) * T + T_SLACK + 15) / 16 * 16;
  return q_tile_bytes(B) + t_tile;
}

}  // namespace

#if defined(HS_HOST_EMULATION)

// The kernel's blocks and threads run one after another on the host: every
// thread of a block stages, then every thread aligns.
extern "C" int hs_myers_fused_host(const int8_t* q, const int8_t* t, const int32_t* q_lens,
                                   const int32_t* t_lens, const int32_t* modes, int N, int B, int T,
                                   uint32_t* tb_rows, uint8_t* out) {
  if (B <= 0 || B % 16 != 0 || T < 0) return 1;
  std::vector<uint4> smem_words(smem_bytes(B, T) / 16);
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words.data());
  for (int base = 0; base < N; base += ALN) {
    std::memset(smem, 0xAB, smem_bytes(B, T));  // nothing may rely on unstaged bytes
    uint8_t* sq = smem;
    uint8_t* st = smem + q_tile_bytes(B);
    const int rows = N - base < ALN ? N - base : ALN;
    for (int tid = 0; tid < ALN; ++tid)
      stage_tile(tid, rows, q + static_cast<size_t>(base) * B, t + static_cast<size_t>(base) * T, B, T, sq, st);
    for (int tid = 0; tid < rows; ++tid) {
      const int n = base + tid;
      align_one(tid, n, N, B, T, sq, st, q_lens[n], t_lens[n], modes[n],
                reinterpret_cast<uint4*>(tb_rows), out);
    }
  }
  return 0;
}

#else

// Launch on `stream`. Needs B a multiple of 16 and q, t, the scratch and out
// 16-byte aligned. Returns 1 for a shape it does not take, else the launch's
// cudaGetLastError() (0 = launched).
extern "C" int hs_myers_fused(const int8_t* q, const int8_t* t, const int32_t* q_lens,
                              const int32_t* t_lens, const int32_t* modes, int N, int B, int T,
                              uint32_t* tb_rows, uint8_t* out, void* stream) {
  if (B <= 0 || B % 16 != 0 || T < 0) return 1;
  if (N <= 0) return 0;
  const size_t smem = smem_bytes(B, T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        myers_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  myers_fused_kernel<<<(N + ALN - 1) / ALN, ALN, smem, static_cast<cudaStream_t>(stream)>>>(
      q, t, q_lens, t_lens, modes, N, B, T, reinterpret_cast<uint4*>(tb_rows), out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of the fused kernel per SM at this shape (for reports).
extern "C" int hs_myers_fused_occupancy(int B, int T) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, myers_fused_kernel, ALN, smem_bytes(B, T));
  return blocks;
}

#endif
