// The CIGAR walk of every alignment of a job for Hopper (sm_90a): each
// alignment's pileup cells and insertion records, and the dense window
// blocks of stage 3, in ONE launch, a block per alignment.
//
// Replaces no Pallas kernel: the JAX package walks the CIGARs on the host
// (`hairsplitter_tpu/pipeline/pileup.py:alignment_cells_full` and
// `build_window_blocks`), and so does this package off the card, with its
// copies of those two functions; the kernel gives their results bit for bit.
// It was added because that walk, about ten numpy calls an alignment, ran
// twice a job (stage 3's window blocks, stage 5's per-read cells) while the
// card sat idle.
//
// What a block computes for its alignment, in the host code's terms:
//  * the CIGAR runs expanded; '=', 'X', 'M', 'S', 'H' consume a read base
//    and a contig position and record a cell, 'D' consumes a contig
//    position and records a GAP cell, 'I' consumes a read base and records
//    an insertion (before the contig position it stands at);
//  * the read's base codes in contig orientation: read as stored for strand
//    1, reverse-complemented (A<->T, C<->G, GAP and PAD kept) for strand 0,
//    gathered in place from the job's one buffer of forward codes; the
//    first query position is q_start (strand 1) or len - q_end (strand 0);
//  * a recorded cell's base is the read's at its query position clipped to
//    [0, len - 1]; its trimer is cur * 25 + prev1 * 5 + prev2 over the
//    previous two recorded bases, seeded with prev1 = 0 and prev2 = (0, 1)
//    for the first two cells, stored as int8 (codes above 127 wrap, as
//    numpy's astype does, when a read holds PAD bases); an alignment of one
//    cell stores two trimers, (cur * 25, cur * 25 + 1), as the host's
//    broadcast does; the central base is the int8 trimer floor-divided by 25;
//  * an insertion's contig position and its read base, at a query position
//    taken as numpy indexes (negative from the end); a position past the read
//    is flagged and raised by the host, as numpy raises;
//  * each cell at contig position p, 0 <= p < contig length, written into the
//    window block w = p / window at the alignment's row there, if it has one
//    (the host gives each (alignment, window) overlap its row, in
//    `build_window_blocks`' order); the launcher fills the blocks with
//    TRIMER_ABSENT first.
//
// Input: per alignment a record of int64 fields (the `A_*` indices); the
// job's CIGAR runs (op int8, length int32); the reads' codes one after
// another; the (alignment, window) rows. The host sizes every output from
// the runs: an alignment's cells, trimers and insertions start at offsets it
// computes, so no block waits on another.
//
// What bounds it on this card: neither bytes nor operations. A clonal30x job
// (some 800 alignments of 8 kb) reads 6 MB of codes and 6 MB of runs and
// writes some 12 MB of cells and 13 MB of blocks: about 11 us at 3.35 TB/s.
// Each block's runs are scanned a chunk at a time with barriers between the
// steps. What the design does about it:
//  * One block of 256 threads an alignment; its runs come in chunks of 256,
//    one a thread, and three block scans give each run its recorded-cell,
//    query and insertion offsets within the alignment.
//  * A chunk's cells are expanded in tiles of 1,024: each thread finds its
//    cells' runs by binary search over the chunk's offsets in shared memory
//    and puts their bases in a shared tile, which carries the last two bases
//    of the previous tile for the trimer context; the trimers, the central
//    bases and the block cells are then written by consecutive threads.
//  * An insertion run is written by its thread (runs of 'I' are short).

#include <cstdint>
#include <cstring>

#include "host_emulation.cuh"

namespace {

constexpr int NT = 256;        // threads of a block (= runs of a chunk)
constexpr int TILE = 4 * NT;   // cells expanded between two barriers
constexpr int OP_I = 2;        // io/cigar.py: OPS = "=XIDMSH"
constexpr int OP_D = 3;
constexpr int GAP_CODE = 4;
constexpr int8_t ABSENT = 127;  // TRIMER_ABSENT

// the fields of an alignment's int64 record
enum {
  A_READ_OFF = 0,  // first code of its read in the codes buffer
  A_READ_LEN,      // the read's length
  A_STRAND,        // 1 forward, 0 reverse
  A_Q_START,       // forward-read coordinates of the aligned part
  A_Q_END,
  A_T_START,       // first contig position
  A_RUN_OFF,       // first run in the runs buffers
  A_N_RUNS,
  A_N_CELLS,       // recorded cells
  A_TRI_OFF,       // first trimer (and central base) in the outputs
  A_INS_OFF,       // first insertion record in the outputs
  A_CONTIG_LEN,
  A_WIN_LO,        // first window block the alignment has a row in
  A_WIN_CNT,       // window blocks it has a row in (0: no blocks)
  A_SLOT_OFF,      // its first row index in the rows buffer
  NF = 16
};

struct Params {
  const int64_t* alns;   // [n, NF]
  const int8_t* ops;     // runs' ops
  const int32_t* lens;   // runs' lengths
  const int8_t* codes;   // reads' forward codes
  const int64_t* slots;  // (alignment, window) -> row of the flat blocks
  int64_t window;
  int8_t* blocks;        // [rows, window], filled with ABSENT by the launcher
  int8_t* tri;           // trimer codes
  int8_t* central;       // trimer // 25
  int64_t* ins_t;        // insertions' contig positions
  int8_t* ins_c;         // insertions' read bases
  unsigned long long* err;  // smallest alignment with an insertion past its read (~0: none)
};

struct Shared {
  int32_t rec[NT];  // recorded cells before each run of the chunk (exclusive scan)
  int32_t q[NT];    // query bases before each run
  int32_t ins[NT];  // insertion records before each run
  int32_t len[NT];
  int8_t op[NT];    // -1 past the alignment's runs
  int32_t wtot[NT / 32 + 1];
  int32_t base[3];  // cells, query bases and insertions of the chunks before
  int8_t cur[TILE + 2];  // [0], [1]: the two bases before the tile
};

// A block's work is a sequence of phases separated by barriers. On the card
// every thread runs each phase once with its own tid; in the host build the
// threads run a phase one after another. Values that live from one phase to
// the next are kept in shared memory, never in a thread's locals; code
// between phases is the same for every thread and writes nothing.
#if defined(HS_HOST_EMULATION)
#define PHASE for (int tid = 0; tid < NT; ++tid)
#define SYNC() ((void)0)

inline void flag_error(unsigned long long* err, unsigned long long a) {
  if (a < *err) *err = a;
}

// exclusive prefix sums of v[0, NT) in place; returns their total
inline int32_t block_exclusive_scan(int32_t* v, int32_t*) {
  int32_t run = 0;
  for (int i = 0; i < NT; ++i) {
    const int32_t x = v[i];
    v[i] = run;
    run += x;
  }
  return run;
}
#else
#define PHASE for (int tid = threadIdx.x, once_ = 1; once_; once_ = 0)
#define SYNC() __syncthreads()

__device__ __forceinline__ void flag_error(unsigned long long* err, unsigned long long a) { atomicMin(err, a); }

__device__ int32_t block_exclusive_scan(int32_t* v, int32_t* wtot) {
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int32_t x = v[tid];
  int32_t inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wtot[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const int32_t t = lane < NW ? wtot[lane] : 0;
    int32_t ti = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < NW) wtot[lane] = ti - t;
    if (lane == NW - 1) wtot[NW] = ti;
  }
  __syncthreads();
  v[tid] = inc - x + wtot[wid];
  const int32_t total = wtot[NW];
  __syncthreads();
  return total;
}
#endif

// The read's base at oriented position q (0 <= q < len).
__device__ __forceinline__ int8_t base_at(const int8_t* read, int64_t len, int strand, int64_t q) {
  if (strand == 1) return read[q];
  const int8_t c = read[len - 1 - q];
  return c < 4 ? static_cast<int8_t>(3 - c) : c;
}

// numpy's floor division of an int8 trimer by 25
__device__ __forceinline__ int8_t central_of(int8_t t) {
  const int v = t;
  int d = v / 25;
  if (v % 25 != 0 && v < 0) --d;
  return static_cast<int8_t>(d);
}

__device__ __forceinline__ int8_t as_int8(int v) { return static_cast<int8_t>(static_cast<uint8_t>(v & 0xFF)); }

__device__ void walk_alignment(const Params& P, Shared& S, int64_t a) {
  const int64_t* rec = P.alns + a * NF;
  const int8_t* read = P.codes + rec[A_READ_OFF];
  const int64_t qlen = rec[A_READ_LEN];
  const int strand = static_cast<int>(rec[A_STRAND]);
  const int64_t q0 = strand == 1 ? rec[A_Q_START] : qlen - rec[A_Q_END];
  const int64_t t_start = rec[A_T_START];
  const int64_t run_off = rec[A_RUN_OFF], n_runs = rec[A_N_RUNS], n_cells = rec[A_N_CELLS];
  const int64_t tri_off = rec[A_TRI_OFF], ins_off = rec[A_INS_OFF], contig_len = rec[A_CONTIG_LEN];
  const int64_t win_lo = rec[A_WIN_LO], win_cnt = rec[A_WIN_CNT], slot_off = rec[A_SLOT_OFF];
  const int64_t W = P.window;

  PHASE {
    if (tid < 3) S.base[tid] = 0;
  }
  SYNC();
  for (int64_t c0 = 0; c0 < n_runs; c0 += NT) {
    PHASE {
      const int64_t r = c0 + tid;
      int op = -1, len = 0;
      if (r < n_runs) {
        op = P.ops[run_off + r];
        len = P.lens[run_off + r];
      }
      S.op[tid] = static_cast<int8_t>(op);
      S.len[tid] = len;
      S.rec[tid] = (op >= 0 && op != OP_I) ? len : 0;
      S.q[tid] = (op >= 0 && op != OP_D) ? len : 0;
      S.ins[tid] = op == OP_I ? len : 0;
    }
    SYNC();
    const int32_t chunk_cells = block_exclusive_scan(S.rec, S.wtot);
    const int32_t chunk_q = block_exclusive_scan(S.q, S.wtot);
    const int32_t chunk_ins = block_exclusive_scan(S.ins, S.wtot);
    const int64_t rb = S.base[0], qb = S.base[1], ib = S.base[2];

    // this chunk's insertions, a run a thread
    PHASE {
      if (S.op[tid] == OP_I) {
        const int64_t t = t_start + rb + S.rec[tid];
        const int64_t first = ins_off + ib + S.ins[tid];
        for (int32_t k = 0; k < S.len[tid]; ++k) {
          int64_t qp = q0 + qb + S.q[tid] + k;
          if (qp < 0) qp += qlen;
          P.ins_t[first + k] = t;
          if (qp < 0 || qp >= qlen) {
            flag_error(P.err, static_cast<unsigned long long>(a));
            P.ins_c[first + k] = 0;
          } else {
            P.ins_c[first + k] = base_at(read, qlen, strand, qp);
          }
        }
      }
    }

    // this chunk's recorded cells, a tile at a time
    for (int32_t t0 = 0; t0 < chunk_cells; t0 += TILE) {
      const int32_t tn = chunk_cells - t0 < TILE ? chunk_cells - t0 : TILE;
      PHASE {
        for (int32_t i = tid; i < tn; i += NT) {
          const int32_t jj = t0 + i;
          int lo = 0, hi = NT;  // the last run whose first cell is at or before jj
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (S.rec[mid] <= jj) lo = mid + 1; else hi = mid;
          }
          const int k = lo - 1;
          int8_t cur;
          if (S.op[k] == OP_D) {
            cur = GAP_CODE;
          } else {
            int64_t qp = q0 + qb + S.q[k] + (jj - S.rec[k]);
            qp = qp < 0 ? 0 : (qp > qlen - 1 ? qlen - 1 : qp);
            cur = base_at(read, qlen, strand, qp);
          }
          S.cur[2 + i] = cur;
        }
      }
      SYNC();
      PHASE {
        for (int32_t i = tid; i < tn; i += NT) {
          const int64_t j = rb + t0 + i;  // the cell's index in the alignment
          const int c = S.cur[2 + i];
          const int p1 = j >= 1 ? S.cur[1 + i] : 0;
          const int p2 = j >= 2 ? S.cur[i] : (j == 1 ? 1 : 0);
          const int8_t t = as_int8(c * 25 + p1 * 5 + p2);
          P.tri[tri_off + j] = t;
          P.central[tri_off + j] = central_of(t);
          if (n_cells == 1) {  // the host's broadcast of one cell against the (0, 1) seeds
            const int8_t t1 = as_int8(c * 25 + 1);
            P.tri[tri_off + 1] = t1;
            P.central[tri_off + 1] = central_of(t1);
          }
          const int64_t tpos = t_start + j;
          if (win_cnt > 0 && tpos >= 0 && tpos < contig_len) {
            const int64_t w = tpos / W;
            if (w >= win_lo && w < win_lo + win_cnt) {
              const int64_t row = P.slots[slot_off + (w - win_lo)];
              P.blocks[row * W + (tpos - w * W)] = t;
            }
          }
        }
      }
      SYNC();
      PHASE {
        if (tid == 0) {  // the tile's last two bases (cells tn - 2 and tn - 1) carry over
          const int8_t x0 = S.cur[tn], x1 = S.cur[tn + 1];
          S.cur[0] = x0;
          S.cur[1] = x1;
        }
      }
      SYNC();
    }
    SYNC();
    PHASE {
      if (tid == 0) {
        S.base[0] += chunk_cells;
        S.base[1] += chunk_q;
        S.base[2] += chunk_ins;
      }
    }
    SYNC();
  }
}

#if !defined(HS_HOST_EMULATION)

__global__ void __launch_bounds__(NT) pileup_cells_kernel(Params P) {
  __shared__ Shared S;
  walk_alignment(P, S, blockIdx.x);
}

#endif

Params make_params(const int64_t* alns, const int8_t* ops, const int32_t* lens, const int8_t* codes,
                   const int64_t* slots, int64_t window, int8_t* blocks, int8_t* tri, int8_t* central,
                   int64_t* ins_t, int8_t* ins_c, int64_t* err) {
  Params P;
  P.alns = alns;
  P.ops = ops;
  P.lens = lens;
  P.codes = codes;
  P.slots = slots;
  P.window = window;
  P.blocks = blocks;
  P.tri = tri;
  P.central = central;
  P.ins_t = ins_t;
  P.ins_c = ins_c;
  P.err = reinterpret_cast<unsigned long long*>(err);
  return P;
}

}  // namespace

#if defined(HS_HOST_EMULATION)

// The kernel's blocks and threads run one after another on the host; a
// block's shared memory starts as garbage, as on the card.
extern "C" int hs_pileup_cells_host(const int64_t* alns, int64_t n, const int8_t* ops, const int32_t* lens,
                                    const int8_t* codes, const int64_t* slots, int64_t window, int8_t* blocks,
                                    int64_t block_bytes, int8_t* tri, int8_t* central, int64_t* ins_t,
                                    int8_t* ins_c, int64_t* err) {
  if (n < 0 || window < 0 || block_bytes < 0) return 1;
  const Params P = make_params(alns, ops, lens, codes, slots, window, blocks, tri, central, ins_t, ins_c, err);
  std::memset(blocks, ABSENT, static_cast<size_t>(block_bytes));
  std::memset(err, 0xFF, sizeof(int64_t));
  Shared S;
  for (int64_t a = 0; a < n; ++a) {
    std::memset(&S, 0xAB, sizeof(S));
    walk_alignment(P, S, a);
  }
  return 0;
}

#else

// Fill the blocks with TRIMER_ABSENT and the error word with ~0, then launch
// on `stream`. Returns 1 for arguments it does not take, else the launch's
// cudaGetLastError() (0 = launched).
extern "C" int hs_pileup_cells(const int64_t* alns, int64_t n, const int8_t* ops, const int32_t* lens,
                               const int8_t* codes, const int64_t* slots, int64_t window, int8_t* blocks,
                               int64_t block_bytes, int8_t* tri, int8_t* central, int64_t* ins_t, int8_t* ins_c,
                               int64_t* err, void* stream) {
  if (n < 0 || n > 0x7FFFFFFF || window < 0 || block_bytes < 0) return 1;
  const Params P = make_params(alns, ops, lens, codes, slots, window, blocks, tri, central, ins_t, ins_c, err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (block_bytes > 0) e = cudaMemsetAsync(blocks, ABSENT, static_cast<size_t>(block_bytes), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(err, 0xFF, sizeof(int64_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n == 0) return 0;
  pileup_cells_kernel<<<static_cast<unsigned>(n), NT, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

#endif
