// Seeding and chaining for Hopper (sm_90a): every read of a batch, from its
// base codes to its accepted chains, in ONE launch, a block per read.
//
// Replaces no Pallas kernel: seeding and chaining are host numpy and C++ in
// the JAX package too (`hairsplitter_tpu/core/seeding.py`). The host route of
// this package, `core/seeding.py:find_chains_batch` over the native
// `hs_minimizers`, `hs_index_lookup`, `hs_chain_sweep` and `hs_lis_monotonic`
// of `csrc/hs_native.cpp`, is this kernel's twin: the kernel gives its chains
// bit for bit. It was added because that host work, latency-bound binary
// searches, serial rolling minimizers and per-read Python glue under the GIL,
// took a fifth of a job while the card sat idle.
//
// What a block computes for its read (the host route's steps, in its order):
//  1. minimizers: each k-mer position's hash mix64(min(fwd, rc)), the maximum
//     where a base > 3 lies in the k-mer or fwd == rc; strand rc < fwd; the
//     leftmost minimum of every window of w positions (of all positions when
//     there are at most w), each distinct one once, unless its hash is the
//     maximum;
//  2. lookup: each minimizer's hits by binary search in the index's sorted
//     hashes, none for a hash with more than max_occ entries, in (minimizer,
//     index) order; with an allowed contig, hits on other contigs dropped;
//  3. grouping: hits sorted by (contig, match strand, target position, hit
//     order), so that each (contig, strand) group is the host's stable sort
//     by target position; a group under min_anchors hits is skipped;
//  4. per group the sweep that breaks where the target jumps more than 5,000
//     or the diagonal drifts more than 500 from its running reference
//     ((ref * 3 + d) // 4, floor division), then per segment the patience LIS
//     on the oriented read position (lower bound, strict replacement), the
//     anchors that do not rise strictly in both positions dropped, and the
//     segments under min_anchors dropped;
//  5. per read the candidates by descending anchor count (stable), the
//     min_score_frac cut on the best, and the max_overlap_frac test against
//     the merged read intervals already taken, in the host's order.
//
// Input: every read's codes one after another (homopolymer-compressed with
// each compressed base's original offset beside it when the index is), the
// reads' offsets and original lengths, optionally one allowed contig a read;
// the index as four arrays sorted by hash. Output, in one buffer: totals, a
// (first chain, chain count) pair a read, a (contig, strand, anchor count,
// first anchor) record a chain and the (q, t) anchors. Sizes: a read's hits
// are counted first and reserve a region of the scratch, and each read
// reserves its chains and anchors in the output, by atomic adds; the host
// sizes the scratch from an estimate, and when the reads' hits do not fit
// the totals say how many there are and the host launches again with that
// size. A read's anchors are distinct hits, so an output sized by the
// scratch always holds them; a result that still does not fit is flagged
// and raised by the host, never cut.
//
// What bounds it on this card: neither bytes nor operations. A clonal30x job
// (808 reads, 6 Mbp) reads 6 MB of codes and a 0.6 MB index and does some
// 200 M integer operations, about 13 us at the card's rates; the time goes
// to the serial parts of a read (the sweep, each segment's LIS and the final
// filter run on one thread) and to the block's barriers. What the design
// does about it:
//  * One block of 256 threads a read; a tile of 1,024 positions (4
//    consecutive a thread, rolled from one k-mer) holds its hashes and the
//    window halo in shared memory; the window minima, lookups and hit writes
//    are spread over the threads, with block scans placing each hit.
//  * A read's hits are sorted by a bitonic network over (key, hit index),
//    in shared memory up to 2,048 hits, else in the read's scratch.
//  * The LIS appends in one compare while the anchors rise, the usual case;
//    segments go to the threads in parallel.
//  * A block takes 43 KB of shared memory at w = 10, so an SM holds 5 and
//    a clonal30x job's 808 reads fill the card in some 1.2 waves.

#include <cstdint>
#include <cstring>
#include <vector>

#include "host_emulation.cuh"

namespace {

constexpr int NT = 256;         // threads of a block
constexpr int TILE = 4 * NT;    // read positions of a tile, 4 consecutive a thread
constexpr int SORT_SH = 2048;   // hits a block sorts in shared memory
constexpr int64_t MAX_GAP = 5000;   // chain_anchors' max_gap
constexpr int64_t MAX_DIAG = 500;   // chain_anchors' max_diag_diff
constexpr uint64_t MAXU = ~0ULL;
constexpr int N_I32 = 16;       // int32 scratch arrays, each one slot a hit

// totals of the result (uint64 each)
enum { T_HITS = 0, T_ANCHORS, T_CHAINS, T_READS, T_OVERFLOW, N_TOTALS = 8 };
// a block's shared scalars (int64 each)
enum { S_BASE = 0, S_RUN, S_NSEG, S_NKEPT, S_ABASE, N_SCALARS = 8 };

struct Params {
  const int8_t* codes;      // every read's codes, one after another
  const int64_t* read_off;  // [n_reads + 1] into codes
  const int32_t* qlen;      // [n_reads] original read lengths
  const int32_t* orig;      // [codes] original offset of each compressed base, or null
  const int32_t* allowed;   // [n_reads] allowed contig (-1: any), or null
  const uint64_t* ih;       // [n_index] index hashes, sorted
  const int32_t* ipos;      // [n_index] their contig positions
  const int32_t* icid;      // [n_index] their contig ids
  const int8_t* istr;       // [n_index] their strands
  int64_t n_index;
  int k, w, max_occ, min_anchors;
  double min_score_frac, max_overlap_frac;
  int64_t cap_hits, cap_chains;
  // scratch, one slot a hit; a read owns the slots [base, base + its hits)
  uint64_t* g_key;          // hit sort keys, for reads whose hits pass SORT_SH
  uint32_t* g_val;          // their hit indices
  int32_t* hq;              // oriented read position, in hit order
  int32_t* qs;              // oriented read position, in sorted order
  int32_t* ts;              // target position, in sorted order
  int32_t* cm;              // contig * 2 + match strand, in sorted order
  int32_t* tq;              // LIS pile tops (q)
  int32_t* ti;              // LIS pile tops (index)
  int32_t* par;             // LIS parents
  int32_t* lis;             // each segment's chain, as offsets into the segment
  int32_t* seg_start;       // segments: first sorted hit
  int32_t* seg_cnt;         // segments: end, then chain length
  int32_t* cand;            // candidate segments, best first
  int32_t* cov[4];          // merged read intervals taken (two buffers of a, b)
  int32_t* kept;            // segments kept, in order
  // result
  unsigned long long* totals;  // [N_TOTALS]
  int32_t* hdr;             // [n_reads, 2] first chain, chain count
  int32_t* chains;          // [cap_chains, 4] contig, strand, anchor count, first anchor
  int32_t* anchors;         // [cap_hits, 2] q, t
};

struct Smem {
  int64_t* sc;     // [N_SCALARS]
  uint64_t* h;     // [TILE + 2 (w - 1)] hashes of the tile's positions and halo
  uint64_t* key;   // [SORT_SH]
  uint32_t* val;   // [SORT_SH]
  int32_t* cnt;    // [TILE] window-minimum flags, then hits a position
  int32_t* lo;     // [TILE] first index entry of each minimizer's hash
  int32_t* scan;   // [NT]
  int32_t* wtot;   // [NT / 32 + 1]
  int8_t* str;     // [TILE + 2 (w - 1)] strands of the tile's positions
};

__host__ __device__ inline int64_t halo_len(int w) { return TILE + 2 * static_cast<int64_t>(w - 1); }

__host__ __device__ inline int64_t smem_bytes(int w) {
  const int64_t b = 8 * (N_SCALARS + halo_len(w) + SORT_SH) + 4 * (SORT_SH + 2 * TILE + NT + NT / 32 + 1) +
                    halo_len(w);
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline Smem carve(unsigned char* base, int w) {
  Smem s;
  s.sc = reinterpret_cast<int64_t*>(base);
  s.h = reinterpret_cast<uint64_t*>(s.sc + N_SCALARS);
  s.key = s.h + halo_len(w);
  s.val = reinterpret_cast<uint32_t*>(s.key + SORT_SH);
  s.cnt = reinterpret_cast<int32_t*>(s.val + SORT_SH);
  s.lo = s.cnt + TILE;
  s.scan = s.lo + TILE;
  s.wtot = s.scan + NT;
  s.str = reinterpret_cast<int8_t*>(s.wtot + NT / 32 + 1);
  return s;
}

template <typename T>
__host__ __device__ __forceinline__ T lmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__host__ __device__ __forceinline__ T lmax(T a, T b) { return a < b ? b : a; }

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Python's // by 4
__device__ __forceinline__ int64_t floordiv4(int64_t x) { return x >= 0 ? x / 4 : -((-x + 3) / 4); }

// first i in [lo, hi) with a[i] >= v (hi if none)
__device__ __forceinline__ int64_t lower_bound(const uint64_t* a, int64_t lo, int64_t hi, uint64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first i in [lo, hi) with a[i] > v (hi if none)
__device__ __forceinline__ int64_t upper_bound(const uint64_t* a, int64_t lo, int64_t hi, uint64_t v) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A block's work is a sequence of phases separated by barriers. On the card
// every thread runs each phase once with its own tid; in the host build the
// threads run a phase one after another. Values that live from one phase to
// the next are kept in shared or scratch memory, never in a thread's locals;
// code between phases is the same for every thread and writes nothing.
#if defined(HS_HOST_EMULATION)
#define PHASE for (int tid = 0; tid < NT; ++tid)
#define SYNC() ((void)0)

inline unsigned long long atomic_add(unsigned long long* p, unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
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

__device__ __forceinline__ unsigned long long atomic_add(unsigned long long* p, unsigned long long v) {
  return atomicAdd(p, v);
}

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

// Hashes and strands of the positions [lo, hi) of a tile into S.h / S.str
// (at p - lo), then the window minima of the tile's windows flagged in S.cnt.
__device__ __forceinline__ void tile_minimizers(const Params& P, const Smem& S, const int8_t* codes,
                                                          int m, int s, int lo, int hi) {
  const int k = P.k, w = P.w;
  const uint64_t mask = k >= 32 ? MAXU : ((1ULL << (2 * k)) - 1);
  PHASE {
    for (int c0 = lo + 4 * tid; c0 < hi; c0 += 4 * NT) {
      const int c1 = lmin(c0 + 4, hi);
      uint64_t fwd = 0, rc = 0;
      int last_bad = -1;
      for (int i = c0; i < c1 + k - 1; ++i) {
        uint64_t c = static_cast<uint8_t>(codes[i]);
        if (c > 3) {
          last_bad = i;
          c &= 3ULL;
        }
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((3ULL - c) << (2 * (k - 1)));
        const int p = i - k + 1;
        if (p >= c0) {
          S.h[p - lo] = (last_bad >= p || fwd == rc) ? MAXU : mix64(lmin(fwd, rc));
          S.str[p - lo] = static_cast<int8_t>(rc < fwd);
        }
      }
    }
    for (int i = tid; i < TILE; i += NT) S.cnt[i] = 0;
  }
  SYNC();
  PHASE {
    // window j covers [j, min(j + w, m)); there is one window when m <= w
    const int jhi = lmin(s + TILE - 1, lmax(0, m - w));
    for (int j = lmax(0, s - w + 1) + tid; j <= jhi; j += NT) {
      const int e = lmin(j + w, m);
      int best = j;
      uint64_t bv = S.h[j - lo];
      for (int p = j + 1; p < e; ++p) {
        const uint64_t v = S.h[p - lo];
        if (v < bv) {
          bv = v;
          best = p;
        }
      }
      if (best >= s && best < s + TILE) S.cnt[best - s] = 1;
    }
  }
  SYNC();
}

// The hits of each of the thread's 4 positions of the tile into S.cnt (0 for
// a position that is no minimizer, has the maximum hash, no entry or more than
// max_occ), the first index entry into S.lo; their sum added to S.scan[tid]
// (pass 1) or written there (pass 2).
__device__ __forceinline__ void tile_counts(const Params& P, const Smem& S, int m, int s, int lo,
                                                      int allowed, bool accumulate) {
  PHASE {
    int32_t sum = 0;
    for (int i = 4 * tid; i < 4 * tid + 4; ++i) {
      const int p = s + i;
      int32_t c = 0;
      if (p < m && S.cnt[i]) {
        const uint64_t hv = S.h[p - lo];
        if (hv != MAXU) {
          const int64_t a = lower_bound(P.ih, 0, P.n_index, hv);
          if (a < P.n_index && P.ih[a] == hv) {
            const int64_t e = upper_bound(P.ih, a, lmin(P.n_index, a + P.max_occ + 1), hv);
            if (e - a <= P.max_occ) {
              if (allowed < 0) {
                c = static_cast<int32_t>(e - a);
              } else {
                for (int64_t x = a; x < e; ++x) c += P.icid[x] == allowed;
              }
            }
            S.lo[i] = static_cast<int32_t>(a);
          }
        }
      }
      S.cnt[i] = c;
      sum += c;
    }
    if (accumulate) S.scan[tid] += sum; else S.scan[tid] = sum;
  }
  SYNC();
}

__device__ __forceinline__ bool hit_greater(uint64_t ka, uint32_t va, uint64_t kb, uint32_t vb) {
  return ka > kb || (ka == kb && va > vb);
}

__device__ __forceinline__ void cmp_swap(uint64_t* key, uint32_t* val, int64_t i, int64_t l) {
  if (hit_greater(key[i], val[i], key[l], val[l])) {
    const uint64_t kt = key[i];
    key[i] = key[l];
    key[l] = kt;
    const uint32_t vt = val[i];
    val[i] = val[l];
    val[l] = vt;
  }
}

// Sorts (key, val)[0, n) ascending: a bitonic network over the next power of
// two whose comparisons all put the smaller element first, so that the
// missing elements past n act as a maximum that never moves.
__device__ __forceinline__ void block_sort(uint64_t* key, uint32_t* val, int64_t n) {
  int64_t npad = 1;
  while (npad < n) npad <<= 1;
  for (int64_t kk = 2; kk <= npad; kk <<= 1) {
    const int64_t half = kk >> 1;
    PHASE {
      for (int64_t t = tid; t < npad / 2; t += NT) {
        const int64_t i = 2 * t - (t & (half - 1));
        const int64_t l = i ^ (kk - 1);
        if (l < n) cmp_swap(key, val, i, l);
      }
    }
    SYNC();
    for (int64_t j = half >> 1; j > 0; j >>= 1) {
      PHASE {
        for (int64_t t = tid; t < npad / 2; t += NT) {
          const int64_t i = 2 * t - (t & (j - 1));
          const int64_t l = i + j;
          if (l < n) cmp_swap(key, val, i, l);
        }
      }
      SYNC();
    }
  }
}

// The chain of segment x (sorted hits [s0, s0 + n)): patience LIS on q with
// lower-bound placement and strict replacement, read back from the last
// pile, then the anchors that do not rise strictly in both q and t dropped.
// Writes the chain as offsets into the segment at lis[s0...]; returns its
// length.
__device__ __forceinline__ int32_t segment_chain(const Params& P, int64_t base, int32_t s0, int32_t n) {
  const int32_t* Q = P.qs + base + s0;
  const int32_t* T = P.ts + base + s0;
  int32_t* tq = P.tq + base + s0;
  int32_t* ti = P.ti + base + s0;
  int32_t* par = P.par + base + s0;
  int32_t* out = P.lis + base + s0;
  int32_t len = 0;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t v = Q[i];
    int32_t j;
    if (len == 0 || tq[len - 1] < v) {
      j = len;
    } else {
      int32_t lo = 0, hi = len - 1;
      while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (tq[mid] < v) lo = mid + 1; else hi = mid;
      }
      j = lo;
    }
    par[i] = j > 0 ? ti[j - 1] : -1;
    if (j == len) {
      tq[len] = v;
      ti[len] = i;
      ++len;
    } else if (v < tq[j]) {
      tq[j] = v;
      ti[j] = i;
    }
  }
  for (int32_t cur = ti[len - 1], pos = len - 1; cur >= 0; cur = par[cur], --pos) out[pos] = cur;
  int32_t keep = 1, prev = out[0];
  for (int32_t i = 1; i < len; ++i) {
    const int32_t c = out[i];
    if (Q[c] > Q[prev] && T[c] > T[prev]) out[keep++] = c;
    prev = c;
  }
  return keep;
}

// Read r, by one block. Smem S holds garbage on entry.
__device__ __forceinline__ void read_body(const Params& P, const Smem& S, int r) {
  const int64_t off = P.read_off[r];
  const int n = static_cast<int>(P.read_off[r + 1] - off);
  const int8_t* codes = P.codes + off;
  const int k = P.k, w = P.w;
  const int m = n - k + 1;  // k-mer positions
  const int64_t qlen = P.qlen[r];
  const int allowed = P.allowed ? P.allowed[r] : -1;
  const int n_tiles = m > 0 ? (m + TILE - 1) / TILE : 0;

  // pass 1: the read's hits
  PHASE { S.scan[tid] = 0; }
  SYNC();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile * TILE;
    const int lo = lmax(0, s - (w - 1)), hi = lmin(m, s + TILE + w - 1);
    tile_minimizers(P, S, codes, m, s, lo, hi);
    tile_counts(P, S, m, s, lo, allowed, true);
  }
  const int32_t H = block_exclusive_scan(S.scan, S.wtot);
  PHASE {
    if (tid == 0) S.sc[S_BASE] = static_cast<int64_t>(atomic_add(P.totals + T_HITS, H));
    if (tid == 0) S.sc[S_RUN] = 0;
  }
  SYNC();
  const int64_t base = S.sc[S_BASE];
  if (H == 0 || base + H > P.cap_hits) {
    // nothing to chain, or the scratch is too small: the host launches again
    // with the total of T_HITS, and this read does not count as done
    PHASE {
      if (tid == 0) {
        P.hdr[2 * r] = 0;
        P.hdr[2 * r + 1] = 0;
        if (H == 0) atomic_add(P.totals + T_READS, 1);
      }
    }
    return;
  }
  uint64_t* key = H <= SORT_SH ? S.key : P.g_key + base;
  uint32_t* val = H <= SORT_SH ? S.val : P.g_val + base;

  // pass 2: the hits, in (minimizer, index) order
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile * TILE;
    const int lo = lmax(0, s - (w - 1)), hi = lmin(m, s + TILE + w - 1);
    tile_minimizers(P, S, codes, m, s, lo, hi);
    tile_counts(P, S, m, s, lo, allowed, false);
    const int32_t tile_hits = block_exclusive_scan(S.scan, S.wtot);
    PHASE {
      int64_t j = S.sc[S_RUN] + S.scan[tid];
      for (int i = 4 * tid; i < 4 * tid + 4; ++i) {
        if (S.cnt[i] == 0) continue;
        const int p = s + i;
        const uint64_t hv = S.h[p - lo];
        const int rstr = S.str[p - lo];
        const int64_t rpos = P.orig ? P.orig[off + p] : p;
        for (int64_t a = S.lo[i]; a < P.n_index && P.ih[a] == hv; ++a) {
          const int cid = P.icid[a];
          if (allowed >= 0 && cid != allowed) continue;
          const int ms = rstr != P.istr[a];
          key[j] = (static_cast<uint64_t>(cid) << 33) | (static_cast<uint64_t>(ms) << 32) |
                   static_cast<uint32_t>(P.ipos[a]);
          val[j] = static_cast<uint32_t>(j);
          P.hq[base + j] = static_cast<int32_t>(ms == 0 ? rpos : qlen - k - rpos);
          ++j;
        }
      }
    }
    SYNC();
    PHASE {
      if (tid == 0) S.sc[S_RUN] += tile_hits;
    }
    SYNC();
  }

  // grouping: sorted by (contig, match strand, target position, hit order)
  block_sort(key, val, H);
  PHASE {
    for (int32_t x = tid; x < H; x += NT) {
      const uint64_t kv = key[x];
      P.qs[base + x] = P.hq[base + val[x]];
      P.ts[base + x] = static_cast<int32_t>(static_cast<uint32_t>(kv));
      P.cm[base + x] = static_cast<int32_t>(kv >> 32);
    }
  }
  SYNC();

  // the sweep over each group of at least min_anchors hits
  int32_t* ss = P.seg_start + base;
  int32_t* se = P.seg_cnt + base;
  PHASE {
    if (tid == 0) {
      const int32_t* q = P.qs + base;
      const int32_t* t = P.ts + base;
      const int32_t* g = P.cm + base;
      int32_t nseg = 0;
      for (int32_t a = 0; a < H;) {
        int32_t e = a + 1;
        while (e < H && g[e] == g[a]) ++e;
        if (e - a >= P.min_anchors) {
          int32_t start = a;
          int64_t ref = static_cast<int64_t>(t[a]) - q[a];
          for (int32_t i = a + 1; i < e; ++i) {
            const int64_t d = static_cast<int64_t>(t[i]) - q[i];
            const int64_t drift = d - ref;
            if (static_cast<int64_t>(t[i]) - t[i - 1] > MAX_GAP || (drift < 0 ? -drift : drift) > MAX_DIAG) {
              ss[nseg] = start;
              se[nseg] = i;
              ++nseg;
              start = i;
              ref = d;
            } else {
              ref = floordiv4(ref * 3 + d);
            }
          }
          ss[nseg] = start;
          se[nseg] = e;
          ++nseg;
        }
        a = e;
      }
      S.sc[S_NSEG] = nseg;
    }
  }
  SYNC();
  const int32_t nseg = static_cast<int32_t>(S.sc[S_NSEG]);

  // each segment's chain (se[x]: its end, then its chain's length)
  PHASE {
    for (int32_t x = tid; x < nseg; x += NT) se[x] = segment_chain(P, base, ss[x], se[x] - ss[x]);
  }
  SYNC();

  // the read's accepted chains, their places in the output and their records
  int32_t* kept = P.kept + base;
  PHASE {
    if (tid == 0) {
      int32_t* cand = P.cand + base;
      int32_t nc = 0;
      for (int32_t x = 0; x < nseg; ++x)
        if (se[x] >= P.min_anchors) cand[nc++] = x;
      for (int32_t a = 1; a < nc; ++a) {  // stable, by descending anchor count
        const int32_t x = cand[a];
        int32_t b = a;
        while (b > 0 && se[cand[b - 1]] < se[x]) {
          cand[b] = cand[b - 1];
          --b;
        }
        cand[b] = x;
      }
      int32_t nkept = 0;
      int64_t total = 0;
      if (nc > 0) {
        const double thr = lmax(static_cast<double>(P.min_anchors), se[cand[0]] * P.min_score_frac);
        int32_t* ca = P.cov[0] + base;  // merged intervals taken: [ca, cb]
        int32_t* cb = P.cov[1] + base;
        int32_t* na = P.cov[2] + base;
        int32_t* nb = P.cov[3] + base;
        int32_t ncov = 0;
        for (int32_t c = 0; c < nc; ++c) {
          const int32_t x = cand[c];
          const int32_t sc = se[x];
          if (static_cast<double>(sc) < thr) break;
          const int32_t* out = P.lis + base + ss[x];
          const int32_t* Q = P.qs + base + ss[x];
          int64_t a = Q[out[0]], b = Q[out[sc - 1]];
          if ((P.cm[base + ss[x]] & 1) == 1) {  // strand 0: the read's forward interval
            const int64_t a2 = qlen - k - b;
            b = qlen - k - a;
            a = a2;
          }
          const int64_t span = lmax<int64_t>(1, b - a);
          int64_t ov = 0;
          for (int32_t i = 0; i < ncov; ++i) ov += lmax<int64_t>(0, lmin<int64_t>(b, cb[i]) - lmax<int64_t>(a, ca[i]));
          if (static_cast<double>(ov) > P.max_overlap_frac * static_cast<double>(span)) continue;
          int64_t ma = a, mb = b;
          int32_t nn = 1;
          for (int32_t i = 0; i < ncov; ++i) {
            if (ca[i] <= mb && cb[i] >= ma) {
              ma = lmin<int64_t>(ca[i], ma);
              mb = lmax<int64_t>(cb[i], mb);
            } else {
              na[nn] = ca[i];
              nb[nn] = cb[i];
              ++nn;
            }
          }
          na[0] = static_cast<int32_t>(ma);
          nb[0] = static_cast<int32_t>(mb);
          int32_t* sw = ca; ca = na; na = sw;
          sw = cb; cb = nb; nb = sw;
          ncov = nn;
          kept[nkept++] = x;
          total += sc;
        }
      }
      int64_t abase = 0, cbase = 0;
      if (nkept > 0) {
        abase = static_cast<int64_t>(atomic_add(P.totals + T_ANCHORS, total));
        cbase = static_cast<int64_t>(atomic_add(P.totals + T_CHAINS, nkept));
        if (abase + total > P.cap_hits || cbase + nkept > P.cap_chains) {
          atomic_add(P.totals + T_OVERFLOW, 1);
          nkept = 0;
          cbase = 0;
        }
      }
      P.hdr[2 * r] = static_cast<int32_t>(cbase);
      P.hdr[2 * r + 1] = nkept;
      int64_t at = abase;
      for (int32_t c = 0; c < nkept; ++c) {
        const int32_t x = kept[c];
        int32_t* rec = P.chains + 4 * (cbase + c);
        rec[0] = P.cm[base + ss[x]] >> 1;
        rec[1] = 1 - (P.cm[base + ss[x]] & 1);
        rec[2] = se[x];
        rec[3] = static_cast<int32_t>(at);
        at += se[x];
      }
      S.sc[S_NKEPT] = nkept;
      S.sc[S_ABASE] = abase;
    }
  }
  SYNC();
  const int32_t nkept = static_cast<int32_t>(S.sc[S_NKEPT]);
  const int64_t abase = S.sc[S_ABASE];
  PHASE {
    int64_t dst = abase;
    for (int32_t c = 0; c < nkept; ++c) {
      const int32_t x = kept[c];
      const int32_t s0 = ss[x], cnt = se[x];
      for (int32_t i = tid; i < cnt; i += NT) {
        const int64_t a = base + s0 + P.lis[base + s0 + i];
        P.anchors[2 * (dst + i)] = P.qs[a];
        P.anchors[2 * (dst + i) + 1] = P.ts[a];
      }
      dst += cnt;
    }
    if (tid == 0) atomic_add(P.totals + T_READS, 1);
  }
}

#if !defined(HS_HOST_EMULATION)

__global__ void __launch_bounds__(NT) chain_seeds_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  read_body(P, carve(smem, P.w), blockIdx.x);
}

#endif

// Params from the C interface's arguments; returns false for what the kernel
// does not take.
bool make_params(Params& P, const int8_t* codes, const int64_t* read_off, const int32_t* qlen,
                 const int32_t* orig, const int32_t* allowed, const uint64_t* ih, const int32_t* ipos,
                 const int32_t* icid, const int8_t* istr, int64_t n_index, int k, int w, int max_occ,
                 int min_anchors, double min_score_frac, double max_overlap_frac, void* scratch,
                 int64_t cap_hits, int64_t cap_chains, int n_reads, void* result) {
  if (k < 1 || k > 32 || w < 1 || w > 4096 || max_occ < 0 || n_index < 0 || n_index >= (1LL << 31) ||
      cap_hits < 1 || cap_chains < 1 || n_reads < 0)
    return false;
  P.codes = codes;
  P.read_off = read_off;
  P.qlen = qlen;
  P.orig = orig;
  P.allowed = allowed;
  P.ih = ih;
  P.ipos = ipos;
  P.icid = icid;
  P.istr = istr;
  P.n_index = n_index;
  P.k = k;
  P.w = w;
  P.max_occ = max_occ;
  P.min_anchors = min_anchors;
  P.min_score_frac = min_score_frac;
  P.max_overlap_frac = max_overlap_frac;
  P.cap_hits = cap_hits;
  P.cap_chains = cap_chains;
  P.g_key = static_cast<uint64_t*>(scratch);
  P.g_val = reinterpret_cast<uint32_t*>(P.g_key + cap_hits);
  int32_t* a = reinterpret_cast<int32_t*>(P.g_val + cap_hits);
  int32_t** arrays[N_I32] = {&P.hq, &P.qs, &P.ts, &P.cm, &P.tq, &P.ti, &P.par, &P.lis,
                             &P.seg_start, &P.seg_cnt, &P.cand, &P.cov[0], &P.cov[1], &P.cov[2],
                             &P.cov[3], &P.kept};
  for (int i = 0; i < N_I32; ++i) *arrays[i] = a + i * cap_hits;
  P.totals = static_cast<unsigned long long*>(result);
  P.hdr = reinterpret_cast<int32_t*>(P.totals + N_TOTALS);
  P.chains = P.hdr + 2 * static_cast<int64_t>(n_reads);
  P.anchors = P.chains + 4 * cap_chains;
  return true;
}

}  // namespace

// Bytes of scratch for cap_hits hits.
extern "C" int64_t hs_chain_seeds_scratch_bytes(int64_t cap_hits) { return cap_hits * (8 + 4 + 4 * N_I32); }

// Bytes of the result buffer: totals, headers, chain records, anchors.
extern "C" int64_t hs_chain_seeds_result_bytes(int n_reads, int64_t cap_hits, int64_t cap_chains) {
  return 8 * N_TOTALS + 8 * static_cast<int64_t>(n_reads) + 16 * cap_chains + 8 * cap_hits;
}

#if defined(HS_HOST_EMULATION)

// The kernel's blocks and threads run one after another on the host; a
// block's shared memory starts as garbage, as on the card.
extern "C" int hs_chain_seeds_host(const int8_t* codes, const int64_t* read_off, const int32_t* qlen,
                                   const int32_t* orig, const int32_t* allowed, int n_reads, const uint64_t* ih,
                                   const int32_t* ipos, const int32_t* icid, const int8_t* istr, int64_t n_index,
                                   int k, int w, int max_occ, int min_anchors, double min_score_frac,
                                   double max_overlap_frac, void* scratch, int64_t cap_hits, int64_t cap_chains,
                                   void* result) {
  Params P;
  if (!make_params(P, codes, read_off, qlen, orig, allowed, ih, ipos, icid, istr, n_index, k, w, max_occ,
                   min_anchors, min_score_frac, max_overlap_frac, scratch, cap_hits, cap_chains, n_reads, result))
    return 1;
  std::memset(P.totals, 0, 8 * N_TOTALS);
  std::vector<unsigned char> smem(static_cast<size_t>(smem_bytes(w)));
  for (int r = 0; r < n_reads; ++r) {
    std::memset(smem.data(), 0xAB, smem.size());
    read_body(P, carve(smem.data(), w), r);
  }
  return 0;
}

#else

// Launch on `stream` (after clearing the totals on it). Returns 1 for
// arguments it does not take, else the launch's cudaGetLastError() (0 =
// launched).
extern "C" int hs_chain_seeds(const int8_t* codes, const int64_t* read_off, const int32_t* qlen,
                              const int32_t* orig, const int32_t* allowed, int n_reads, const uint64_t* ih,
                              const int32_t* ipos, const int32_t* icid, const int8_t* istr, int64_t n_index, int k,
                              int w, int max_occ, int min_anchors, double min_score_frac, double max_overlap_frac,
                              void* scratch, int64_t cap_hits, int64_t cap_chains, void* result, void* stream) {
  Params P;
  if (!make_params(P, codes, read_off, qlen, orig, allowed, ih, ipos, icid, istr, n_index, k, w, max_occ,
                   min_anchors, min_score_frac, max_overlap_frac, scratch, cap_hits, cap_chains, n_reads, result))
    return 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(P.totals, 0, 8 * N_TOTALS, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_reads == 0) return 0;
  const int smem = static_cast<int>(smem_bytes(w));
  err = cudaFuncSetAttribute(chain_seeds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_seeds_kernel<<<n_reads, NT, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

#endif
