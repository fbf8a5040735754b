// Int32 banded edit-distance DP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hairsplitter_tpu/ops/align_pallas.py:
// _dp_kernel` (launched by `banded_align_batch_pallas`). It computes, bit for
// bit, the same outputs for every alignment of the batch over the W = 128
// cell band (dl = 64): per query row either the uint8 backpointers or, with
// EMIT_ENC, the int16 traceback run encoding (a prefix max over the band of
// `((b + 1) << 1) | is_up` on non-LEFT cells), plus the row at i == qlen and
// the minimum of the j == tlen column with its row (ties go to the earliest
// row). The plain PyTorch twin is
// `ops/align_dp_cuda.py:banded_align_batch_torch`.
//
// What bounds it on this card: the plane it writes and the dependent chain
// of each row. A row writes W bytes (bp) or 2 W bytes (enc) per alignment;
// at the main path's shapes (32,768 jobs, B = 256 rows) the enc plane is
// 2.15 GB, at least 0.64 ms at 3.35 TB/s. Within a row, the D-run recurrence
// (a prefix min over the band) and the run encoding (a prefix max) are
// band-wide scans that every next row waits on.
//
// What the design does about it: one warp per alignment, four consecutive
// band cells per lane, so a row is four registers per lane and the sequential
// TPU grid of row steps becomes a loop inside the warp. The state stays in
// x-space (x = D - b) as in the Pallas kernel, so the prefix min is a plain
// running min: a serial min over the lane's four cells, then a 5-step
// __shfl_up_sync scan of the lane aggregates; the enc prefix max is the same
// two-level scan. `up` takes cell b + 1 from the lane itself or, for the
// lane's fourth cell, from the next lane through __shfl_down_sync. The query
// and the padded target window of the alignment are staged once in shared
// memory (cell b of row i reads t_padded[(i - 1) + b], so no window is
// rolled). Each row's store is one contiguous run of the [N, B, W] plane:
// 128 bytes (bp, a 4-byte store per lane) or 256 bytes (enc, 8 bytes per
// lane), fully coalesced. Nothing but the outputs reaches device memory.
//
// Codes: any int8 codes; a cell matches when the query and target codes are
// equal, exactly as in the Pallas kernel. Target positions outside [0, T)
// read the sentinel 6, as the Pallas wrapper pads the target.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 128;  // band cells
constexpr int DL = W / 2;  // band apex: cell b of row i is target column j = i + b - DL
constexpr int CPL = W / 32;  // cells per lane
constexpr int WARPS = 4;  // alignments per block
constexpr int32_t INF = 1 << 20;
constexpr int T_SENTINEL = 6;
constexpr int BP_DIAG = 0, BP_UP = 1, BP_LEFT = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

template <bool EMIT_ENC>
__global__ void __launch_bounds__(WARPS * 32) banded_dp_kernel(
    const int8_t* __restrict__ q,  // [N, B]
    const int8_t* __restrict__ t,  // [N, T]
    const int32_t* __restrict__ q_lens,  // [N]
    const int32_t* __restrict__ t_lens,  // [N]
    int N, int B, int T,
    void* __restrict__ plane,  // [N, B, W]: uint8 bp, or int16 enc with EMIT_ENC
    int32_t* __restrict__ row_at_q,  // [N, W]
    int32_t* __restrict__ colmin_val,  // [N]
    int32_t* __restrict__ colmin_i) {  // [N]
  extern __shared__ int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // the whole warp leaves together: no shuffle is left short

  // stage the query and the padded target: ts[k] = t[k - DL], sentinel outside
  const int span = B + W;  // row i reads ts[(i - 1) + b], b < W
  int8_t* qs = smem + static_cast<size_t>(warp) * (B + span);
  int8_t* ts = qs + B;
  const int8_t* qn = q + static_cast<size_t>(n) * B;
  const int8_t* tn = t + static_cast<size_t>(n) * T;
  for (int k = lane; k < B; k += 32) qs[k] = qn[k];
  for (int k = lane; k < span; k += 32) {
    const int j = k - DL;
    ts[k] = (j >= 0 && j < T) ? tn[j] : static_cast<int8_t>(T_SENTINEL);
  }
  __syncwarp();

  const int qlen = q_lens[n];
  const int tlen = t_lens[n];
  const int b0 = lane * CPL;

  // row 0 (leading deletions): D = j for 0 <= j <= tlen, else INF
  int32_t x[CPL];  // the previous row in x-space
  int32_t rq[CPL];  // the row at i == qlen, x-space
  int32_t cc[CPL];  // the j == tlen column, D-space (cell b holds row tlen + DL - b)
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int b = b0 + c;
    const int j0 = b - DL;
    const int32_t r0 = (j0 >= 0 && j0 <= tlen) ? j0 : INF;
    x[c] = r0 - b;
    rq[c] = qlen == 0 ? r0 - b : INF - b;
    cc[c] = INF;
  }

  uint8_t* bp_n = static_cast<uint8_t*>(plane) + static_cast<size_t>(n) * B * W;
  int16_t* enc_n = static_cast<int16_t*>(plane) + static_cast<size_t>(n) * B * W;

  for (int i = 1; i <= B; ++i) {
    const int qc = qs[i - 1];
    const int8_t* tw = ts + (i - 1) + b0;
    // D_up[b] = D_prev[b + 1] + 1  ->  x_up[b] = x_prev[b + 1] + 2
    const int32_t x_next = __shfl_down_sync(FULL, x[0], 1);
    int32_t diag[CPL], up[CPL], s[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      diag[c] = x[c] + (tw[c] == qc ? 0 : 1);
      if (c < CPL - 1)
        up[c] = x[c + 1] + 2;
      else
        up[c] = lane == 31 ? INF + 1 - (W - 1) : x_next + 2;
      s[c] = min(diag[c], up[c]);
      if (c > 0) s[c] = min(s[c], s[c - 1]);
    }
    // exact D-run recurrence: inclusive prefix min over the band
    int32_t agg = s[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(FULL, agg, d);
      if (lane >= d) agg = min(agg, o);
    }
    int32_t before = __shfl_up_sync(FULL, agg, 1);
    if (lane == 0) before = INT_MAX;

    // cells outside [0, tlen] (one unsigned compare: j < 0 wraps) or beyond
    // qlen are INF; valid cells clamp at INF
    const bool past_q = i > qlen;
    int32_t row[CPL];
    int op[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = b0 + c;
      const unsigned jv = static_cast<unsigned>(b + i - DL);
      const bool invalid = jv > static_cast<unsigned>(tlen) || past_q;
      row[c] = invalid ? INF - b : min(min(s[c], before), INF - b);
      op[c] = row[c] == diag[c] ? BP_DIAG : (row[c] == up[c] ? BP_UP : BP_LEFT);
    }

    const size_t r_off = static_cast<size_t>(i - 1) * W + b0;
    if (EMIT_ENC) {
      // per cell, (position + 1, is_up) of the non-LEFT cell its LEFT-run
      // ends at: a prefix max over the band
      int32_t e[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        e[c] = op[c] != BP_LEFT ? (((b0 + c + 1) << 1) | (op[c] == BP_UP ? 1 : 0)) : 0;
        if (c > 0) e[c] = max(e[c], e[c - 1]);
      }
      int32_t emax = e[CPL - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_up_sync(FULL, emax, d);
        if (lane >= d) emax = max(emax, o);
      }
      int32_t e_before = __shfl_up_sync(FULL, emax, 1);
      if (lane == 0) e_before = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) e[c] = max(e[c], e_before);
      const uint2 packed = make_uint2(
          (static_cast<uint32_t>(e[0]) & 0xFFFFu) | (static_cast<uint32_t>(e[1]) << 16),
          (static_cast<uint32_t>(e[2]) & 0xFFFFu) | (static_cast<uint32_t>(e[3]) << 16));
      *reinterpret_cast<uint2*>(enc_n + r_off) = packed;
    } else {
      const uint32_t packed = static_cast<uint32_t>(op[0]) | (static_cast<uint32_t>(op[1]) << 8) |
                              (static_cast<uint32_t>(op[2]) << 16) |
                              (static_cast<uint32_t>(op[3]) << 24);
      *reinterpret_cast<uint32_t*>(bp_n + r_off) = packed;
    }

    const int b_col = tlen - i + DL;  // the j == tlen cell of this row
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (i == qlen) rq[c] = row[c];
      if (b0 + c == b_col) cc[c] = row[c] + b_col;  // row is INF-masked past qlen
      x[c] = row[c];
    }
  }

  // back to D-space
  *reinterpret_cast<int4*>(row_at_q + static_cast<size_t>(n) * W + b0) =
      make_int4(rq[0] + b0, rq[1] + b0 + 1, rq[2] + b0 + 2, rq[3] + b0 + 3);

  // colmin over the collected column cells; ties pick the earliest row i,
  // i.e. the LARGEST cell (i = tlen + DL - b)
  int32_t v = cc[0];
  int sel = b0;
#pragma unroll
  for (int c = 1; c < CPL; ++c) {
    if (cc[c] <= v) {
      v = cc[c];
      sel = b0 + c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ov = __shfl_xor_sync(FULL, v, off);
    const int os = __shfl_xor_sync(FULL, sel, off);
    if (ov < v || (ov == v && os > sel)) {
      v = ov;
      sel = os;
    }
  }
  if (lane == 0) {
    colmin_val[n] = v;
    colmin_i[n] = v >= INF ? 0 : tlen + DL - sel;
  }
}

}  // namespace

// Launch on `stream`; emit_enc selects the int16 run-encoding plane over the
// uint8 backpointers. Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int hs_banded_dp(const int8_t* q, const int8_t* t, const int32_t* q_lens,
                            const int32_t* t_lens, int N, int B, int T, int emit_enc, void* plane,
                            int32_t* row_at_q, int32_t* colmin_val, int32_t* colmin_i,
                            void* stream) {
  if (N <= 0) return 0;
  const dim3 grid((N + WARPS - 1) / WARPS);
  const size_t smem = static_cast<size_t>(WARPS) * (B + B + W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_enc) {
    banded_dp_kernel<true><<<grid, WARPS * 32, smem, s>>>(
        q, t, q_lens, t_lens, N, B, T, plane, row_at_q, colmin_val, colmin_i);
  } else {
    banded_dp_kernel<false><<<grid, WARPS * 32, smem, s>>>(
        q, t, q_lens, t_lens, N, B, T, plane, row_at_q, colmin_val, colmin_i);
  }
  return static_cast<int>(cudaGetLastError());
}
