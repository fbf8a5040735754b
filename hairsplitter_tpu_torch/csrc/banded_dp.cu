// K2, check mode: the int32 banded edit-distance DP for Hopper (sm_90a),
// emitting what the TPU kernel emits.
//
// Replaces the Pallas TPU kernel `hairsplitter_tpu/ops/align_pallas.py:
// _dp_kernel` (launched by `banded_align_batch_pallas`) output for output. It
// computes, bit for bit, for every alignment of the batch over the W = 128
// cell band (dl = 64): per query row either the uint8 backpointers or, with
// EMIT_ENC, the int16 traceback run encoding (a prefix max over the band of
// `((b + 1) << 1) | is_up` on non-LEFT cells), plus the row at i == qlen and
// the minimum of the j == tlen column with its row (ties go to the earliest
// row). The plain PyTorch twin is
// `ops/align_dp_cuda.py:banded_align_batch_torch`.
//
// Nothing on the mapping path launches this kernel: there the whole fused
// call is `banded_fused.cu`, which keeps the backpointer classes on chip and
// never writes a plane. This mode stays as the check of the row recurrence,
// which both kernels take from `banded_common.cuh` (`dp_row`, the column
// minimum's `lane_col_update` / `col_decode`): the planes show every cell's
// backpointer, which the fused buffer cannot.
//
// What bounds it on this card: the plane it writes and the dependent chain
// of each row. A row writes W bytes (bp) or 2 W bytes (enc) per alignment;
// at 32,768 alignments of B = 256 rows the enc plane is 2.15 GB, at least
// 0.64 ms at 3.35 TB/s. Within a row, the D-run recurrence (a prefix min
// over the band) and the run encoding (a prefix max) are band-wide scans
// that every next row waits on.
//
// What the design does about it: one warp per alignment, four consecutive
// band cells per lane, so a row is four registers per lane and the sequential
// TPU grid of row steps becomes a loop inside the warp (all B rows: the plane
// is defined for rows past the query too). `up` takes cell b + 1 from the
// lane itself or, for the lane's fourth cell, from the next lane. The query
// and the padded target window of the alignment are staged once in shared
// memory (cell b of row i reads t_padded[(i - 1) + b], so no window is
// rolled). Each row's store is one contiguous run of the [N, B, W] plane:
// 128 bytes (bp, a 4-byte store per lane) or 256 bytes (enc, 8 bytes per
// lane), fully coalesced. Nothing but the outputs reaches device memory.
//
// Codes: any int8 codes; a cell matches when the query and target codes are
// equal, exactly as in the Pallas kernel. Target positions outside [0, T)
// read the sentinel 6, as the Pallas wrapper pads the target.

#include <cstdint>
#include <cuda_runtime.h>

#include "banded_common.cuh"

namespace {

using hsb::Cells;
using hsb::CPL;
using hsb::DL;
using hsb::FULL;
using hsb::INF;
using hsb::PerLane;
using hsb::W;

constexpr int WARPS = 4;  // alignments per block
constexpr int BP_DIAG = 0, BP_UP = 1, BP_LEFT = 2;

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
    ts[k] = (j >= 0 && j < T) ? tn[j] : static_cast<int8_t>(hsb::T_SENTINEL);
  }
  __syncwarp();

  const int qlen = q_lens[n];
  const int tlen = t_lens[n];
  const int b0 = lane * CPL;

  PerLane<Cells> x;  // the previous row in x-space
  hsb::lane_row0(lane, tlen, x.v);
  int32_t rq[CPL];  // the row at i == qlen, x-space
#pragma unroll
  for (int c = 0; c < CPL; ++c) rq[c] = qlen == 0 ? x.v.c[c] : INF - (b0 + c);
  uint32_t col_key = hsb::COL_NONE;  // the lane's best cell of the j == tlen column

  uint8_t* bp_n = static_cast<uint8_t*>(plane) + static_cast<size_t>(n) * B * W;
  int16_t* enc_n = static_cast<int16_t*>(plane) + static_cast<size_t>(n) * B * W;

  for (int i = 1; i <= B; ++i) {
    const uint32_t qrep = static_cast<uint32_t>(static_cast<uint8_t>(qs[i - 1])) * 0x01010101u;
    const uint8_t* tw = reinterpret_cast<const uint8_t*>(ts) + (i - 1) + b0;
    PerLane<uint32_t> tword, cls;
    tword.v = static_cast<uint32_t>(tw[0]) | (static_cast<uint32_t>(tw[1]) << 8) |
              (static_cast<uint32_t>(tw[2]) << 16) | (static_cast<uint32_t>(tw[3]) << 24);
    hsb::dp_row<hsb::MASK_BOTH>(x, tword, qrep, i, tlen, i > qlen, cls);
    int op[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      op[c] = ((cls.v >> c) & 1u) ? BP_DIAG : (((cls.v >> (hsb::UP_SHIFT + c)) & 1u) ? BP_UP : BP_LEFT);

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

    hsb::lane_col_update(lane, x.v, i, tlen, col_key);  // the row is INF-masked past qlen
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (i == qlen) rq[c] = x.v.c[c];
  }

  // back to D-space
  *reinterpret_cast<int4*>(row_at_q + static_cast<size_t>(n) * W + b0) =
      make_int4(rq[0] + b0, rq[1] + b0 + 1, rq[2] + b0 + 2, rq[3] + b0 + 3);

  PerLane<uint32_t> keys;
  keys.v = col_key;
  int32_t v, row;
  hsb::col_decode(hsb::warp_reduce_min(keys), tlen, v, row);
  if (lane == 0) {
    colmin_val[n] = v;
    colmin_i[n] = row;
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
