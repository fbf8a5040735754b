// Myers / Hyyro bit-vector banded edit distance for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hairsplitter_tpu/ops/align_myers_pallas.py:
// _myers_kernel` (launched by `myers_rows_pallas`). It computes, bit for bit,
// the same four streams per query row of every alignment: the P and M
// vertical delta words of the W = 128 cell band (dl = 64, held as 4 uint32
// words), and with EMIT_TB the traceback classification words nonleft and
// isup. The plain PyTorch twin is `ops/align_myers_cuda.py:myers_rows_torch`.
//
// This is K1's check mode: the streams are what equals the Pallas kernel's
// outputs word for word. The main path runs `myers_fused.cu`, which steps the
// same recurrence (`myers_common.cuh:myers_row`) and keeps P and M in
// registers.
//
// What bounds it on this card: the bytes it writes. A row costs ~70 integer
// ops per alignment but writes 32 B (P, M) or 64 B (with nonleft, isup) and
// reads 2 B, so at the main path's shapes (N ~ 35k jobs, B = 256 rows) the
// kernel writes ~0.57 GB and the write stream, not the ALUs, sets its time.
//
// What the design does about it: one thread per alignment keeps the whole
// recurrence in registers (band P/M in 8 registers, the sliding target window
// in 12) and loops over the B rows, so nothing but the outputs ever
// reaches device memory. The output layout is [B, N, 4] words: at every row a
// warp's 32 threads store 32 consecutive 16-byte uint4 values (512 contiguous
// bytes), so each store instruction is fully coalesced. Inputs come
// transposed ([B, N] query codes, [T, N] target codes) for the same reason:
// a warp's row read is 32 consecutive bytes. The Python wrapper returns the
// JAX package's [N, B, 4] layout as a permuted view of these buffers.
//
// Codes: bases 0..3; anything else (GAP 4, PAD 5, T_SENTINEL 6, Q_SENTINEL 7)
// matches nothing. The target is read as if padded with dl sentinels on the
// left and sentinels past its width on the right, as the Pallas wrapper pads
// it (`myers_rows_pallas`: t_padded).

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

using hs::DL;
constexpr int BLOCK = 128;

template <bool EMIT_TB>
__global__ void __launch_bounds__(BLOCK) myers_rows_kernel(
    const int8_t* __restrict__ qT,  // [B, N]
    const int8_t* __restrict__ tT,  // [T, N]
    int N, int B, int T,
    uint4* __restrict__ p_out,      // [B, N] x 4 words
    uint4* __restrict__ m_out,
    uint4* __restrict__ nl_out,
    uint4* __restrict__ up_out) {
  const int n = blockIdx.x * BLOCK + threadIdx.x;
  if (n >= N) return;
  const size_t stride = static_cast<size_t>(N);

  // Peq planes of the first band window: bit b <-> padded target position b,
  // i.e. target j = b - DL for b >= DL (bits below DL are left sentinels)
  hs::MyersState st;
  hs::myers_init(st);
#pragma unroll
  for (int j = 0; j < DL; ++j)
    hs::myers_seed_plane(st, j, j < T ? static_cast<int>(tT[j * stride + n]) : 6);

  for (int r = 0; r < B; ++r) {
    const int qc = static_cast<int>(qT[r * stride + n]);
    const int tj = DL + r;  // target base injected at the band top after row r
    const int inj = tj < T ? static_cast<int>(tT[tj * stride + n]) : 6;
    uint32_t nl[4], up[4];
    if (r < DL) {
      hs::myers_row<EMIT_TB, true>(st, qc, inj, r + 1, nl, up);
    } else {  // the band has left the j <= 0 columns: no row masks
      hs::myers_row<EMIT_TB, false>(st, qc, inj, r + 1, nl, up);
    }
    const size_t o = r * stride + n;
    if (EMIT_TB) {
      nl_out[o] = make_uint4(nl[0], nl[1], nl[2], nl[3]);
      up_out[o] = make_uint4(up[0], up[1], up[2], up[3]);
    }
    p_out[o] = make_uint4(st.P[0], st.P[1], st.P[2], st.P[3]);
    m_out[o] = make_uint4(st.M[0], st.M[1], st.M[2], st.M[3]);
  }
}

}  // namespace

// Launch on `stream`; nl/up null selects the 2-stream variant. Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int hs_myers_rows(const int8_t* qT, const int8_t* tT, int N, int B, int T,
                             uint32_t* p_out, uint32_t* m_out, uint32_t* nl_out,
                             uint32_t* up_out, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const dim3 grid((N + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* p = reinterpret_cast<uint4*>(p_out);
  auto* m = reinterpret_cast<uint4*>(m_out);
  if (nl_out != nullptr) {
    myers_rows_kernel<true><<<grid, BLOCK, 0, s>>>(
        qT, tT, N, B, T, p, m, reinterpret_cast<uint4*>(nl_out), reinterpret_cast<uint4*>(up_out));
  } else {
    myers_rows_kernel<false><<<grid, BLOCK, 0, s>>>(qT, tT, N, B, T, p, m, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
