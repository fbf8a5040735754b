// Myers / Hyyro bit-vector banded edit distance for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hairsplitter_tpu/ops/align_myers_pallas.py:
// _myers_kernel` (launched by `myers_rows_pallas`). It computes, bit for bit,
// the same four streams per query row of every alignment: the P and M
// vertical delta words of the W = 128 cell band (dl = 64, held as 4 uint32
// words), and with EMIT_TB the traceback classification words nonleft and
// isup. The plain PyTorch twin is `ops/align_myers_cuda.py:myers_rows_torch`.
//
// What bounds it on this card: the bytes it writes. A row costs ~70 integer
// ops per alignment but writes 32 B (P, M) or 64 B (with nonleft, isup) and
// reads 2 B, so at the main path's shapes (N ~ 35k jobs, B = 256 rows) the
// kernel writes ~0.57 GB and the write stream, not the ALUs, sets its time.
//
// What the design does about it: one thread per alignment keeps the whole
// recurrence in registers (band P/M in 8 registers, the four sliding Peq
// planes in 16) and loops over the B rows, so nothing but the outputs ever
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

namespace {

constexpr int DL = 64;  // band = 128 cells, apex at dl = 64
constexpr int BLOCK = 128;

// 128-bit vector shifted right by one cell; `top` (0/1) fills bit 127
__device__ __forceinline__ void shr1(const uint32_t x[4], uint32_t top, uint32_t out[4]) {
  out[0] = __funnelshift_r(x[0], x[1], 1);
  out[1] = __funnelshift_r(x[1], x[2], 1);
  out[2] = __funnelshift_r(x[2], x[3], 1);
  out[3] = (x[3] >> 1) | (top << 31);
}

// 128-bit vector shifted left by one cell; `bot` (0/1) fills bit 0
__device__ __forceinline__ void shl1(const uint32_t x[4], uint32_t bot, uint32_t out[4]) {
  out[3] = __funnelshift_l(x[2], x[3], 1);
  out[2] = __funnelshift_l(x[1], x[2], 1);
  out[1] = __funnelshift_l(x[0], x[1], 1);
  out[0] = (x[0] << 1) | bot;
}

// exact 128-bit add mod 2^128 (the Pallas kernel's per-word add + carry ripple)
__device__ __forceinline__ void add128(const uint32_t a[4], const uint32_t b[4], uint32_t s[4]) {
  asm("add.cc.u32 %0, %4, %8;\n\t"
      "addc.cc.u32 %1, %5, %9;\n\t"
      "addc.cc.u32 %2, %6, %10;\n\t"
      "addc.u32 %3, %7, %11;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
}

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
  uint32_t pl[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int w = 0; w < 4; ++w) pl[c][w] = 0u;
#pragma unroll
  for (int j = 0; j < DL; ++j) {
    const int code = j < T ? static_cast<int>(tT[j * stride + n]) : 6;
    const uint32_t bit = 1u << (j & 31);
    const int w = 2 + (j >> 5);
#pragma unroll
    for (int c = 0; c < 4; ++c) pl[c][w] |= (code == c) ? bit : 0u;
  }

  // V-shaped row 0: M bits 1..64 set, P bits 65..127 set
  uint32_t P[4] = {0u, 0u, 0xFFFFFFFEu, 0xFFFFFFFFu};
  uint32_t M[4] = {0xFFFFFFFEu, 0xFFFFFFFFu, 1u, 0u};

  for (int r = 0; r < B; ++r) {
    const int qc = static_cast<int>(qT[r * stride + n]);
    const int tj = DL + r;  // target base injected at the band top after row r
    const int inj = tj < T ? static_cast<int>(tT[tj * stride + n]) : 6;

    uint32_t eq[4], eP[4], eM[4], Xv[4], t0[4], s[4], Ph[4], Mh[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      eq[w] = (qc == 0 ? pl[0][w] : 0u) | (qc == 1 ? pl[1][w] : 0u) |
              (qc == 2 ? pl[2][w] : 0u) | (qc == 3 ? pl[3][w] : 0u);
    // band slide: previous deltas shift right, +1 fills the top
    shr1(P, 1u, eP);
    shr1(M, 0u, eM);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      Xv[w] = eq[w] | eM[w];
      t0[w] = eq[w] & eP[w];
    }
    add128(t0, eP, s);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t Xh = (s[w] ^ eP[w]) | eq[w];
      Ph[w] = eM[w] | ~(Xh | eP[w]);
      Mh[w] = eP[w] & Xh;
    }
    const size_t o = r * stride + n;
    if (EMIT_TB) {
      // per-cell backpointer class from the live deltas:
      //   DIAG <=> (Ph-Mh) + (eP-eM) == (eq ? 0 : 1), only for j >= 1
      //   UP   <=> Ph (else), forced at j == 0, barred at the band top
      const int i_row = r + 1;
      uint32_t nl[4], up[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t any_h = Ph[w] | Mh[w];
        const uint32_t any_e = eP[w] | eM[w];
        const uint32_t d1 = (Ph[w] & eM[w]) | (Mh[w] & eP[w]) | (~any_h & ~any_e);
        const uint32_t d0 = (Ph[w] & ~any_e) | (eP[w] & ~any_h);
        uint32_t diag = (eq[w] & d1) | (~eq[w] & d0);
        const int off1 = (DL + 1 - i_row) - 32 * w;  // j >= 1 suffix of this word
        const uint32_t m_ge1 = off1 <= 0 ? 0xFFFFFFFFu : (off1 >= 32 ? 0u : (0xFFFFFFFFu << off1));
        const int pos0 = (DL - i_row) - 32 * w;      // the j == 0 bit, if in this word
        const uint32_t m_j0 = (pos0 >= 0 && pos0 < 32) ? (1u << pos0) : 0u;
        const uint32_t top_ok = w == 3 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
        diag &= m_ge1;
        up[w] = ((Ph[w] & top_ok) | m_j0) & ~diag;
        nl[w] = diag | up[w];
      }
      nl_out[o] = make_uint4(nl[0], nl[1], nl[2], nl[3]);
      up_out[o] = make_uint4(up[0], up[1], up[2], up[3]);
    }
    uint32_t Ph1[4], Mh1[4];
    shl1(Ph, 1u, Ph1);
    shl1(Mh, 0u, Mh1);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      P[w] = Mh1[w] | ~(Xv[w] | Ph1[w]);
      M[w] = Ph1[w] & Xv[w];
    }
    p_out[o] = make_uint4(P[0], P[1], P[2], P[3]);
    m_out[o] = make_uint4(M[0], M[1], M[2], M[3]);
    // slide the match planes to the next row's window
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t nxt[4];
      shr1(pl[c], inj == c ? 1u : 0u, nxt);
#pragma unroll
      for (int w = 0; w < 4; ++w) pl[c][w] = nxt[w];
    }
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
