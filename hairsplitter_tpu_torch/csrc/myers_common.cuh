// The Myers / Hyyro row recurrence shared by the two modes of K1:
// `myers_rows.cu` (check mode: the four word streams) and `myers_fused.cu`
// (the main path: DP, readout and traceback in one kernel). Both step the
// band through `myers_row`, so the two cannot drift.
//
// The band is W = 128 cells (dl = 64) held as 4 uint32 words per vector, all
// of it in one thread's registers: P/M vertical deltas (8 registers) and the
// target window as three sliding bit planes (12): the two bits of each base
// code and whether the position holds a base at all. The match vector of a
// query code is three logic ops per word on them, against four selects and
// ors for one Peq plane per base, and three planes slide instead of four.

#pragma once

#include <cstdint>

#include "host_emulation.cuh"

namespace hs {

constexpr int DL = 64;  // band = 128 cells, apex at dl = 64

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
#if defined(HS_HOST_EMULATION)
  uint64_t carry = 0;
  for (int w = 0; w < 4; ++w) {
    const uint64_t v = static_cast<uint64_t>(a[w]) + b[w] + carry;
    s[w] = static_cast<uint32_t>(v);
    carry = v >> 32;
  }
#else
  asm("add.cc.u32 %0, %4, %8;\n\t"
      "addc.cc.u32 %1, %5, %9;\n\t"
      "addc.cc.u32 %2, %6, %10;\n\t"
      "addc.u32 %3, %7, %11;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
#endif
}

// One alignment's band state between query rows.
struct MyersState {
  uint32_t P[4], M[4];  // vertical deltas of the last row
  // the next row's target window: code bit 0, code bit 1, and "is a base"
  // (codes 0..3) of the position under each band cell
  uint32_t lo[4], hi[4], ok[4];
};

// Row 0 of the band (V-shaped: M bits 1..64, P bits 65..127) and empty planes.
__device__ __forceinline__ void myers_init(MyersState& st) {
  st.P[0] = 0u; st.P[1] = 0u; st.P[2] = 0xFFFFFFFEu; st.P[3] = 0xFFFFFFFFu;
  st.M[0] = 0xFFFFFFFEu; st.M[1] = 0xFFFFFFFFu; st.M[2] = 1u; st.M[3] = 0u;
#pragma unroll
  for (int w = 0; w < 4; ++w) st.lo[w] = st.hi[w] = st.ok[w] = 0u;
}

// Enters target position j (0 <= j < DL) into the first band window, at bit
// DL + j (bits below DL are left sentinels: no base).
__device__ __forceinline__ void myers_seed_plane(MyersState& st, int j, int code) {
  const uint32_t bit = 1u << (j & 31);
  const int w = 2 + (j >> 5);
  st.lo[w] |= (code & 1) ? bit : 0u;
  st.hi[w] |= (code & 2) ? bit : 0u;
  st.ok[w] |= static_cast<unsigned>(code) < 4u ? bit : 0u;
}

// One query row i_row (1-based): steps P/M across the row for query code
// `qc`, slides the planes to the next row's window with target code `inj`
// entering at the band top, and with EMIT_TB classifies every cell's
// backpointer into the nonleft / isup words:
//   DIAG <=> (Ph-Mh) + (eP-eM) == (eq ? 0 : 1), only for j >= 1
//   UP   <=> Ph (else), forced at j == 0, barred at the band top
// Codes other than 0..3 match nothing. The j >= 1 and j == 0 masks only bite
// while the band still reaches left of the target (i_row <= DL): callers pass
// EARLY = false for the rows after that, which then compute no masks.
template <bool EMIT_TB, bool EARLY>
__device__ __forceinline__ void myers_row(MyersState& st, int qc, int inj, int i_row,
                                          uint32_t nl[4], uint32_t up[4]) {
  uint32_t eq[4], eP[4], eM[4], Xv[4], t0[4], s[4], Ph[4], Mh[4];
  const uint32_t q_lo = (qc & 1) ? 0xFFFFFFFFu : 0u;
  const uint32_t q_hi = (qc & 2) ? 0xFFFFFFFFu : 0u;
  const uint32_t q_ok = static_cast<unsigned>(qc) < 4u ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int w = 0; w < 4; ++w)
    eq[w] = st.ok[w] & q_ok & ~((st.lo[w] ^ q_lo) | (st.hi[w] ^ q_hi));
  // band slide: previous deltas shift right, +1 fills the top
  shr1(st.P, 1u, eP);
  shr1(st.M, 0u, eM);
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
  if (EMIT_TB) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t any_h = Ph[w] | Mh[w];
      const uint32_t any_e = eP[w] | eM[w];
      const uint32_t d1 = (Ph[w] & eM[w]) | (Mh[w] & eP[w]) | (~any_h & ~any_e);
      const uint32_t d0 = (Ph[w] & ~any_e) | (eP[w] & ~any_h);
      uint32_t diag = (eq[w] & d1) | (~eq[w] & d0);
      uint32_t m_j0 = 0u;
      if (EARLY) {
        const int off1 = (DL + 1 - i_row) - 32 * w;  // j >= 1 suffix of this word
        const uint32_t m_ge1 = off1 <= 0 ? 0xFFFFFFFFu : (off1 >= 32 ? 0u : (0xFFFFFFFFu << off1));
        const int pos0 = (DL - i_row) - 32 * w;      // the j == 0 bit, if in this word
        m_j0 = (pos0 >= 0 && pos0 < 32) ? (1u << pos0) : 0u;
        diag &= m_ge1;
      }
      const uint32_t top_ok = w == 3 ? 0x7FFFFFFFu : 0xFFFFFFFFu;
      up[w] = ((Ph[w] & top_ok) | m_j0) & ~diag;
      nl[w] = diag | up[w];
    }
  }
  uint32_t Ph1[4], Mh1[4];
  shl1(Ph, 1u, Ph1);
  shl1(Mh, 0u, Mh1);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    st.P[w] = Mh1[w] | ~(Xv[w] | Ph1[w]);
    st.M[w] = Ph1[w] & Xv[w];
  }
  // slide the target window to the next row: `inj` enters at the band top
  uint32_t nxt[4];
  shr1(st.lo, static_cast<uint32_t>(inj) & 1u, nxt);
#pragma unroll
  for (int w = 0; w < 4; ++w) st.lo[w] = nxt[w];
  shr1(st.hi, (static_cast<uint32_t>(inj) >> 1) & 1u, nxt);
#pragma unroll
  for (int w = 0; w < 4; ++w) st.hi[w] = nxt[w];
  shr1(st.ok, static_cast<unsigned>(inj) < 4u ? 1u : 0u, nxt);
#pragma unroll
  for (int w = 0; w < 4; ++w) st.ok[w] = nxt[w];
}

}  // namespace hs
