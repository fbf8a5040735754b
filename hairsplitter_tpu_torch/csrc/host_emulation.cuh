// What a kernel source needs besides the C++ language, for its two builds.
//
// With nvcc: the CUDA runtime's declarations. With -DHS_HOST_EMULATION (g++,
// a machine without a GPU), the kernels' bodies are built for the host so
// that their control flow and arithmetic can be tested there: the CUDA
// qualifiers vanish, and the vector type and the intrinsics the sources use
// get portable twins. Every source and common header takes them from here,
// so that there is one definition of each.

#pragma once

#include <cstdint>

#if defined(HS_HOST_EMULATION)
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> (s & 31));
}
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return static_cast<uint32_t>((((static_cast<uint64_t>(hi) << 32) | lo) << (s & 31)) >> 32);
}
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
static inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
// per byte: 0xFF where the bytes of a and b differ
static inline uint32_t __vcmpne4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k)
    if (((a >> (8 * k)) & 0xFFu) != ((b >> (8 * k)) & 0xFFu)) r |= 0xFFu << (8 * k);
  return r;
}
// byte k of the result is byte (selector nibble k) of the 8 bytes {y, x}
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t both = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= static_cast<uint32_t>((both >> (8 * ((s >> (4 * k)) & 7u))) & 0xFFu) << (8 * k);
  return r;
}
// c + the dot product of the four signed bytes of a and b
static inline int __dp4a(int a, int b, int c) {
  for (int k = 0; k < 4; ++k)
    c += static_cast<int8_t>((static_cast<uint32_t>(a) >> (8 * k)) & 0xFFu) *
         static_cast<int8_t>((static_cast<uint32_t>(b) >> (8 * k)) & 0xFFu);
  return c;
}
#else
#include <cuda_runtime.h>
#endif
