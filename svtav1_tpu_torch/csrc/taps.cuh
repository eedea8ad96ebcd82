// The packed 8-tap subpel passes of K9 and K14 (subpel.cu) and of K10 and K11
// (mc.cu): the horizontal intermediate of a patch row by IDP.4A (8 bits,
// samples biased to signed bytes) or IDP.2A (10 bits, int16 samples), phase 0
// as a copy, and the vertical pass's start and clip per sample type. They rest on three facts of
// the filter tables that tests/test_torch_me.py holds: every tap but phase 0's
// 128 fits int8, every phase sums to 128, and the horizontal intermediate is a
// positive int16 at 8 and at 10 bits.
#pragma once
#include "common.cuh"

namespace {

// every phase but 0 has int8 taps; phase 0 (a single tap of 128) is a copy
constexpr int HINIT = (1 << 14) + 128 * 128 + 4;  // 2^(bd+6), 128 x the taps' sum 128, rounding
constexpr int VINIT = (1 << 19) + 1024 - (384 << 11);  // 2^offset_bits, rounding, - the offset
// the same at 10 bits: the samples carry no bias
constexpr int HINIT10 = (1 << 16) + 4;
constexpr int VINIT10 = (1 << 21) + 1024 - (1536 << 11);

// the horizontal intermediate (ROUND0) of the 8 patch samples at byte offset
// o of a row of signed bytes (sample - 128): two IDP.4A on the int8 taps
// (t0: taps 0-3, t1: taps 4-7), or the copy of phase 0
__device__ __forceinline__ int hsample(const uint8_t* row, int o, int t0, int t1, bool copy) {
  const unsigned* w = (const unsigned*)(row + (o & ~3));
  const unsigned sel = 0x3210u + 0x1111u * (o & 3);
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
  const int lo = (int)__byte_perm(w0, w1, sel), hi = (int)__byte_perm(w1, w2, sel);
  return copy ? 4096 + 16 * (lo >> 24) : __dp4a(hi, t1, __dp4a(lo, t0, HINIT)) >> 3;
}

// hsample at 10 bits: the 8 int16 samples at offset o of a patch row,
// realigned to sample pairs by PRMT when o is odd, by four IDP.2A on the int8
// taps (t0: taps 0-3, t1: taps 4-7), or the copy of phase 0
__device__ __forceinline__ int hsample16(const int16_t* row, int o, int t0, int t1, bool copy) {
  const unsigned* w = (const unsigned*)(row + (o & ~1));
  unsigned p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = (o & 1) ? __byte_perm(w[i], w[i + 1], 0x5432u) : w[i];
  if (copy) return 8192 + 16 * (int)(p[1] >> 16);
  int acc = __dp2a_lo((int)p[0], t0, HINIT10);
  acc = __dp2a_hi((int)p[1], t0, acc);
  acc = __dp2a_lo((int)p[2], t1, acc);
  return __dp2a_hi((int)p[3], t1, acc) >> 3;
}

__device__ __forceinline__ int clip8(int acc) { return clampi(acc >> 11, 0, 255); }

// The sample type's constants and passes: uint8_t (8 bits, the patch as
// signed bytes) or int16_t (10 bits).
template <typename T>
struct Bd {
  static constexpr bool B8 = sizeof(T) == 1;
  static constexpr int V = B8 ? VINIT : VINIT10;  // the vertical pass's start
  static __device__ __forceinline__ int h(const T* row, int o, int t0, int t1, bool copy) {
    if constexpr (B8) return hsample(row, o, t0, t1, copy);
    else return hsample16(row, o, t0, t1, copy);
  }
  static __device__ __forceinline__ int clip(int acc) {
    return B8 ? clip8(acc) : clampi(acc >> 11, 0, 1023);
  }
};

// the int8 taps 0-3 of f as one word (IDP.4A / IDP.2A operand)
__device__ __forceinline__ unsigned pack_taps4(const int* f) {
  return (unsigned)((f[0] & 255) | ((f[1] & 255) << 8) | ((f[2] & 255) << 16)) |
         ((unsigned)f[3] << 24);
}

}  // namespace
