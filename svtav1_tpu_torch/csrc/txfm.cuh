// The table-driven square DCT/ADST stage networks (pass1d), with the block
// in shared memory and the whole CTA on it: K15 (txfm_quant_recon.cu) runs
// them. K2 and K16 (commit.cu) run the compiled networks of txfm_nets.cuh,
// which compute the same function (see txfm_quant_recon.cu for what K2
// replaces and how it is bound).
#pragma once
#include "common.cuh"

// The packed stage-table buffer starts with a 32-int header. Tables: 0 fwd col DCT, 1 fwd col ADST, 2 fwd row DCT,
// 3 fwd row ADST, 4 inv DCT, 5 inv ADST; [6..11] stage counts;
// [12..16] sinpi(col cos bit), [17..21] sinpi(row), [22..26] sinpi(inverse);
// [27] col cos bit, [28] row cos bit.

static __device__ __forceinline__ int get_elem(const int* X, bool col, int v, int e, int log2n) {
  return col ? X[(e << log2n) + v] : X[(v << log2n) + e];
}

static __device__ int adst4(const int* X, bool col, int v, int k, int log2n, const int* sp,
                     int cos_bit, bool inverse) {
  const unsigned x0 = get_elem(X, col, v, 0, log2n), x1 = get_elem(X, col, v, 1, log2n);
  const unsigned x2 = get_elem(X, col, v, 2, log2n), x3 = get_elem(X, col, v, 3, log2n);
  const unsigned s1p = sp[1], s2p = sp[2], s3p = sp[3], s4p = sp[4];
  unsigned o;
  if (inverse) {
    const unsigned s0 = s1p * x0 + s4p * x2 + s2p * x3;
    const unsigned s1 = s2p * x0 - s1p * x2 - s4p * x3;
    const unsigned s2 = s3p * ((x0 - x2) + x3);
    const unsigned s3 = s3p * x1;
    o = k == 0 ? s0 + s3 : k == 1 ? s1 + s3 : k == 2 ? s2 : s0 + s1 - s3;
  } else {
    const unsigned a0 = s1p * x0 + s2p * x1 + s4p * x3;
    const unsigned a1 = s3p * (x0 + x1 - x3);
    const unsigned a2 = s4p * x0 - s1p * x1 + s2p * x3;
    const unsigned a3 = s3p * x2;
    o = k == 0 ? a0 + a3 : k == 1 ? a1 : k == 2 ? a2 - a3 : a2 - a0 + a3;
  }
  return round_shift((int)o, cos_bit);
}

// One 1-D pass over every row (col=false) or column (col=true) of the n x n
// block in X; the result ends in X (buffers swap). `tab` < 0 selects ADST4.
static __device__ void pass1d(int*& X, int*& Y, const int* __restrict__ tb, int tab, int n, int log2n,
                       bool col, int clamp_bits, const int* sp, int cos_bit, bool inverse) {
  const int nn = n * n;
  if (tab < 0) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int v = col ? (idx & (n - 1)) : (idx >> log2n);
      const int k = col ? (idx >> log2n) : (idx & (n - 1));
      Y[idx] = adst4(X, col, v, k, log2n, sp, cos_bit, inverse);
    }
    __syncthreads();
    int* t = X; X = Y; Y = t;
    return;
  }
  const int off = tb[tab], nst = tb[6 + tab];
  const int lo = clamp_bits ? -(1 << (clamp_bits - 1)) : 0;
  const int hi = clamp_bits ? (1 << (clamp_bits - 1)) - 1 : 0;
  for (int s = 0; s < nst; ++s) {
    const int* st = tb + off + s * n * 6;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int v = col ? (idx & (n - 1)) : (idx >> log2n);
      const int k = col ? (idx >> log2n) : (idx & (n - 1));
      const int* e = st + k * 6;
      const int sh = __ldg(e + 4);
      const int a = get_elem(X, col, v, __ldg(e), log2n);
      const int b = get_elem(X, col, v, __ldg(e + 2), log2n);
      int y = wrap_mad2(a, __ldg(e + 1), b, __ldg(e + 3), sh > 0 ? 1 << (sh - 1) : 0) >> sh;
      if (clamp_bits && __ldg(e + 5)) y = clampi(y, lo, hi);
      Y[idx] = y;
    }
    __syncthreads();
    int* t = X; X = Y; Y = t;
  }
}
