// The table-driven square DCT/ADST stage networks (pass1d), the dead-zone
// quantizer and the block body txq_block, with the block in shared memory
// and the whole CTA on it. K15 (txfm_quant_recon.cu) builds on pass1d and
// K16 (commit.cu) runs txq_block for each task of a wave. K2 itself runs
// the compiled networks of txfm_nets.cuh, which compute the same function
// (see txfm_quant_recon.cu for what K2 replaces and how it is bound).
#pragma once
#include "common.cuh"

// The packed stage-table buffer starts with a 32-int header. Tables: 0 fwd col DCT, 1 fwd col ADST, 2 fwd row DCT,
// 3 fwd row ADST, 4 inv DCT, 5 inv ADST; [6..11] stage counts;
// [12..16] sinpi(col cos bit), [17..21] sinpi(row), [22..26] sinpi(inverse);
// [27] col cos bit, [28] row cos bit.

static __device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

static __device__ __forceinline__ int apply_shift(int x, int bit) {
  if (bit > 0) return round_shift(x, bit);
  if (bit < 0) return (int)((unsigned)x << (-bit));
  return x;
}

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

// One block of K2 with the whole CTA (stage 0: the whole chain; 1: the
// forward half; 2: the inverse half from `levels`). S is the source block
// with row stride s_stride (read unless stage 2), P the n x n prediction;
// levels / coeff (adj x adj, coeff optional) and recon (n x n) are this
// block's slots, recon may alias P (each sample reads its own prediction
// before it writes). X and Y are two n*n int buffers in shared memory. With
// sse, thread 0 writes the recon's SSE against S. Ends without a barrier.
static __device__ void txq_block(const int* S, int s_stride, const int* P, bool va_lane,
                                 bool ha_lane, const int* __restrict__ tb, int* levels,
                                 int* coeff, int* recon, unsigned long long* sse, int stage,
                                 int n, int log2n, int b0, int b1, int b2, int sh_row, int sh_col,
                                 int dq_dc, int dq_ac, int ls, int bd, int* X, int* Y) {
  __shared__ unsigned long long s_sse;
  const int nn = n * n;
  // per-lane 1-D kinds: ADST4 (table -1) at 4 points, no ADST above 16
  const bool va = va_lane && n <= 16, ha = ha_lane && n <= 16;
  const int fcol = va ? (n == 4 ? -1 : 1) : 0;
  const int frow = ha ? (n == 4 ? -1 : 3) : 2;
  const int icol = va ? (n == 4 ? -1 : 5) : 4;
  const int irow = ha ? (n == 4 ? -1 : 5) : 4;
  const int adj = n < 32 ? n : 32;
  if (threadIdx.x == 0) s_sse = 0ull;

  const int dqmax = (1 << (bd + 7)) - 1;
  if (stage != 2) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
      X[idx] = apply_shift(S[(idx >> log2n) * s_stride + (idx & (n - 1))] - P[idx], b0);
    __syncthreads();
    pass1d(X, Y, tb, fcol, n, log2n, true, 0, tb + 12, tb[27], false);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) X[idx] = apply_shift(X[idx], b1);
    __syncthreads();
    pass1d(X, Y, tb, frow, n, log2n, false, 0, tb + 17, tb[28], false);
  }
  // quant (+ 64-point zero-out), levels out, dequant in place; stage 2 reads
  // the levels instead
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int r = idx >> log2n, c = idx & (n - 1);
    const bool coded = r < adj && c < adj;
    const int at = r * adj + c;
    const int dq = idx == 0 ? dq_dc : dq_ac;
    int lv;
    if (stage == 2) {
      lv = coded ? levels[at] : 0;
    } else {
      int x = apply_shift(X[idx], b2);
      if (n == 64 && (r >= 32 || c >= 32)) x = 0;
      const int absc = (int)((unsigned)abs(x) << ls);
      lv = floordiv((int)((unsigned)absc + (unsigned)(dq >> 1)), dq);
      lv = x > 0 ? lv : (x < 0 ? -lv : 0);
      lv = clampi(lv, -32767, 32767);
      if (coded) {
        levels[at] = lv;
        if (coeff) coeff[at] = x;
      }
    }
    int d = min((abs(lv) * dq) >> ls, dqmax);
    d = lv > 0 ? d : (lv < 0 ? -d : 0);
    X[idx] = clampi(d, -(1 << (bd + 7)), (1 << (bd + 7)) - 1);
  }
  if (stage == 1) return;
  __syncthreads();
  pass1d(X, Y, tb, irow, n, log2n, false, bd == 8 ? 16 : 18, tb + 22, 12, true);
  const int cb = bd + 6 > 16 ? bd + 6 : 16;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    X[idx] = clampi(round_shift(X[idx], sh_row), -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
  __syncthreads();
  pass1d(X, Y, tb, icol, n, log2n, true, 16, tb + 22, 12, true);
  const int pmax = (1 << bd) - 1;
  unsigned long long acc = 0;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int rec = clampi(P[idx] + round_shift(X[idx], sh_col), 0, pmax);
    if (recon) recon[idx] = rec;
    if (sse) {
      const long long d = rec - S[(idx >> log2n) * s_stride + (idx & (n - 1))];
      acc += (unsigned long long)(d * d);
    }
  }
  if (sse) {
    atomicAdd(&s_sse, acc);
    __syncthreads();
    if (threadIdx.x == 0) *sse = s_sse;
  }
}
