// K5's device code: the two-pass RDOQ of one transform block with one or
// more warps (rdoq_tile), and its context and cost helpers. K5 (rdoq.cu)
// runs it once per CTA; K16 (commit.cu) runs it with one warp for each task.
// See rdoq.cu for what it replaces and how it rounds.
#pragma once
#include "common.cuh"

static constexpr int F_BASE = 0, F_BASE_EOB = 168, F_BR = 180, F_DCS = 455, F_EOB = 457;

static __device__ __forceinline__ int amag(const int* a, int r, int c, int h, int w, int log2w) {
  return (r < h && c < w) ? min(a[(r << log2w) + c], 127) : 0;
}

// Base and br contexts of position pos from the magnitudes a (TX_CLASS_2D).
static __device__ __forceinline__ void rdoq_contexts(const int* a, const int* nz_off,
                                                     const int* br_grp, int pos, int h, int w,
                                                     int log2w, int& bctx, int& brctx) {
  const int r = pos >> log2w, c = pos & (w - 1);
  const int m01 = amag(a, r, c + 1, h, w, log2w), m10 = amag(a, r + 1, c, h, w, log2w);
  const int m11 = amag(a, r + 1, c + 1, h, w, log2w);
  const int m02 = amag(a, r, c + 2, h, w, log2w), m20 = amag(a, r + 2, c, h, w, log2w);
  const int mag = min(m01, 3) + min(m10, 3) + min(m11, 3) + min(m02, 3) + min(m20, 3);
  bctx = pos == 0 ? 0 : min((mag + 1) >> 1, 4) + nz_off[pos];
  brctx = min((m01 + m10 + m11 + 1) >> 1, 6) + (pos == 0 ? 0 : br_grp[pos]);
}

// Bits of coding magnitude a at a non-eob position: ((base + br) + golomb) + sign.
static __device__ __forceinline__ float own_cost(const float* fl, int a, int bctx, int brctx,
                                                 float sgn) {
  float c = fl[F_BASE + bctx * 4 + min(a, 3)];
  if (a > 2) c = __fadd_rn(c, fl[F_BR + brctx * 13 + min(a - 3, 12)]);
  if (a > 14) c = __fadd_rn(c, (float)(2 * (31 - __clz(a - 14) + 1) - 1));
  if (a > 0) c = __fadd_rn(c, sgn);
  return c;
}

// |dequantized a| - |coefficient| in float32 (rate_jax err()).
static __device__ __forceinline__ float rdoq_err(int a, int dq, int ls, float cabs) {
  return __fsub_rn((float)((a * dq) >> ls), cabs);
}

// The suffix sums of the gains gs[0, eob0) in float64 with one warp,
// gs[k] = (float)(gs[eob0 - 1] + ... + gs[k]), added one at a time in that
// order, as the plain version adds them. Lane l holds gs[32 l, 32 l +
// 32) in registers (gs 16-byte aligned); the lanes take their segments in
// turn, from the top, handing the running sum on with a shuffle. So the
// dependent chain is one of float64 adds on registers, and not also one of
// shared-memory loads and stores.
static __device__ __forceinline__ void rdoq_suffix_sums_warp(float* gs, int eob0) {
  const int lane = threadIdx.x & 31;
  const int nseg = (eob0 + 31) >> 5;
  float4* seg = reinterpret_cast<float4*>(gs + 32 * lane);
  float g[32];
  if (lane < nseg) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = seg[q];
      g[4 * q] = v.x;
      g[4 * q + 1] = v.y;
      g[4 * q + 2] = v.z;
      g[4 * q + 3] = v.w;
    }
  }
  double acc = 0.0;
  for (int s = nseg - 1; s >= 0; --s) {
    if (lane == s) {
      const int hi = eob0 - 32 * s;  // this segment's gains below eob0
#pragma unroll
      for (int i = 31; i >= 0; --i) {
        if (i < hi) {
          acc += (double)g[i];
          g[i] = (float)acc;
        }
      }
    }
    acc = __shfl_sync(0xffffffffu, acc, s);
  }
  if (lane < nseg) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      seg[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  }
}

// The barrier of a body run by WARPS warps: __syncwarp for one (K16's
// tasks), __syncthreads for a CTA.
template <int WARPS>
static __device__ __forceinline__ void rdoq_sync() {
  if constexpr (WARPS == 1)
    __syncwarp();
  else
    __syncthreads();
}

// RDOQ of one h x w block with the CTA's first WARPS warps (one: K16's
// tasks and K5's small blocks; several: K5's larger blocks): levels L and
// unquantized coefficients C in, new levels O out (O must not alias L).
// eob0 by a warp max, the eob argmin by warp shuffles (the first index on
// ties), each across the warps through shared memory; the suffix sums in
// warp 0. a holds n ints and gs max(n + 1, 32) floats, 16-byte aligned and
// apart from the other arrays. Ends with the warps synchronized.
template <int WARPS>
static __device__ void rdoq_tile(const int* __restrict__ L, const int* __restrict__ C,
                                 const float* __restrict__ flut, const int* __restrict__ ilut,
                                 const int* __restrict__ scan, int* __restrict__ O, int h, int w,
                                 int log2w, int ls, int dq_dc, int dq_ac, float lam, float dscale,
                                 float skip_delta, int* __restrict__ a, float* __restrict__ gs) {
  constexpr int STRIDE = 32 * WARPS;
  const int n = h * w;
  const int tid = threadIdx.x, lane = tid & 31;
  const int* ectx = ilut;
  const int* iscan = ilut + n;
  const int* nz_off = ilut + 2 * n;
  const int* br_grp = ilut + 3 * n;
  int my_eob = 0;
  for (int pos = tid; pos < n; pos += STRIDE) {
    const int v = abs(L[pos]);
    a[pos] = v;
    if (v) my_eob = max(my_eob, iscan[pos] + 1);
  }
  int eob0 = __reduce_max_sync(0xffffffffu, my_eob);
  if constexpr (WARPS > 1) {
    __shared__ int s_eob[WARPS];
    if (lane == 0) s_eob[tid >> 5] = eob0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) eob0 = max(eob0, s_eob[i]);
  }
  const float dc_cost = flut[F_DCS + (L[0] < 0 ? 1 : 0)];
  rdoq_sync<WARPS>();

  // ---- pass 1: zeroing gains by scan position
  for (int pos = tid; pos < n; pos += STRIDE) {
    const int isc = iscan[pos];
    float g = 0.f;
    if (isc < eob0) {
      int bctx, brctx;
      rdoq_contexts(a, nz_off, br_grp, pos, h, w, log2w, bctx, brctx);
      const int ai = a[pos];
      const int dq = pos == 0 ? dq_dc : dq_ac;
      const float cabs = (float)abs(C[pos]);
      const float e0 = rdoq_err(ai, dq, ls, cabs);
      const float zd = __fmul_rn(__fsub_rn(__fmul_rn(cabs, cabs), __fmul_rn(e0, e0)), dscale);
      const float ni = own_cost(flut, ai, bctx, brctx, pos == 0 ? dc_cost : 1.f);
      g = __fsub_rn(ai > 0 ? zd : 0.f, __fmul_rn(lam, ni));
    }
    gs[isc] = g;
  }
  if (tid == 0) gs[n] = 0.f;
  rdoq_sync<WARPS>();
  if (tid < 32) rdoq_suffix_sums_warp(gs, eob0);
  rdoq_sync<WARPS>();

  // ---- eob search: argmin over k = 0 (skip) .. n, first index wins
  float best = __int_as_float(0x7f800000);  // +inf
  int bidx = 0x7fffffff;
  if (tid == 0) {
    best = __fadd_rn(gs[0], __fmul_rn(lam, skip_delta));
    bidx = 0;
  }
  for (int k = tid + 1; k <= eob0; k += STRIDE) {
    const int pos = scan[k - 1];
    const int ai = a[pos];
    if (ai == 0) continue;
    int bctx, brctx;
    rdoq_contexts(a, nz_off, br_grp, pos, h, w, log2w, bctx, brctx);
    const int sym = min(ai, 3);
    const float beob = flut[F_BASE_EOB + ectx[k - 1] * 3 + max(sym - 1, 0)];
    const float bnorm = flut[F_BASE + bctx * 4 + sym];
    const float sc = __fadd_rn(
        gs[k], __fmul_rn(lam, __fsub_rn(__fadd_rn(flut[F_EOB + k], beob), bnorm)));
    if (sc < best) {
      best = sc;
      bidx = k;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {  // every lane ends with its warp's (min, first index)
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (ov < best || (ov == best && oi < bidx)) {
      best = ov;
      bidx = oi;
    }
  }
  if constexpr (WARPS > 1) {
    __shared__ float s_val[WARPS];
    __shared__ int s_idx[WARPS];
    if (lane == 0) {
      s_val[tid >> 5] = best;
      s_idx[tid >> 5] = bidx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      if (s_val[i] < best || (s_val[i] == best && s_idx[i] < bidx)) {
        best = s_val[i];
        bidx = s_idx[i];
      }
    }
  }
  const int kbest = bidx;
  for (int pos = tid; pos < n; pos += STRIDE)
    if (iscan[pos] >= kbest) a[pos] = 0;
  rdoq_sync<WARPS>();

  // ---- pass 2: level-down with refreshed contexts
  const int ectx_k = ectx[max(kbest - 1, 0)];
  for (int pos = tid; pos < n; pos += STRIDE) {
    const int isc = iscan[pos];
    const int ai = a[pos];
    int res = ai;
    const bool is_eob = isc == kbest - 1;
    if (ai > 0 && isc < kbest && (!is_eob || ai >= 2)) {
      int bctx, brctx;
      rdoq_contexts(a, nz_off, br_grp, pos, h, w, log2w, bctx, brctx);
      const int dq = pos == 0 ? dq_dc : dq_ac;
      const float cabs = (float)abs(C[pos]);
      const int adn = ai - 1;
      const float e1 = rdoq_err(ai, dq, ls, cabs), edn = rdoq_err(adn, dq, ls, cabs);
      const float dd = __fmul_rn(__fsub_rn(__fmul_rn(edn, edn), __fmul_rn(e1, e1)), dscale);
      const float sgn = pos == 0 ? dc_cost : 1.f;
      float c_now = own_cost(flut, ai, bctx, brctx, sgn);
      float c_dn = own_cost(flut, adn, bctx, brctx, sgn);
      if (is_eob) {
        const float beob_now = flut[F_BASE_EOB + ectx_k * 3 + max(min(ai, 3) - 1, 0)];
        const float beob_dn = flut[F_BASE_EOB + ectx_k * 3 + max(min(adn, 3) - 1, 0)];
        c_now = __fadd_rn(__fsub_rn(c_now, flut[F_BASE + bctx * 4 + min(ai, 3)]), beob_now);
        c_dn = __fadd_rn(__fsub_rn(c_dn, flut[F_BASE + bctx * 4 + min(adn, 3)]), beob_dn);
      }
      if (__fadd_rn(dd, __fmul_rn(lam, __fsub_rn(c_dn, c_now))) < 0.f) res = adn;
    }
    O[pos] = L[pos] < 0 ? -res : res;
  }
  rdoq_sync<WARPS>();
}
