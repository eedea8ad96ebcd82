// K1's per-sample formulas as device code: the thirteen key-frame AV1 intra
// predictors of one n x n block from filled edges. K1 (intra_pred.cu) and
// K16 (commit.cu) both call intra_pred_sample / intra_dr_sample and
// intra_dc, so the two predict bit-identically. See intra_pred.cu for what
// it replaces.
#pragma once
#include "common.cuh"

// Extended edge sample k in [-1, 2n-1]: -1 is the top-left sample, indices
// past the edge repeat its last sample (intra_device.py:80-81).
static __device__ __forceinline__ int intra_ext(const int* E, int tl, int k, int n) {
  return k < 0 ? tl : E[min(k, n - 1)];
}

// One directional sample at (i, j); dr = (dx, dy, zone) of the mode
// (ops/intra.py dr_tables: zone 1 above only, zone 3 left only, zone 2 both).
static __device__ __forceinline__ int intra_dr_sample(const int* A, const int* L, int tl, int n,
                                                      const int* dr, int i, int j) {
  const int dx = dr[0], dy = dr[1], zone = dr[2];
  int v;
  if (zone == 1) {
    const int x = (i + 1) * dx, base = (x >> 6) + j, sh = (x & 0x3F) >> 1;
    v = intra_ext(A, tl, base, n) * (32 - sh) + intra_ext(A, tl, base + 1, n) * sh;
  } else if (zone == 3) {
    const int y = (j + 1) * dy, base = (y >> 6) + i, sh = (y & 0x3F) >> 1;
    v = intra_ext(L, tl, base, n) * (32 - sh) + intra_ext(L, tl, base + 1, n) * sh;
  } else {
    const int x = -(i + 1) * dx, base = (x >> 6) + j;
    if (base >= -1) {
      const int sh = (x & 0x3F) >> 1;
      v = intra_ext(A, tl, base, n) * (32 - sh) + intra_ext(A, tl, base + 1, n) * sh;
    } else {
      const int y = (i << 6) - (j + 1) * dy, b2 = y >> 6, sh = (y & 0x3F) >> 1;
      v = intra_ext(L, tl, b2, n) * (32 - sh) + intra_ext(L, tl, b2 + 1, n) * sh;
    }
  }
  return (v + 16) >> 5;
}

// DC of a block from its edge sums sa (above) and sl (left); with neither
// neighbour 1 << (bd - 1), as the spec and every decoder predict it.
static __device__ __forceinline__ int intra_dc(int sa, int sl, bool ha, bool hl, int n,
                                               int log2n, int bd) {
  if (ha && hl) return (sa + sl + n) >> (log2n + 1);
  if (ha) return (sa + (n >> 1)) >> log2n;
  if (hl) return (sl + (n >> 1)) >> log2n;
  return 1 << (bd - 1);
}

// Sample (i, j) of mode m from the edges (A, L, t_l), the block's DC and
// the size's smooth weights.
static __device__ __forceinline__ int intra_pred_sample(const int* A, const int* L, int t_l,
                                                        int dc, int m,
                                                        const int* __restrict__ weights,
                                                        const int* __restrict__ dr, int n, int i,
                                                        int j) {
  const int t = A[j], l = L[i];
  switch (m) {
    case 0: return dc;
    case 1: return t;
    case 2: return l;
    case 3: {
      const int wh = weights[i], ww = weights[j];
      return (wh * t + (256 - wh) * L[n - 1] + ww * l + (256 - ww) * A[n - 1] + 256) >> 9;
    }
    case 4: {
      const int wh = weights[i];
      return (wh * t + (256 - wh) * L[n - 1] + 128) >> 8;
    }
    case 5: {
      const int ww = weights[j];
      return (ww * l + (256 - ww) * A[n - 1] + 128) >> 8;
    }
    case 6: {
      const int base = t + l - t_l;
      const int pt = abs(base - t), pl = abs(base - l), ptl = abs(base - t_l);
      return (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : t_l);
    }
    default: return intra_dr_sample(A, L, t_l, n, dr + 3 * (m - 7), i, j);
  }
}
