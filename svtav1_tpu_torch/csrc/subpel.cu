// K9 subpel_pred: subpel motion search of (n, n) blocks on the 1/8-pel
// lattice around a full-pel MV, returning the winner's MV and its normative
// prediction. Every lattice point is MC'd (8-tap, ROUND0/ROUND1, clip) from
// one (n+8)^2 patch per block read at mv_fp - 4 with clamped coordinates:
//   fast: the 25 points {-4,-2,0,2,4}^2, the first SAD minimum in (dy, dx)
//         raster order;
//   else: the 49 points {-6..6}^2 step 2, then the reference's two stages:
//         the half-pel 9 points {-4,0,4}^2 (first minimum), then the 8
//         quarter-pel points {-2,0,2}^2 around its winner in raster order,
//         each taken only if its SAD is strictly smaller.
// The prediction equals K10 (mc_lanes) at the returned MV.
//
// Replaces svtav1_tpu/ops/me_jax.py::subpel_pred_lanes with :258
// extract_patches and :269 _mc_patch_static (the decide's subpel step of
// every block of every size against each reference).
//
// Bound: operations. A block reads (n+8)^2 uint8 and n^2 int32 source samples
// and writes n^2 + 2 int32, but computes 25 or 49 predictions of n^2 samples
// (8 vertical multiply-adds, an absolute difference and a sum each) and the
// horizontal pass of 5 or 7 column phases over n+8 rows. Design: one block per
// source block; patch and source staged in shared memory as int16; the
// horizontal pass depends only on the column offset and phase (dx), so it runs
// once per dx value into shared memory and serves every dy of that column;
// each thread keeps its partial SADs for all dy in registers and they are
// reduced per warp with one shared atomic each. One thread then picks the
// winner, and the block recomputes that one prediction and writes it.
#include "common.cuh"

namespace {

constexpr int FILTER_BITS = 7, ROUND0 = 3, ROUND1 = 11;
constexpr int MAXL = 7;  // lattice points per axis (slow)

__device__ __forceinline__ int lat_of(int j, int L) { return (L == 5 ? -4 : -6) + 2 * j; }

// horizontal pass of one column offset/phase over all n+8 patch rows
__device__ void hpass(const short* patch, int* hb, const int* taps, int n, int dx8, int bd) {
  const int P = n + 8;
  const int fx0 = 2 * dx8;                    // 1/16 pel
  const int c0 = 1 + (fx0 >> 4), sx = fx0 & 15;
  const int* f = taps + sx * 8;
  const int hbase = 1 << (bd + FILTER_BITS - 1);
  for (int i = threadIdx.x; i < P * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    const short* p = patch + r * P + c0 + c;
    int acc = hbase;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += f[k] * p[k];
    hb[i] = (acc + (1 << (ROUND0 - 1))) >> ROUND0;
  }
}

__device__ __forceinline__ int vpass(const int* hb, const int* f, int n, int r0, int r, int c,
                                     int offset_bits, int sub, int maxv) {
  int acc = 1 << offset_bits;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += f[k] * hb[(r0 + r + k) * n + c];
  return clampi(((acc + (1 << (ROUND1 - 1))) >> ROUND1) - sub, 0, maxv);
}

__global__ void subpel_pred_kernel(const int* __restrict__ src_b, const uint8_t* __restrict__ ref,
                                   const int* __restrict__ ys, const int* __restrict__ xs,
                                   const int* __restrict__ mv_fp, const int* __restrict__ ftab,
                                   int* __restrict__ mv_out, int* __restrict__ pred_out, int H,
                                   int W, int n, int bd, int L) {
  extern __shared__ int smem[];
  __shared__ int taps[16 * 8];
  __shared__ int sads[MAXL * MAXL];
  __shared__ int s_best[2];
  const int P = n + 8;
  int* hb = smem;                              // (n+8) x n int32
  short* patch = (short*)(smem + P * n);       // (n+8)^2
  short* src = patch + P * P;                  // n x n
  const int b = blockIdx.x;
  const int mfy = mv_fp[2 * b], mfx = mv_fp[2 * b + 1];
  const int py = ys[b] + mfy - 4, px = xs[b] + mfx - 4;
  for (int i = threadIdx.x; i < 128; i += blockDim.x) taps[i] = ftab[i];
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) sads[i] = 0;
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
    const int r = i / P, c = i - r * P;
    patch[i] = ref[(size_t)clampi(py + r, 0, H - 1) * W + clampi(px + c, 0, W - 1)];
  }
  const int* S = src_b + (size_t)b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) src[i] = (short)S[i];
  const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
  const int sub = (1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1));
  const int maxv = (1 << bd) - 1;
  for (int jx = 0; jx < L; ++jx) {
    __syncthreads();  // staging done / previous column's SADs read hb
    hpass(patch, hb, taps, n, lat_of(jx, L), bd);
    __syncthreads();
    int part[MAXL];
#pragma unroll
    for (int j = 0; j < MAXL; ++j) part[j] = 0;
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      const int s = src[i];
#pragma unroll
      for (int jy = 0; jy < MAXL; ++jy) {
        if (jy < L) {
          const int fy0 = 2 * lat_of(jy, L);
          part[jy] += abs(vpass(hb, taps + (fy0 & 15) * 8, n, 1 + (fy0 >> 4), r, c, offset_bits,
                                sub, maxv) - s);
        }
      }
    }
#pragma unroll
    for (int jy = 0; jy < MAXL; ++jy) {
      if (jy < L) {
        int v = part[jy];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if ((threadIdx.x & 31) == 0) atomicAdd(&sads[jy * L + jx], v);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int by, bx;  // lattice indices of the winner
    if (L == 5) {
      int best = 0;
      for (int k = 1; k < 25; ++k)
        if (sads[k] < sads[best]) best = k;
      by = best / 5;
      bx = best % 5;
    } else {
      // half-pel stage over {-4,0,4}^2 = lattice indices {1,3,5}^2
      int y1 = 1, x1 = 1, bs = sads[1 * 7 + 1];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c) {
          const int v = sads[(1 + 2 * a) * 7 + 1 + 2 * c];
          if (v < bs) {
            bs = v;
            y1 = 1 + 2 * a;
            x1 = 1 + 2 * c;
          }
        }
      by = y1;
      bx = x1;
      for (int a = -1; a <= 1; ++a)
        for (int c = -1; c <= 1; ++c) {
          if (a == 0 && c == 0) continue;
          const int v = sads[(y1 + a) * 7 + x1 + c];
          if (v < bs) {
            bs = v;
            by = y1 + a;
            bx = x1 + c;
          }
        }
    }
    s_best[0] = by;
    s_best[1] = bx;
    mv_out[2 * b] = mfy * 8 + lat_of(by, L);
    mv_out[2 * b + 1] = mfx * 8 + lat_of(bx, L);
  }
  __syncthreads();
  hpass(patch, hb, taps, n, lat_of(s_best[1], L), bd);
  __syncthreads();
  const int fy0 = 2 * lat_of(s_best[0], L);
  int* O = pred_out + (size_t)b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    O[i] = vpass(hb, taps + (fy0 & 15) * 8, n, 1 + (fy0 >> 4), r, c, offset_bits, sub, maxv);
  }
}

// K14 subpel_refine: the TPL's two-step refinement (half pel, then quarter
// pel): nine candidates per step around the current MV in (dy, dx) raster
// order, dy major, from (-1, -1) to (1, 1), the second step centred on the
// first step's winner; each step takes the FIRST SAD minimum, so a corner
// that ties the centre wins. Every candidate is normative MC (K10's
// rounding) from the same (n+8)^2 patch as K9: both steps stay inside
// +-3/4 pel of the full-pel MV, the {-6..6} step-2 lattice of K9. Returns
// the 1/8-pel MV only.
//
// Replaces svtav1_tpu/ops/me_jax.py::subpel_refine_lanes (the TPL
// dispenser's subpel step, svtav1_tpu/pipeline/tpl.py:92).
//
// Bound: operations (18 predictions of n^2 samples, each 8 vertical
// multiply-adds, a difference and a sum, and the horizontal pass of 3
// column phases per step over n+8 rows, against (n+8)^2 uint8 and n^2 int32
// reads). Design: one block per lane, patch and source in shared memory as
// K9; per step the horizontal pass runs once per candidate column into
// shared memory and serves that column's three rows.
__global__ void subpel_refine_kernel(const int* __restrict__ src_b,
                                     const uint8_t* __restrict__ ref,
                                     const int* __restrict__ ys, const int* __restrict__ xs,
                                     const int* __restrict__ mv_fp, const int* __restrict__ ftab,
                                     int* __restrict__ mv_out, int H, int W, int n, int bd) {
  extern __shared__ int smem[];
  __shared__ int taps[16 * 8];
  __shared__ int sads[9];
  __shared__ int s_ctr[2];
  const int P = n + 8;
  int* hb = smem;                              // (n+8) x n int32
  short* patch = (short*)(smem + P * n);       // (n+8)^2
  short* src = patch + P * P;                  // n x n
  const int b = blockIdx.x;
  const int mfy = mv_fp[2 * b], mfx = mv_fp[2 * b + 1];
  const int py = ys[b] + mfy - 4, px = xs[b] + mfx - 4;
  for (int i = threadIdx.x; i < 128; i += blockDim.x) taps[i] = ftab[i];
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
    const int r = i / P, c = i - r * P;
    patch[i] = ref[(size_t)clampi(py + r, 0, H - 1) * W + clampi(px + c, 0, W - 1)];
  }
  const int* S = src_b + (size_t)b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) src[i] = (short)S[i];
  const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
  const int sub = (1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1));
  const int maxv = (1 << bd) - 1;
  int cy = 3, cx = 3;  // lattice indices of the current MV (index 3 = offset 0)
  for (int step = 2; step >= 1; --step) {  // lattice steps: 2 = 4/8 pel, 1 = 2/8 pel
    for (int i = threadIdx.x; i < 9; i += blockDim.x) sads[i] = 0;
    for (int c = 0; c < 3; ++c) {
      __syncthreads();  // staging and zeroing done / previous column's SADs read hb
      hpass(patch, hb, taps, n, lat_of(cx + (c - 1) * step, MAXL), bd);
      __syncthreads();
      int part[3] = {0, 0, 0};
      for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
        const int r = i / n, cc = i - r * n;
        const int s = src[i];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int fy0 = 2 * lat_of(cy + (a - 1) * step, MAXL);
          part[a] += abs(vpass(hb, taps + (fy0 & 15) * 8, n, 1 + (fy0 >> 4), r, cc, offset_bits,
                               sub, maxv) - s);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int v = part[a];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if ((threadIdx.x & 31) == 0) atomicAdd(&sads[a * 3 + c], v);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int best = 0;  // the first minimum in offs order
      for (int k = 1; k < 9; ++k)
        if (sads[k] < sads[best]) best = k;
      s_ctr[0] = cy + (best / 3 - 1) * step;
      s_ctr[1] = cx + (best % 3 - 1) * step;
    }
    __syncthreads();
    cy = s_ctr[0];
    cx = s_ctr[1];
  }
  if (threadIdx.x == 0) {
    mv_out[2 * b] = mfy * 8 + lat_of(cy, MAXL);
    mv_out[2 * b + 1] = mfx * 8 + lat_of(cx, MAXL);
  }
}

}  // namespace

extern "C" int subpel_refine_launch(const int* src_b, const uint8_t* ref, const int* ys,
                                    const int* xs, const int* mv_fp, const int* ftab,
                                    int* mv_out, int B, int H, int W, int n, int bd,
                                    void* stream) {
  if (B == 0) return 0;
  const int P = n + 8;
  const int threads = n * n >= 256 ? 256 : n * n;
  const size_t shm = (size_t)P * n * sizeof(int) + (size_t)(P * P + n * n) * sizeof(short);
  subpel_refine_kernel<<<B, threads, shm, (cudaStream_t)stream>>>(src_b, ref, ys, xs, mv_fp, ftab,
                                                                  mv_out, H, W, n, bd);
  return launch_status();
}

extern "C" int subpel_pred_launch(const int* src_b, const uint8_t* ref, const int* ys, const int* xs,
                                  const int* mv_fp, const int* ftab, int* mv_out, int* pred_out,
                                  int B, int H, int W, int n, int bd, int fast, void* stream) {
  if (B == 0) return 0;
  const int P = n + 8;
  const int threads = n * n >= 256 ? 256 : n * n;
  const size_t shm = (size_t)P * n * sizeof(int) + (size_t)(P * P + n * n) * sizeof(short);
  subpel_pred_kernel<<<B, threads, shm, (cudaStream_t)stream>>>(src_b, ref, ys, xs, mv_fp, ftab, mv_out,
                                                               pred_out, H, W, n, bd, fast ? 5 : 7);
  return launch_status();
}
