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
// horizontal pass of 5 or 7 column phases over n+8 rows. Design (K9 below):
// a lane per column of a block, several blocks per CTA, the column's
// intermediate and its partial SADs in registers, packed int8 x int8 and
// int16 x int8 dot products (IDP.4A, IDP.2A) for the two passes. It rests on
// three facts of the filter tables (tests/test_torch_me.py holds them): every
// tap but phase 0's 128 fits int8, every phase sums to 128, and at 8 bits the
// horizontal intermediate lies in [263, 7913], an int16. K14 keeps the
// shared-memory passes (hpass, vpass) of the first port.
//
// 10 bits (subpel_pred16_launch): the same kernel on int16 planes, a template
// on the sample type. The patch holds the samples as int16 (0..1023 need no
// bias), and the horizontal pass takes four IDP.2A (int16 sample pairs by
// int8 taps) instead of two IDP.4A; its intermediate, in [1031, 31721] at 10
// bits, is still a positive int16, so the vertical pass and the winner rule
// are the 8-bit kernel's, with 10-bit offsets and clip.
#include "taps.cuh"

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

// ---- K9: a lane per column, the block's columns in registers ----

// K9's packed passes (hsample, hsample16, Bd<T>) are in taps.cuh, shared with K10.

// The lattice point j's offset in 1/8 pel: -(L-1) + 2j (-4..4 or -6..6).
// One CTA of 256 threads holds 256 / N blocks; a block's N threads own one
// column each (a group of N lanes inside one warp up to N = 32, two warps at
// N = 64). Per column phase, a lane computes its column's horizontal
// intermediate over a strip of SH + 8 rows (IDP.4A from the patch, staged
// once as signed bytes), packs it as int16 pairs aligned at even and at odd
// rows, and runs every vertical phase from those registers (IDP.2A; the
// centre phase is a copy), adding |pred - src| with one VABSDIFF into a
// partial SAD per lattice row. The partials are summed across the group with
// shuffles; the totals go to shared memory, and every lane picks the same
// winner from them; each lane then recomputes and writes its column at the
// winner. No CTA barrier after the staging, except the sum of N = 64's two
// warps.
// Two CTAs per SM: ptxas may then take up to 128 registers (77-89); held to
// one CTA's bound it settles on 64 and spilled at N = 16, L = 7.
template <typename T, int N, int L>
__global__ void __launch_bounds__(256, 2)
subpel_pred_kernel(const int* __restrict__ src_b, const T* __restrict__ ref,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   const int* __restrict__ mv_fp, const int* __restrict__ ftab,
                   int* __restrict__ mv_out, int* __restrict__ pred_out, int B, int H, int W) {
  constexpr int P = N + 8, PS = N + 12;  // patch side; row stride (the last word read overhangs)
  constexpr int BPC = 256 / N;           // blocks per CTA
  constexpr int G = N < 32 ? N : 32;     // a block's lanes inside one warp
  constexpr int WPB = N / G;             // warps per block
  constexpr int SH = N < 16 ? N : 16;    // output rows per strip
  constexpr int NH = SH + 8;             // intermediate rows per strip
  constexpr int LL = L * L;
  // words per patch; the groups of one warp start on banks G apart
  constexpr int PW = (P * PS * (int)sizeof(T) + 3) / 4;
  constexpr int PBW = G < 32 ? (PW + 31) / 32 * 32 + G : PW;
  using K = Bd<T>;
  __shared__ __align__(16) unsigned patches[BPC * PBW + 4];
  __shared__ int taps[16][8];
  __shared__ int tpk[16][2];
  __shared__ int tot[BPC][WPB][LL];
  const int tid = threadIdx.x, slot = tid / N, c = tid - slot * N;
  const int bb = blockIdx.x * BPC + slot, b = min(bb, B - 1);
  const bool real = bb < B;
  if (tid < 128) taps[tid >> 3][tid & 7] = ftab[tid];
  if (tid < 32) {
    const int* f = ftab + 4 * tid;  // phase tid / 2, taps 4 (tid & 1) ..
    tpk[tid >> 1][tid & 1] = (int)pack_taps4(f);
  }
  T* patch = (T*)(patches + slot * PBW);
  const int mfy = mv_fp[2 * b], mfx = mv_fp[2 * b + 1];
  const int py = ys[b] + mfy - 4, px = xs[b] + mfx - 4;
  for (int i = c; i < P * P; i += N) {
    const int r = i / P, cc = i - r * P;
    const T v = ref[(size_t)clampi(py + r, 0, H - 1) * W + clampi(px + cc, 0, W - 1)];
    patch[r * PS + cc] = K::B8 ? (T)(v ^ 0x80) : v;
  }
  __syncthreads();

  const int* S = src_b + (size_t)b * N * N + c;
  for (int jx = 0; jx < L; ++jx) {
    const int fx0 = 2 * (2 * jx - (L - 1));  // 1/16 pel
    const int o = c + 1 + (fx0 >> 4), sx = fx0 & 15;
    const int t0 = tpk[sx][0], t1 = tpk[sx][1];
    unsigned part[L];
#pragma unroll
    for (int jy = 0; jy < L; ++jy) part[jy] = 0;
    for (int s = 0; s < N; s += SH) {
      int sv[SH];
#pragma unroll
      for (int r = 0; r < SH; ++r) sv[r] = S[(s + r) * N];
      unsigned E[NH / 2], Od[NH / 2 - 1];  // (h[2i], h[2i+1]) and (h[2i+1], h[2i+2])
      {  // row by row, so that only the last intermediate stays live
        int prev = K::h(patch + s * PS, o, t0, t1, sx == 0);
#pragma unroll
        for (int i = 0; i < NH / 2; ++i) {
          const int odd = K::h(patch + (s + 2 * i + 1) * PS, o, t0, t1, sx == 0);
          E[i] = __byte_perm(prev, odd, 0x5410);
          if (i < NH / 2 - 1) {
            prev = K::h(patch + (s + 2 * i + 2) * PS, o, t0, t1, sx == 0);
            Od[i] = __byte_perm(odd, prev, 0x5410);
          }
        }
      }
#pragma unroll
      for (int jy = 0; jy < L; ++jy) {
        const int fy0 = 2 * (2 * jy - (L - 1));
        const int r0 = 1 + (fy0 >> 4), sy = fy0 & 15;
        if (sy == 0) {  // the centre row: a copy of h[r + r0 + 3]
#pragma unroll
          for (int r = 0; r < SH; ++r) {
            const int i = r + r0 + 3;
            const int hv = (i & 1) ? (int)(E[i >> 1] >> 16) : (int)(E[i >> 1] & 0xffff);
            part[jy] = __sad(K::clip(K::V + (hv << 7)), sv[r], part[jy]);
          }
        } else {
          const int u0 = tpk[sy][0], u1 = tpk[sy][1];
#pragma unroll
          for (int r = 0; r < SH; ++r) {
            const int q = r + r0, e = q >> 1, od = min(e, NH / 2 - 5);  // od: in range
            unsigned pr[4];  // the int16 pairs (h[q + 2m], h[q + 2m + 1])
#pragma unroll
            for (int m = 0; m < 4; ++m) pr[m] = (q & 1) ? Od[od + m] : E[e + m];
            int acc = __dp2a_lo((int)pr[0], u0, K::V);
            acc = __dp2a_hi((int)pr[1], u0, acc);
            acc = __dp2a_lo((int)pr[2], u1, acc);
            acc = __dp2a_hi((int)pr[3], u1, acc);
            part[jy] = __sad(K::clip(acc), sv[r], part[jy]);
          }
        }
      }
    }
#pragma unroll
    for (int jy = 0; jy < L; ++jy) {
      unsigned v = part[jy];
      for (int m = G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if ((c & (G - 1)) == 0) tot[slot][c / G][jy * L + jx] = (int)v;
    }
  }
  if (WPB > 1) __syncthreads();
  else __syncwarp();

  // the winner, the same in every lane of the block
  auto total = [&](int k) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < WPB; ++w) t += tot[slot][w][k];
    return t;
  };
  int by, bx;
  if (L == 5) {  // the first minimum in (dy, dx) raster order
    unsigned best = ~0u;
#pragma unroll
    for (int k = 0; k < LL; ++k) best = min(best, ((unsigned)total(k) << 6) | (unsigned)k);
    by = (best & 63) / L;
    bx = (best & 63) % L;
  } else {  // the half-pel 9 points {1,3,5}^2, then their strictly better neighbours
    int bs = total(1 * L + 1), y1 = 1, x1 = 1;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const int v = total((1 + 2 * a) * L + 1 + 2 * cc);
        if (v < bs) {
          bs = v;
          y1 = 1 + 2 * a;
          x1 = 1 + 2 * cc;
        }
      }
    by = y1;
    bx = x1;
#pragma unroll
    for (int k = 0; k < LL; ++k) {
      const int jy = k / L, jx = k % L;
      if (abs(jy - y1) <= 1 && abs(jx - x1) <= 1 && (jy != y1 || jx != x1)) {
        const int v = total(k);
        if (v < bs) {
          bs = v;
          by = jy;
          bx = jx;
        }
      }
    }
  }
  const int lx = 2 * bx - (L - 1), ly = 2 * by - (L - 1);
  if (real && c == 0) {
    mv_out[2 * b] = mfy * 8 + ly;
    mv_out[2 * b + 1] = mfx * 8 + lx;
  }
  // the winner's prediction of this lane's column
  const int fx0 = 2 * lx, fy0 = 2 * ly;
  const int o = c + 1 + (fx0 >> 4), sx = fx0 & 15, r0 = 1 + (fy0 >> 4), sy = fy0 & 15;
  const int t0 = tpk[sx][0], t1 = tpk[sx][1];
  int f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = taps[sy][k];
  int* out = pred_out + (size_t)b * N * N + c;
  for (int s = 0; s < N; s += SH) {
    int h[SH + 7];
#pragma unroll
    for (int i = 0; i < SH + 7; ++i) h[i] = K::h(patch + (s + r0 + i) * PS, o, t0, t1, sx == 0);
#pragma unroll
    for (int r = 0; r < SH; ++r) {
      int acc = K::V;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += f[k] * h[r + k];
      if (real) out[(s + r) * N] = K::clip(acc);
    }
  }
}

template <typename T, int N, int L>
int launch_pred(const int* src_b, const T* ref, const int* ys, const int* xs, const int* mv_fp,
                const int* ftab, int* mv_out, int* pred_out, int B, int H, int W,
                cudaStream_t st) {
  constexpr int BPC = 256 / N;
  subpel_pred_kernel<T, N, L><<<(B + BPC - 1) / BPC, 256, 0, st>>>(
      src_b, ref, ys, xs, mv_fp, ftab, mv_out, pred_out, B, H, W);
  return launch_status();
}

template <typename T>
int subpel_pred(const int* src_b, const T* ref, const int* ys, const int* xs, const int* mv_fp,
                const int* ftab, int* mv_out, int* pred_out, int B, int H, int W, int n, int fast,
                cudaStream_t st) {
  if (B == 0) return 0;
  const auto args = [&](auto launch) {
    return launch(src_b, ref, ys, xs, mv_fp, ftab, mv_out, pred_out, B, H, W, st);
  };
  switch (n * 2 + (fast ? 1 : 0)) {
    case 17: return args(launch_pred<T, 8, 5>);
    case 16: return args(launch_pred<T, 8, 7>);
    case 33: return args(launch_pred<T, 16, 5>);
    case 32: return args(launch_pred<T, 16, 7>);
    case 65: return args(launch_pred<T, 32, 5>);
    case 64: return args(launch_pred<T, 32, 7>);
    case 129: return args(launch_pred<T, 64, 5>);
    case 128: return args(launch_pred<T, 64, 7>);
    default: return (int)cudaErrorInvalidValue;
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
// column phases per step over n+8 rows, against (n+8)^2 reference and n^2
// int32 reads). Design: one block per lane, patch and source in shared
// memory as K9; per step the horizontal pass runs once per candidate column
// into shared memory and serves that column's three rows.
//
// 10 bits (subpel_refine16_launch): the same kernel on int16 planes, a
// template on the sample type. The patch is int16 in shared memory at both
// depths (0..1023 need no bias); hpass accumulates in int from 2^(bd+6) and
// vpass takes its offsets and clip from bd, and a 16x16 SAD (at most
// 256 x 1023) fits an int.
template <typename T>
__global__ void subpel_refine_kernel(const int* __restrict__ src_b, const T* __restrict__ ref,
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

template <typename T>
int subpel_refine(const int* src_b, const T* ref, const int* ys, const int* xs, const int* mv_fp,
                  const int* ftab, int* mv_out, int B, int H, int W, int n, int bd,
                  cudaStream_t st) {
  if (B == 0) return 0;
  const int P = n + 8;
  const int threads = n * n >= 256 ? 256 : n * n;
  const size_t shm = (size_t)P * n * sizeof(int) + (size_t)(P * P + n * n) * sizeof(short);
  subpel_refine_kernel<T><<<B, threads, shm, st>>>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, H, W,
                                                   n, bd);
  return launch_status();
}

}  // namespace

extern "C" int subpel_refine_launch(const int* src_b, const uint8_t* ref, const int* ys,
                                    const int* xs, const int* mv_fp, const int* ftab,
                                    int* mv_out, int B, int H, int W, int n, int bd,
                                    void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 references: 8-bit only
  return subpel_refine<uint8_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, n, bd,
                                (cudaStream_t)stream);
}

extern "C" int subpel_refine16_launch(const int* src_b, const int16_t* ref, const int* ys,
                                      const int* xs, const int* mv_fp, const int* ftab,
                                      int* mv_out, int B, int H, int W, int n, int bd,
                                      void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // the 10-bit offsets and clip
  return subpel_refine<int16_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, n, bd,
                                (cudaStream_t)stream);
}

extern "C" int subpel_pred_launch(const int* src_b, const uint8_t* ref, const int* ys, const int* xs,
                                  const int* mv_fp, const int* ftab, int* mv_out, int* pred_out,
                                  int B, int H, int W, int n, int bd, int fast, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 references: 8-bit only
  return subpel_pred<uint8_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, pred_out, B, H, W, n, fast,
                              (cudaStream_t)stream);
}

extern "C" int subpel_pred16_launch(const int* src_b, const int16_t* ref, const int* ys,
                                    const int* xs, const int* mv_fp, const int* ftab, int* mv_out,
                                    int* pred_out, int B, int H, int W, int n, int bd, int fast,
                                    void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // the 10-bit offsets and clip
  return subpel_pred<int16_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, pred_out, B, H, W, n, fast,
                              (cudaStream_t)stream);
}
