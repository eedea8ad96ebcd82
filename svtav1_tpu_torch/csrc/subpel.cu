// The subpel searches on the 1/8-pel lattice around a full-pel MV, both on
// one design: a lane per column of a block, several blocks per CTA, one
// (n+8)^2 patch per block read at mv_fp - 4 with clamped coordinates and
// staged once (signed bytes at 8 bits, int16 at 10), the column's horizontal
// intermediate and its partial SADs in registers, packed int8 x int8 and
// int16 x int8 dot products (IDP.4A, IDP.2A) for the two passes. Every
// lattice point is normative MC (8-tap, ROUND0/ROUND1, clip) from the patch.
//
// K9 subpel_pred returns the winner's MV and its prediction:
//   fast: the 25 points {-4,-2,0,2,4}^2, the first SAD minimum in (dy, dx)
//         raster order;
//   else: the 49 points {-6..6}^2 step 2, then the reference's two stages:
//         the half-pel 9 points {-4,0,4}^2 (first minimum), then the 8
//         quarter-pel points {-2,0,2}^2 around its winner in raster order,
//         each taken only if its SAD is strictly smaller.
// The prediction equals K10 (mc_lanes) at the returned MV. Replaces
// svtav1_tpu/ops/me_jax.py::subpel_pred_lanes with :258 extract_patches and
// :269 _mc_patch_static (the decide's subpel step of every block of every
// size against each reference).
//
// K14 subpel_refine returns the MV of the TPL's two-step refinement (below).
//
// Bound: operations. A block reads (n+8)^2 reference and n^2 int32 source
// samples and writes an MV (and K9 n^2 int32), but computes 25, 49 or 17
// predictions of n^2 samples (8 vertical multiply-adds, an absolute
// difference and a sum each) and the horizontal pass of 5, 7 or 6 column
// phases over n+8 rows. The packed arithmetic rests on three facts of the
// filter tables (tests/test_torch_me.py holds them): every tap but phase 0's
// 128 fits int8, every phase sums to 128, and the horizontal intermediate,
// in [263, 7913] at 8 bits and [1031, 31721] at 10, is a positive int16.
//
// 10 bits (subpel_pred16_launch, subpel_refine16_launch): the same kernels on
// int16 planes, templates on the sample type. The patch holds the samples as
// int16 (0..1023 need no bias), and the horizontal pass takes four IDP.2A
// (int16 sample pairs by int8 taps) instead of two IDP.4A; the vertical pass
// and the winner rules are the 8-bit kernels', with 10-bit offsets and clip.
// Each C entry refuses the other depth.
#include "taps.cuh"

namespace {

// The layout of a CTA of 256 threads holding 256 / N blocks of N lanes (a
// group of N lanes inside one warp up to N = 32, two warps at N = 64), a
// block cut into strips of SH output rows.
template <typename T, int N>
struct Lanes {
  static constexpr int P = N + 8, PS = N + 12;  // patch side; row stride (the last word read overhangs)
  static constexpr int BPC = 256 / N;           // blocks per CTA
  static constexpr int G = N < 32 ? N : 32;     // a block's lanes inside one warp
  static constexpr int WPB = N / G;             // warps per block
  static constexpr int SH = N < 16 ? N : 16;    // output rows per strip
  static constexpr int NH = SH + 8;             // intermediate rows per strip
  // words per patch; the groups of one warp start on banks G apart
  static constexpr int PW = (P * PS * (int)sizeof(T) + 3) / 4;
  static constexpr int PBW = G < 32 ? (PW + 31) / 32 * 32 + G : PW;
};

// The block's (N+8)^2 patch at (py, px), clamped to the plane, staged by its
// N lanes (8 bits: signed bytes, as hsample takes them).
template <typename T, int N>
__device__ __forceinline__ void stage_patch(T* patch, const T* __restrict__ ref, int py, int px,
                                            int c, int H, int W) {
  constexpr int P = Lanes<T, N>::P, PS = Lanes<T, N>::PS;
  for (int i = c; i < P * P; i += N) {
    const int r = i / P, cc = i - r * P;
    const T v = ref[(size_t)clampi(py + r, 0, H - 1) * W + clampi(px + cc, 0, W - 1)];
    patch[r * PS + cc] = Bd<T>::B8 ? (T)(v ^ 0x80) : v;
  }
}

// A strip's column intermediate h[0 .. NH-1] from the patch row `rows` on, at
// byte or sample offset o with the phase's packed taps (t0, t1; copy: phase
// 0), as int16 pairs aligned at even rows, E[i] = (h[2i], h[2i+1]), and at
// odd rows, Od[i] = (h[2i+1], h[2i+2]); row by row, so that only the last
// intermediate stays live.
template <typename T, int NH, int PS>
__device__ __forceinline__ void hcolumn(const T* rows, int o, int t0, int t1, bool copy,
                                        unsigned (&E)[NH / 2], unsigned (&Od)[NH / 2 - 1]) {
  using K = Bd<T>;
  int prev = K::h(rows, o, t0, t1, copy);
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) {
    const int odd = K::h(rows + (2 * i + 1) * PS, o, t0, t1, copy);
    E[i] = __byte_perm(prev, odd, 0x5410);
    if (i < NH / 2 - 1) {
      prev = K::h(rows + (2 * i + 2) * PS, o, t0, t1, copy);
      Od[i] = __byte_perm(odd, prev, 0x5410);
    }
  }
}

// ---- K9: the lattice's column phases in turn ----

// The lattice point j's offset in 1/8 pel: -(L-1) + 2j (-4..4 or -6..6).
// Per column phase, a lane computes its column's horizontal intermediate
// over a strip of SH + 8 rows (hcolumn) and runs every vertical phase from
// those registers (IDP.2A; the centre phase is a copy), adding |pred - src|
// with one VABSDIFF into a partial SAD per lattice row. The partials are
// summed across the group with shuffles; the totals go to shared memory,
// and every lane picks the same winner from them; each lane then recomputes
// and writes its column at the winner. No CTA barrier after the staging,
// except the sum of N = 64's two warps.
// Two CTAs per SM: ptxas may then take up to 128 registers (77-89); held to
// one CTA's bound it settles on 64 and spilled at N = 16, L = 7.
template <typename T, int N, int L>
__global__ void __launch_bounds__(256, 2)
subpel_pred_kernel(const int* __restrict__ src_b, const T* __restrict__ ref,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   const int* __restrict__ mv_fp, const int* __restrict__ ftab,
                   int* __restrict__ mv_out, int* __restrict__ pred_out, int B, int H, int W) {
  using LN = Lanes<T, N>;
  constexpr int PS = LN::PS, BPC = LN::BPC, G = LN::G, WPB = LN::WPB, SH = LN::SH, NH = LN::NH;
  constexpr int LL = L * L;
  using K = Bd<T>;
  __shared__ __align__(16) unsigned patches[BPC * LN::PBW + 4];
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
  T* patch = (T*)(patches + slot * LN::PBW);
  const int mfy = mv_fp[2 * b], mfx = mv_fp[2 * b + 1];
  stage_patch<T, N>(patch, ref, ys[b] + mfy - 4, xs[b] + mfx - 4, c, H, W);
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
      unsigned E[NH / 2], Od[NH / 2 - 1];
      hcolumn<T, NH, PS>(patch + s * PS, o, t0, t1, sx == 0, E, Od);
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

// ---- K14: the TPL's two-step refinement ----

// K14 subpel_refine: the TPL's two-step refinement (half pel, then quarter
// pel): nine candidates per step around the current MV in (dy, dx) raster
// order, dy major, from (-1, -1) to (1, 1), the second step centred on the
// first step's winner; each step takes the FIRST SAD minimum, so a corner
// that ties the centre wins. Both steps stay inside +-3/4 pel of the
// full-pel MV, K9's {-6..6} step-2 lattice (indices 0..6, offset 2j - 6):
// step 1 tries the indices {1, 3, 5}^2, step 2 the 3 x 3 around its winner.
// Returns the 1/8-pel MV only.
//
// Replaces svtav1_tpu/ops/me_jax.py::subpel_refine_lanes (the TPL
// dispenser's subpel step, svtav1_tpu/pipeline/tpl.py:92).
//
// Design: K9's lanes and patch. Per step, three column phases; per column
// the horizontal intermediate of each strip in registers (hcolumn), the
// step's three row phases from it, each a 9-tap window h[r..r+8] (the
// phase's 8 taps at row offset 0 or 1, so that a runtime phase needs no
// runtime register index) by five IDP.2A, the centre row at phase 0 a copy.
// The group's partial SADs are summed by shuffles and every lane picks the
// same winner. Step 2 needs no reload: its columns and rows are chosen from
// step 1's winner, and its centre is that winner, whose SAD is reused (it
// still takes part in the first-minimum order, at index 4).

// The packed taps of the 9-tap window of row offset r0 and phase sy: w =
// (f0..f7, 0) at r0 = 0, (0, f0..f7) at r0 = 1; words w0-3, w4-7, and w8 in
// bytes 0 and 3 (IDP.2A lo of the pair (h[r+8], h[r+9]) at even r, hi of
// (h[r+7], h[r+8]) at odd r).
__device__ __forceinline__ void pack_window(const int* f, int r0, unsigned (&u)[3]) {
  int w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int j = k - r0;
    w[k] = j >= 0 && j < 8 ? f[j] : 0;
  }
  u[0] = pack_taps4(w);
  u[1] = pack_taps4(w + 4);
  u[2] = (unsigned)(w[8] & 255) | ((unsigned)w[8] << 24);
}

// The window's vertical sum at output row r of a strip, from K::V.
template <typename T, int NH>
__device__ __forceinline__ int vwindow(const unsigned (&E)[NH / 2], const unsigned (&Od)[NH / 2 - 1],
                                       int r, const unsigned (&u)[3]) {
  unsigned pr[4];  // the int16 pairs (h[r + 2m], h[r + 2m + 1])
#pragma unroll
  for (int m = 0; m < 4; ++m) pr[m] = (r & 1) ? Od[(r >> 1) + m] : E[(r >> 1) + m];
  int acc = __dp2a_lo((int)pr[0], (int)u[0], Bd<T>::V);
  acc = __dp2a_hi((int)pr[1], (int)u[0], acc);
  acc = __dp2a_lo((int)pr[2], (int)u[1], acc);
  acc = __dp2a_hi((int)pr[3], (int)u[1], acc);
  return (r & 1) ? __dp2a_hi((int)E[(r + 7) >> 1], (int)u[2], acc)
                 : __dp2a_lo((int)E[(r + 8) >> 1], (int)u[2], acc);
}

template <typename T, int N>
__global__ void __launch_bounds__(256, 2)
subpel_refine_kernel(const int* __restrict__ src_b, const T* __restrict__ ref,
                     const int* __restrict__ ys, const int* __restrict__ xs,
                     const int* __restrict__ mv_fp, const int* __restrict__ ftab,
                     int* __restrict__ mv_out, int B, int H, int W) {
  using LN = Lanes<T, N>;
  constexpr int PS = LN::PS, BPC = LN::BPC, G = LN::G, WPB = LN::WPB, SH = LN::SH, NH = LN::NH;
  using K = Bd<T>;
  __shared__ __align__(16) unsigned patches[BPC * LN::PBW + 4];
  __shared__ int tpk[16][2];           // the horizontal taps per phase
  __shared__ unsigned win[2][16][3];   // the vertical 9-tap windows per row offset and phase
  __shared__ int tot[2][BPC][WPB][9];  // per step, the group sums of the nine candidates
  const int tid = threadIdx.x, slot = tid / N, c = tid - slot * N;
  const int bb = blockIdx.x * BPC + slot, b = min(bb, B - 1);
  if (tid < 32) tpk[tid >> 1][tid & 1] = (int)pack_taps4(ftab + 4 * tid);
  else if (tid < 64) {
    unsigned u[3];
    pack_window(ftab + 8 * ((tid - 32) >> 1), tid & 1, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) win[tid & 1][(tid - 32) >> 1][k] = u[k];
  }
  T* patch = (T*)(patches + slot * LN::PBW);
  const int mfy = mv_fp[2 * b], mfx = mv_fp[2 * b + 1];
  stage_patch<T, N>(patch, ref, ys[b] + mfy - 4, xs[b] + mfx - 4, c, H, W);
  __syncthreads();

  const int* S = src_b + (size_t)b * N * N + c;
  int cy = 3, cx = 3, d = 2;  // lattice indices of the current MV, the step's spacing
  unsigned centre = 0;        // step 2: its centre's SAD, step 1's least
  for (int step = 0; step < 2; ++step) {
    unsigned u[3][3];  // the step's three row windows
    bool copy1;        // the middle row at phase 0 (a copy of h[r + 4])
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int fy0 = 4 * (cy + (a - 1) * d) - 12;  // 1/16 pel
      const int r0 = 1 + (fy0 >> 4), sy = fy0 & 15;
#pragma unroll
      for (int k = 0; k < 3; ++k) u[a][k] = win[r0][sy][k];
      if (a == 1) copy1 = sy == 0;
    }
    for (int col = 0; col < 3; ++col) {
      const int fx0 = 4 * (cx + (col - 1) * d) - 12;
      const int o = c + 1 + (fx0 >> 4), sx = fx0 & 15;
      const int t0 = tpk[sx][0], t1 = tpk[sx][1];
      const bool skip_centre = step == 1 && col == 1;
      unsigned part[3] = {0, 0, 0};
      for (int s = 0; s < N; s += SH) {
        int sv[SH];
#pragma unroll
        for (int r = 0; r < SH; ++r) sv[r] = S[(s + r) * N];
        unsigned E[NH / 2], Od[NH / 2 - 1];
        hcolumn<T, NH, PS>(patch + s * PS, o, t0, t1, sx == 0, E, Od);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (a == 1 && skip_centre) continue;
#pragma unroll
          for (int r = 0; r < SH; ++r) {
            int acc = vwindow<T, NH>(E, Od, r, u[a]);
            if (a == 1 && copy1) {  // h[r + 4] is the low half of the third pair
              const unsigned p2 = (r & 1) ? Od[(r >> 1) + 2] : E[(r >> 1) + 2];
              acc = K::V + ((int)(p2 & 0xffffu) << 7);
            }
            part[a] = __sad(K::clip(acc), sv[r], part[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        unsigned v = part[a];
        for (int m = G / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
        if ((c & (G - 1)) == 0) tot[step][slot][c / G][a * 3 + col] = (int)v;
      }
    }
    if (WPB > 1) __syncthreads();
    else __syncwarp();
    // the first minimum of the nine in raster order, the same in every lane
    unsigned best = ~0u;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      unsigned t = 0;
#pragma unroll
      for (int w = 0; w < WPB; ++w) t += (unsigned)tot[step][slot][w][k];
      if (step == 1 && k == 4) t = centre;
      best = min(best, (t << 4) | (unsigned)k);  // a 64x64 SAD at 10 bits < 2^22
    }
    const int k = (int)(best & 15);
    centre = best >> 4;
    cy += (k / 3 - 1) * d;
    cx += (k % 3 - 1) * d;
    d = 1;
  }
  if (bb < B && c == 0) {
    mv_out[2 * b] = mfy * 8 + 2 * cy - 6;
    mv_out[2 * b + 1] = mfx * 8 + 2 * cx - 6;
  }
}

template <typename T, int N>
int launch_refine(const int* src_b, const T* ref, const int* ys, const int* xs, const int* mv_fp,
                  const int* ftab, int* mv_out, int B, int H, int W, cudaStream_t st) {
  constexpr int BPC = 256 / N;
  subpel_refine_kernel<T, N><<<(B + BPC - 1) / BPC, 256, 0, st>>>(src_b, ref, ys, xs, mv_fp,
                                                                    ftab, mv_out, B, H, W);
  return launch_status();
}

template <typename T>
int subpel_refine(const int* src_b, const T* ref, const int* ys, const int* xs, const int* mv_fp,
                  const int* ftab, int* mv_out, int B, int H, int W, int n, cudaStream_t st) {
  if (B == 0) return 0;
  const auto args = [&](auto launch) {
    return launch(src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, st);
  };
  switch (n) {
    case 8: return args(launch_refine<T, 8>);
    case 16: return args(launch_refine<T, 16>);
    case 32: return args(launch_refine<T, 32>);
    case 64: return args(launch_refine<T, 64>);
    default: return (int)cudaErrorInvalidValue;  // blocks 8, 16, 32 or 64 wide
  }
}

}  // namespace

extern "C" int subpel_refine_launch(const int* src_b, const uint8_t* ref, const int* ys,
                                    const int* xs, const int* mv_fp, const int* ftab,
                                    int* mv_out, int B, int H, int W, int n, int bd,
                                    void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 references: 8-bit only
  return subpel_refine<uint8_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, n,
                                (cudaStream_t)stream);
}

extern "C" int subpel_refine16_launch(const int* src_b, const int16_t* ref, const int* ys,
                                      const int* xs, const int* mv_fp, const int* ftab,
                                      int* mv_out, int B, int H, int W, int n, int bd,
                                      void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // the 10-bit offsets and clip
  return subpel_refine<int16_t>(src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, n,
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
