// K10 mc_lanes: batched normative AV1 subpel motion compensation (spec
// 7.11.3.4, single prediction) with a per-lane position and phase: the 8-tap
// (or, for a dimension <= 4, the 4-tap) kernels of the lane's 1/16-pel
// phases, the horizontal pass rounded by ROUND0 into an int16 intermediate,
// the vertical pass rounded by ROUND1, the result clipped to [0, 2^bd - 1].
// Reference samples are read with each coordinate clamped to the plane, from
// one plane or from a (NREF, H, W) stack by the lane's ref index. One launch
// takes up to three planes of one shape that share the lanes (positions, MVs,
// ref indices, dimensions) and writes (P, B, n_h, n_w) int32.
//
// Replaces svtav1_tpu/ops/me_jax.py::mc_lanes (conv_buf=False), which the
// inter decide calls for the chroma of every block at its winning MV and for
// the GLOBALMV lane, the commit for the Y, U and V of every inter block, MCTF
// for the chroma of its neighbours and TPL for the pair of reference planes.
//
// Bound: bytes. A lane reads its (n_h+7)(n_w+7) patch (mostly from L2:
// neighbouring lanes overlap) and writes n_h*n_w int32 samples; the work is
// two packed dot products per horizontal intermediate sample and four per
// output sample. The first port's design (one CTA per lane, an int32 patch
// and an int32 intermediate in shared memory, two CTA barriers, the taps
// reloaded per CTA) waited on latency: 13 to 26 times its bound. Design:
// lanes packed into warps, a thread per output column (a 4x4 lane is 4
// threads, 8 lanes to a warp; a 64-wide lane 32 threads of two columns
// each), a lane cut into strips of 8 output rows (4 for a 4x4 lane), so that
// few large lanes still fill the card; a strip's threads stage its clamped
// patch as 8- or 16-bit samples with word loads, several in flight (row
// words from the first sample's word, so the phase of the row start is an
// offset into the staged row), and synchronise their warp only; each thread
// then runs the horizontal pass down its column (K9's IDP.4A / IDP.2A
// passes, taps.cuh) and keeps the last 8 intermediates as 7 int16 pairs in
// registers, from which the vertical pass emits an output row per step with
// four IDP.2A; phase 0 is a copy in both passes. The taps of the 16 phases
// are packed once per CTA.
//
// Both forms are one template on the sample type: uint8_t planes at 8 bits
// (mc_lanes_launch), int16_t planes at 10 bits (mc_lanes16_launch); each entry
// refuses the other depth.
//
// K11 mc_compound: compound-average MC (spec 7.11.3.4 with InterRound1 =
// COMPOUND_ROUND1, then the average blend of 7.11.3.15 without distance
// weights). Replaces svtav1_tpu/ops/me_jax.py::mc_lanes_compound (its two
// mc_lanes(conv_buf=True) passes and compound_average_j), which the commit's
// phase A runs for the Y, U and V of every NEW_NEWMV block of a
// hierarchical-B frame. Bound: operations (two 8-tap passes per reference at
// the int32 rate, 0.0063 ms for 32,400 8x8 lanes on an H100), with the bytes
// (two uint8 patches per lane, mostly from L2) close behind.
// Design (the first port's, still): one block per lane; the clamped patch is
// staged in shared memory once per reference, the horizontal pass writes the
// intermediate rows to shared memory, the vertical pass reads them; the two
// references are filtered in turn through the same shared patch and
// intermediate, and the first conv-buf prediction is kept in shared memory
// (each thread rereads only the samples it wrote), so the offset-carrying
// intermediate never leaves the block; the second pass blends and writes.
#include "taps.cuh"

namespace {

constexpr int FILTER_BITS = 7, ROUND0 = 3, ROUND1 = 11, COMPOUND_ROUND1 = 7;
static_assert(2 * FILTER_BITS - ROUND0 - ROUND1 == 0, "no third rounding stage");

constexpr int MC_THREADS = 128;
constexpr int MC_PLANES = 3;  // planes of one launch
constexpr int MC_INFLIGHT = 8;  // staging loads a thread issues before it stores them

// One thread per output column of a strip of SH rows of a lane; a strip's G
// threads lie in one warp.
template <typename T, int NW>
__global__ void __launch_bounds__(MC_THREADS)
mc_lanes_kernel(const T* __restrict__ ref0, const T* __restrict__ ref1,
                const T* __restrict__ ref2, const int* __restrict__ ys,
                const int* __restrict__ xs, const int* __restrict__ mvy,
                const int* __restrict__ mvx, const int* __restrict__ ref_idx,
                const int* __restrict__ ftab_x, const int* __restrict__ ftab_y,
                int* __restrict__ out, int B, int nref, int H, int W, int nh) {
  using K = Bd<T>;
  constexpr int G = NW < 32 ? NW : 32;  // a lane's threads
  constexpr int CPT = NW / G;           // columns per thread
  constexpr int LPC = MC_THREADS / G;   // strips per CTA
  constexpr int SH = NW < 8 ? NW : 8;   // output rows per strip
  constexpr int SPW = 4 / (int)sizeof(T);  // samples per word
  // words of a staged row: from the word of the lane's first sample through
  // the last word the horizontal pass of column NW - 1 reads (hsample reads
  // three words from its offset's word, hsample16 five)
  constexpr int WR = K::B8 ? NW / 4 + 3 : NW / 2 + 5;
  extern __shared__ unsigned patches[];
  __shared__ unsigned tpk[2][16][2];  // [x, y][phase][taps 0-3, taps 4-7]
  const int tid = threadIdx.x;
  if (tid < 64) tpk[tid >> 5][(tid & 31) >> 1][tid & 1] =
      pack_taps4((tid < 32 ? ftab_x : ftab_y) + 4 * (tid & 31));
  __syncthreads();
  const int slot = tid / G, t = tid - slot * G;
  const int strips = (nh + SH - 1) / SH;
  const int task = blockIdx.x * LPC + slot;  // a lane's strips one after another
  if (task >= B * strips) return;  // whole strips only: the warp sync below masks its strip
  const int b = task / strips, r0 = (task - b * strips) * SH;
  const int nr = min(SH, nh - r0);  // the strip's output rows
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1) << (tid & 31 & -G);
  const int pl = blockIdx.y;
  const T* ref = pl == 0 ? ref0 : (pl == 1 ? ref1 : ref2);
  const int rows = nr + 7;
  unsigned* patch = patches + slot * (SH + 7) * WR;
  // floor of negative positions and phases: >> and & 15 as the reference
  const int fy0 = ys[b] * 16 + mvy[b], fx0 = xs[b] * 16 + mvx[b];
  const int iy = (fy0 >> 4) + r0, sy = fy0 & 15, ix = fx0 >> 4, sx = fx0 & 15;
  const int ri = ref_idx ? clampi(ref_idx[b], 0, nref - 1) : 0;
  const T* R = ref + (size_t)ri * H * W;
  const int s0 = ix - 3, a = s0 & -SPW;  // the first sample and its word's
  const bool whole = a >= 0 && a + WR * SPW <= W && W % SPW == 0 && ((size_t)R & 3) == 0;
  const unsigned bias = K::B8 ? 0x80808080u : 0u;  // 8 bits: signed bytes, as hsample takes them
  auto word_at = [&](int i) {
    const int r = i / WR;
    return (const unsigned*)(R + (size_t)clampi(iy - 3 + r, 0, H - 1) * W + a) + (i - r * WR);
  };
  if (whole) {  // MC_INFLIGHT loads in flight per thread, then their stores
    for (int i0 = t; i0 < rows * WR; i0 += G * MC_INFLIGHT) {
      unsigned v[MC_INFLIGHT];
#pragma unroll
      for (int u = 0; u < MC_INFLIGHT; ++u) {
        const int i = i0 + u * G;
        v[u] = i < rows * WR ? __ldg(word_at(i)) : 0u;
      }
#pragma unroll
      for (int u = 0; u < MC_INFLIGHT; ++u)
        if (i0 + u * G < rows * WR) patch[i0 + u * G] = v[u] ^ bias;
    }
  } else {  // a word past an edge: its samples one by one, clamped
    for (int i = t; i < rows * WR; i += G) {
      const int r = i / WR, j = i - r * WR;
      const T* row = R + (size_t)clampi(iy - 3 + r, 0, H - 1) * W;
      unsigned v = 0;
#pragma unroll
      for (int k = 0; k < SPW; ++k) {
        const T smp = row[clampi(a + j * SPW + k, 0, W - 1)];
        v |= (K::B8 ? (unsigned)(uint8_t)smp : (unsigned)(uint16_t)smp) << (32 / SPW * k);
      }
      patch[i] = v ^ bias;
    }
  }
  __syncwarp(mask);

  const int d = s0 - a;  // the lane's first sample within its first word
  const int t0 = (int)tpk[0][sx][0], t1 = (int)tpk[0][sx][1];
  const int u0 = (int)tpk[1][sy][0], u1 = (int)tpk[1][sy][1];
  auto hrow = [&](int r, int c) {
    return K::h((const T*)(patch + r * WR), d + c, t0, t1, sx == 0);
  };
  int last[CPT];          // the newest intermediate of each column
  unsigned win[CPT][7];   // int16 pairs (h[r + k], h[r + k + 1]), k = 0..6
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    last[cc] = hrow(0, t + cc * G);
#pragma unroll
    for (int r = 1; r < 7; ++r) {
      const int h = hrow(r, t + cc * G);
      win[cc][r - 1] = __byte_perm(last[cc], h, 0x5410);
      last[cc] = h;
    }
  }
  int* o = out + (((size_t)pl * B + b) * nh + r0) * NW + t;
#pragma unroll
  for (int r = 0; r < SH; ++r) {
    if (r == nr) break;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int h = hrow(r + 7, t + cc * G);
      win[cc][6] = __byte_perm(last[cc], h, 0x5410);
      last[cc] = h;
      int acc = __dp2a_lo((int)win[cc][0], u0, K::V);
      acc = __dp2a_hi((int)win[cc][2], u0, acc);
      acc = __dp2a_lo((int)win[cc][4], u1, acc);
      acc = __dp2a_hi((int)win[cc][6], u1, acc);
      if (sy == 0) acc = K::V + ((int)(win[cc][3] & 0xffffu) << 7);  // phase 0: h[r + 3]
      o[r * NW + cc * G] = K::clip(acc);
#pragma unroll
      for (int k = 0; k < 6; ++k) win[cc][k] = win[cc][k + 1];
    }
  }
}

// Stage the clamped (nh+7) x (nw+7) patch of plane R around (iy, ix) and run
// the horizontal pass into im; ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void mc_horizontal(const T* __restrict__ R, int H, int W, int iy,
                                              int ix, const int* fx, int* patch, int* im, int nh,
                                              int nw, int bd) {
  const int ph = nh + 7, pw = nw + 7;
  for (int i = threadIdx.x; i < ph * pw; i += blockDim.x) {
    const int r = i / pw, c = i - r * pw;
    const int gy = clampi(iy - 3 + r, 0, H - 1), gx = clampi(ix - 3 + c, 0, W - 1);
    patch[i] = R[(size_t)gy * W + gx];
  }
  __syncthreads();
  const int hbase = 1 << (bd + FILTER_BITS - 1);
  for (int i = threadIdx.x; i < ph * nw; i += blockDim.x) {
    const int r = i / nw, c = i - r * nw;
    const int* p = patch + r * pw + c;
    int acc = hbase;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fx[k] * p[k];
    im[i] = (acc + (1 << (ROUND0 - 1))) >> ROUND0;
  }
  __syncthreads();
}

template <typename T>
__global__ void mc_compound_kernel(const T* __restrict__ ref, const int* __restrict__ ys,
                                   const int* __restrict__ xs, const int* __restrict__ mv0y,
                                   const int* __restrict__ mv0x, const int* __restrict__ mv1y,
                                   const int* __restrict__ mv1x, const int* __restrict__ ref0,
                                   const int* __restrict__ ref1, const int* __restrict__ ftab_x,
                                   const int* __restrict__ ftab_y, int* __restrict__ out, int nref,
                                   int H, int W, int nh, int nw, int bd) {
  extern __shared__ int smem[];
  __shared__ int fx[2][8], fy[2][8];
  const int b = blockIdx.x;
  const int total = nh * nw;
  int* patch = smem;                     // (nh+7) x (nw+7)
  int* im = patch + (nh + 7) * (nw + 7);  // (nh+7) x nw
  int* conv0 = im + (nh + 7) * nw;        // nh x nw, the first prediction
  const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
  const int sub = (1 << (offset_bits - COMPOUND_ROUND1)) + (1 << (offset_bits - COMPOUND_ROUND1 - 1));
  constexpr int round_bits = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1;
  const int maxv = (1 << bd) - 1;
  int* o = out + (size_t)b * total;
  for (int pass = 0; pass < 2; ++pass) {
    // floor of negative positions and phases: >> and & 15 as the reference
    const int fy0 = ys[b] * 16 + (pass ? mv1y[b] : mv0y[b]);
    const int fx0 = xs[b] * 16 + (pass ? mv1x[b] : mv0x[b]);
    const int iy = fy0 >> 4, sy = fy0 & 15;
    const int ix = fx0 >> 4, sx = fx0 & 15;
    const int ri = clampi(pass ? ref1[b] : ref0[b], 0, nref - 1);
    if (threadIdx.x < 8) {
      fx[pass][threadIdx.x] = ftab_x[sx * 8 + threadIdx.x];
      fy[pass][threadIdx.x] = ftab_y[sy * 8 + threadIdx.x];
    }
    // the previous pass's vertical reads of im end here
    __syncthreads();
    mc_horizontal(ref + (size_t)ri * H * W, H, W, iy, ix, fx[pass], patch, im, nh, nw, bd);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / nw, c = i - r * nw;
      int acc = 1 << offset_bits;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc += fy[pass][t] * im[(r + t) * nw + c];
      const int conv = (acc + (1 << (COMPOUND_ROUND1 - 1))) >> COMPOUND_ROUND1;
      if (pass == 0) {
        conv0[i] = conv;
      } else {
        const int tmp = ((conv0[i] + conv) >> 1) - sub;
        o[i] = clampi((tmp + (1 << (round_bits - 1))) >> round_bits, 0, maxv);
      }
    }
  }
}

template <typename T, int NW>
int launch_mc_lanes_nw(const T* r0, const T* r1, const T* r2, const int* ys, const int* xs,
                       const int* mvy, const int* mvx, const int* ref_idx, const int* ftab_x,
                       const int* ftab_y, int* out, int P, int B, int nref, int H, int W, int nh,
                       void* stream) {
  constexpr int G = NW < 32 ? NW : 32, LPC = MC_THREADS / G, SH = NW < 8 ? NW : 8;
  constexpr int WR = sizeof(T) == 1 ? NW / 4 + 3 : NW / 2 + 5;
  constexpr size_t shm = (size_t)LPC * (SH + 7) * WR * sizeof(unsigned);
  static_assert(shm <= 48 * 1024, "a CTA's patches fit the default shared memory");
  const long long tasks = (long long)B * ((nh + SH - 1) / SH);
  const dim3 grid((unsigned)((tasks + LPC - 1) / LPC), P);
  mc_lanes_kernel<T, NW><<<grid, MC_THREADS, shm, (cudaStream_t)stream>>>(
      r0, r1, r2, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, B, nref, H, W, nh);
  return launch_status();
}

template <typename T>
int launch_mc_lanes(const T* r0, const T* r1, const T* r2, const int* ys, const int* xs,
                    const int* mvy, const int* mvx, const int* ref_idx, const int* ftab_x,
                    const int* ftab_y, int* out, int P, int B, int nref, int H, int W, int nh,
                    int nw, void* stream) {
  if (P < 1 || P > MC_PLANES || nh < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
#define MC_NW(N)                                                                              \
  case N:                                                                                     \
    return launch_mc_lanes_nw<T, N>(r0, r1, r2, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, \
                                    P, B, nref, H, W, nh, stream);
  switch (nw) {
    MC_NW(4)
    MC_NW(8)
    MC_NW(16)
    MC_NW(32)
    MC_NW(64)
    default:
      return (int)cudaErrorInvalidValue;  // lanes 4, 8, 16, 32 or 64 wide
  }
#undef MC_NW
}

template <typename T>
int launch_mc_compound(const T* ref, const int* ys, const int* xs, const int* mv0y,
                       const int* mv0x, const int* mv1y, const int* mv1x, const int* ref0,
                       const int* ref1, const int* ftab_x, const int* ftab_y, int* out, int B,
                       int nref, int H, int W, int nh, int nw, int bd, void* stream) {
  if (B == 0) return 0;
  const int outs = nh * nw;
  const int threads = outs >= 256 ? 256 : (outs + 31) / 32 * 32;
  const size_t shm = (size_t)((nh + 7) * (nw + 7) + (nh + 7) * nw + nh * nw) * sizeof(int);
  // 64x64 lanes: 54.7 KB, above the default limit
  if (const int err = allow_smem(mc_compound_kernel<T>, shm)) return err;
  mc_compound_kernel<T><<<B, threads, shm, (cudaStream_t)stream>>>(
      ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out, nref, H, W, nh, nw, bd);
  return launch_status();
}

}  // namespace

// ref1, ref2: NULL past the P planes
extern "C" int mc_lanes_launch(const uint8_t* ref0, const uint8_t* ref1, const uint8_t* ref2,
                               const int* ys, const int* xs, const int* mvy, const int* mvx,
                               const int* ref_idx, const int* ftab_x, const int* ftab_y, int* out,
                               int P, int B, int nref, int H, int W, int nh, int nw, int bd,
                               void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes: 8-bit only
  return launch_mc_lanes(ref0, ref1, ref2, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, P, B,
                         nref, H, W, nh, nw, stream);
}

extern "C" int mc_lanes16_launch(const int16_t* ref0, const int16_t* ref1, const int16_t* ref2,
                                 const int* ys, const int* xs, const int* mvy, const int* mvx,
                                 const int* ref_idx, const int* ftab_x, const int* ftab_y,
                                 int* out, int P, int B, int nref, int H, int W, int nh, int nw,
                                 int bd, void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // int16 planes: the 10-bit constants
  return launch_mc_lanes(ref0, ref1, ref2, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, P, B,
                         nref, H, W, nh, nw, stream);
}

extern "C" int mc_compound_launch(const uint8_t* ref, const int* ys, const int* xs, const int* mv0y,
                                  const int* mv0x, const int* mv1y, const int* mv1x,
                                  const int* ref0, const int* ref1, const int* ftab_x,
                                  const int* ftab_y, int* out, int B, int nref, int H, int W,
                                  int nh, int nw, int bd, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes: 8-bit only
  return launch_mc_compound(ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out,
                            B, nref, H, W, nh, nw, bd, stream);
}

extern "C" int mc_compound16_launch(const int16_t* ref, const int* ys, const int* xs,
                                    const int* mv0y, const int* mv0x, const int* mv1y,
                                    const int* mv1x, const int* ref0, const int* ref1,
                                    const int* ftab_x, const int* ftab_y, int* out, int B,
                                    int nref, int H, int W, int nh, int nw, int bd, void* stream) {
  return launch_mc_compound(ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out,
                            B, nref, H, W, nh, nw, bd, stream);
}
