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
// K11 mc_compound: compound-average MC (spec 7.11.3.4 with InterRound1 =
// COMPOUND_ROUND1, then the average blend of 7.11.3.15 without distance
// weights), on K10's lanes, strips and passes. Replaces
// svtav1_tpu/ops/me_jax.py::mc_lanes_compound (its two
// mc_lanes(conv_buf=True) passes and compound_average_j), which the commit's
// phase A runs for the Y and, as one launch of two planes, the U and V of
// every NEW_NEWMV block of a hierarchical-B frame. Bound: operations (two
// packed passes per reference and the blend), with the bytes (two patches per
// lane, mostly from L2) close behind. A strip stages both references'
// patches (each lane's own ref index, clamped into the stack) before its one
// warp synchronisation, and runs the two passes through the same registers
// one after the other: the vertical sum starts at 2^offset_bits +
// 2^(COMPOUND_ROUND1-1) and shifts by COMPOUND_ROUND1; the first pass keeps
// its conv-buf prediction per thread in registers (int32: at 10 bits it
// passes 2^15), the second blends it with its own and writes.
//
// Both kernels' forms are templates on the sample type: uint8_t planes at 8
// bits (mc_lanes_launch, mc_compound_launch), int16_t planes at 10 bits
// (mc_lanes16_launch, mc_compound16_launch); each entry refuses the other
// depth.
#include <type_traits>

#include "taps.cuh"

namespace {

constexpr int FILTER_BITS = 7, ROUND0 = 3, ROUND1 = 11, COMPOUND_ROUND1 = 7;
static_assert(2 * FILTER_BITS - ROUND0 - ROUND1 == 0, "no third rounding stage");

constexpr int MC_THREADS = 128;
constexpr int MC_PLANES = 3;  // planes of one launch
constexpr int MC_INFLIGHT = 8;  // staging loads a thread issues before it stores them

// A strip of SH output rows of an NW-wide lane: one thread per output column
// (CPT columns each), a strip's G threads inside one warp.
template <typename T, int NW>
struct Strip {
  static constexpr int G = NW < 32 ? NW : 32;  // a lane's threads
  static constexpr int CPT = NW / G;           // columns per thread
  static constexpr int LPC = MC_THREADS / G;   // strips per CTA
  static constexpr int SH = NW < 8 ? NW : 8;   // output rows per strip
  static constexpr int SPW = 4 / (int)sizeof(T);  // samples per word
  // words of a staged row: from the word of the lane's first sample through
  // the last word the horizontal pass of column NW - 1 reads (hsample reads
  // three words from its offset's word, hsample16 five)
  static constexpr int WR = Bd<T>::B8 ? NW / 4 + 3 : NW / 2 + 5;
  static constexpr int WORDS = (SH + 7) * WR;  // a staged patch
};

// Stage the strip's rows iy - 3 .. iy - 3 + rows - 1 of plane R, clamped,
// from the word of sample ix - 3 on (8 bits: signed bytes, as hsample takes
// them), by the strip's thread t. Returns the offset of sample ix - 3 in its
// word.
template <typename T, int NW>
__device__ __forceinline__ int stage_strip(unsigned* patch, const T* __restrict__ R, int H, int W,
                                           int iy, int ix, int rows, int t) {
  using S = Strip<T, NW>;
  constexpr int WR = S::WR, SPW = S::SPW, G = S::G;
  const int s0 = ix - 3, a = s0 & -SPW;  // the first sample and its word's
  const bool whole = a >= 0 && a + WR * SPW <= W && W % SPW == 0 && ((size_t)R & 3) == 0;
  const unsigned bias = Bd<T>::B8 ? 0x80808080u : 0u;
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
        v |= (Bd<T>::B8 ? (unsigned)(uint8_t)smp : (unsigned)(uint16_t)smp) << (32 / SPW * k);
      }
      patch[i] = v ^ bias;
    }
  }
  return s0 - a;
}

// The strip's nr output rows of thread t's columns from a staged patch whose
// first sample sits at offset d: the horizontal pass down each column (taps
// t0, t1; hcopy: phase 0), the last 8 intermediates as 7 int16 pairs in
// registers, and per output row the vertical sum from `init` by four IDP.2A
// (taps u0, u1; vcopy: phase 0, init + 128 h[r + 3]), handed to
// emit(row, column index, sum).
template <typename T, int NW, typename Emit>
__device__ __forceinline__ void strip_pass(const unsigned* patch, int d, int t, int t0, int t1,
                                           bool hcopy, int u0, int u1, bool vcopy, int nr,
                                           int init, Emit&& emit) {
  using S = Strip<T, NW>;
  constexpr int CPT = S::CPT, G = S::G, WR = S::WR, SH = S::SH;
  auto hrow = [&](int r, int c) {
    return Bd<T>::h((const T*)(patch + r * WR), d + c, t0, t1, hcopy);
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
#pragma unroll
  for (int r = 0; r < SH; ++r) {
    if (r == nr) break;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int h = hrow(r + 7, t + cc * G);
      win[cc][6] = __byte_perm(last[cc], h, 0x5410);
      last[cc] = h;
      int acc = __dp2a_lo((int)win[cc][0], u0, init);
      acc = __dp2a_hi((int)win[cc][2], u0, acc);
      acc = __dp2a_lo((int)win[cc][4], u1, acc);
      acc = __dp2a_hi((int)win[cc][6], u1, acc);
      if (vcopy) acc = init + ((int)(win[cc][3] & 0xffffu) << 7);  // phase 0: h[r + 3]
      emit(r, cc, acc);
#pragma unroll
      for (int k = 0; k < 6; ++k) win[cc][k] = win[cc][k + 1];
    }
  }
}

// The taps of the 16 phases of ftab_x and ftab_y, packed once per CTA:
// [x, y][phase][taps 0-3, taps 4-7].
__device__ __forceinline__ void stage_taps(unsigned (&tpk)[2][16][2], const int* ftab_x,
                                           const int* ftab_y) {
  const int tid = threadIdx.x;
  if (tid < 64)
    tpk[tid >> 5][(tid & 31) >> 1][tid & 1] = pack_taps4((tid < 32 ? ftab_x : ftab_y) + 4 * (tid & 31));
  __syncthreads();
}

template <typename T, int NW>
__global__ void __launch_bounds__(MC_THREADS)
mc_lanes_kernel(const T* __restrict__ ref0, const T* __restrict__ ref1,
                const T* __restrict__ ref2, const int* __restrict__ ys,
                const int* __restrict__ xs, const int* __restrict__ mvy,
                const int* __restrict__ mvx, const int* __restrict__ ref_idx,
                const int* __restrict__ ftab_x, const int* __restrict__ ftab_y,
                int* __restrict__ out, int B, int nref, int H, int W, int nh) {
  using K = Bd<T>;
  using S = Strip<T, NW>;
  constexpr int G = S::G, SH = S::SH;
  extern __shared__ unsigned patches[];
  __shared__ unsigned tpk[2][16][2];
  stage_taps(tpk, ftab_x, ftab_y);
  const int tid = threadIdx.x;
  const int slot = tid / G, t = tid - slot * G;
  const int strips = (nh + SH - 1) / SH;
  const int task = blockIdx.x * S::LPC + slot;  // a lane's strips one after another
  if (task >= B * strips) return;  // whole strips only: the warp sync below masks its strip
  const int b = task / strips, r0 = (task - b * strips) * SH;
  const int nr = min(SH, nh - r0);  // the strip's output rows
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1) << (tid & 31 & -G);
  const int pl = blockIdx.y;
  const T* ref = pl == 0 ? ref0 : (pl == 1 ? ref1 : ref2);
  unsigned* patch = patches + slot * S::WORDS;
  // floor of negative positions and phases: >> and & 15 as the reference
  const int fy0 = ys[b] * 16 + mvy[b], fx0 = xs[b] * 16 + mvx[b];
  const int sy = fy0 & 15, sx = fx0 & 15;
  const int ri = ref_idx ? clampi(ref_idx[b], 0, nref - 1) : 0;
  const int d = stage_strip<T, NW>(patch, ref + (size_t)ri * H * W, H, W, (fy0 >> 4) + r0,
                                   fx0 >> 4, nr + 7, t);
  __syncwarp(mask);
  int* o = out + (((size_t)pl * B + b) * nh + r0) * NW + t;
  strip_pass<T, NW>(patch, d, t, (int)tpk[0][sx][0], (int)tpk[0][sx][1], sx == 0,
                    (int)tpk[1][sy][0], (int)tpk[1][sy][1], sy == 0, nr, K::V,
                    [&](int r, int cc, int acc) { o[r * NW + cc * G] = K::clip(acc); });
}

// K11: the two references' passes of a strip; the first conv-buf prediction
// in registers.
template <typename T, int NW>
__global__ void __launch_bounds__(MC_THREADS)
mc_compound_kernel(const T* __restrict__ ref0, const T* __restrict__ ref1,
                   const T* __restrict__ ref2, const int* __restrict__ ys,
                   const int* __restrict__ xs, const int* __restrict__ mv0y,
                   const int* __restrict__ mv0x, const int* __restrict__ mv1y,
                   const int* __restrict__ mv1x, const int* __restrict__ ref0_idx,
                   const int* __restrict__ ref1_idx, const int* __restrict__ ftab_x,
                   const int* __restrict__ ftab_y, int* __restrict__ out, int B, int nref, int H,
                   int W, int nh) {
  using K = Bd<T>;
  using S = Strip<T, NW>;
  constexpr int G = S::G, SH = S::SH, CPT = S::CPT;
  // 2^offset_bits and the rounding of COMPOUND_ROUND1; the blend's offset
  // and rounding (round_bits 4)
  constexpr int OFFSET_BITS = (K::B8 ? 8 : 10) + 2 * FILTER_BITS - ROUND0;
  constexpr int CINIT = (1 << OFFSET_BITS) + (1 << (COMPOUND_ROUND1 - 1));
  constexpr int ROUND_BITS = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1;
  constexpr int CSUB = (1 << (OFFSET_BITS - COMPOUND_ROUND1)) +
                       (1 << (OFFSET_BITS - COMPOUND_ROUND1 - 1)) - (1 << (ROUND_BITS - 1));
  constexpr int MAXV = K::B8 ? 255 : 1023;
  extern __shared__ unsigned patches[];
  __shared__ unsigned tpk[2][16][2];
  stage_taps(tpk, ftab_x, ftab_y);
  const int tid = threadIdx.x;
  const int slot = tid / G, t = tid - slot * G;
  const int strips = (nh + SH - 1) / SH;
  const int task = blockIdx.x * S::LPC + slot;  // a lane's strips one after another
  if (task >= B * strips) return;  // whole strips only: the warp sync below masks its strip
  const int b = task / strips, r0 = (task - b * strips) * SH;
  const int nr = min(SH, nh - r0);  // the strip's output rows
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1) << (tid & 31 & -G);
  const int pl = blockIdx.y;
  const T* ref = pl == 0 ? ref0 : (pl == 1 ? ref1 : ref2);
  int sy[2], sx[2], d[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // both patches staged before the one warp sync
    const int fy0 = ys[b] * 16 + (pass ? mv1y : mv0y)[b];
    const int fx0 = xs[b] * 16 + (pass ? mv1x : mv0x)[b];
    sy[pass] = fy0 & 15;
    sx[pass] = fx0 & 15;
    const int ri = clampi((pass ? ref1_idx : ref0_idx)[b], 0, nref - 1);
    d[pass] = stage_strip<T, NW>(patches + (2 * slot + pass) * S::WORDS, ref + (size_t)ri * H * W,
                                 H, W, (fy0 >> 4) + r0, fx0 >> 4, nr + 7, t);
  }
  __syncwarp(mask);
  int conv0[SH][CPT];  // the first pass's conv-buf prediction
  int* o = out + (((size_t)pl * B + b) * nh + r0) * NW + t;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    strip_pass<T, NW>(patches + (2 * slot + pass) * S::WORDS, d[pass], t,
                      (int)tpk[0][sx[pass]][0], (int)tpk[0][sx[pass]][1], sx[pass] == 0,
                      (int)tpk[1][sy[pass]][0], (int)tpk[1][sy[pass]][1], sy[pass] == 0, nr, CINIT,
                      [&](int r, int cc, int acc) {
                        const int conv = acc >> COMPOUND_ROUND1;
                        if (pass == 0) conv0[r][cc] = conv;
                        else o[r * NW + cc * G] =
                                 clampi((((conv0[r][cc] + conv) >> 1) - CSUB) >> ROUND_BITS, 0, MAXV);
                      });
  }
}

// launch(std::integral_constant<int, NW>) for the lane widths 4, 8, 16, 32, 64
template <typename F>
int by_width(int nw, F&& launch) {
  switch (nw) {
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    default: return (int)cudaErrorInvalidValue;  // lanes 4, 8, 16, 32 or 64 wide
  }
}

// The grid of B lanes' strips on P planes, and the CTA's shared patches (K11:
// two per strip).
template <typename T, int NW, int PATCHES>
struct Grid {
  using S = Strip<T, NW>;
  static constexpr size_t shm = (size_t)S::LPC * PATCHES * S::WORDS * sizeof(unsigned);
  static_assert(shm <= 48 * 1024, "a CTA's patches fit the default shared memory");
  static dim3 of(int P, int B, int nh) {
    const long long tasks = (long long)B * ((nh + S::SH - 1) / S::SH);
    return dim3((unsigned)((tasks + S::LPC - 1) / S::LPC), P);
  }
};

template <typename T>
int launch_mc_lanes(const T* r0, const T* r1, const T* r2, const int* ys, const int* xs,
                    const int* mvy, const int* mvx, const int* ref_idx, const int* ftab_x,
                    const int* ftab_y, int* out, int P, int B, int nref, int H, int W, int nh,
                    int nw, void* stream) {
  if (P < 1 || P > MC_PLANES || nh < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return by_width(nw, [&](auto w) {
    constexpr int NW = decltype(w)::value;
    using GR = Grid<T, NW, 1>;
    mc_lanes_kernel<T, NW><<<GR::of(P, B, nh), MC_THREADS, GR::shm, (cudaStream_t)stream>>>(
        r0, r1, r2, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, B, nref, H, W, nh);
    return launch_status();
  });
}

template <typename T>
int launch_mc_compound(const T* r0, const T* r1, const T* r2, const int* ys, const int* xs,
                       const int* mv0y, const int* mv0x, const int* mv1y, const int* mv1x,
                       const int* ref0_idx, const int* ref1_idx, const int* ftab_x,
                       const int* ftab_y, int* out, int P, int B, int nref, int H, int W, int nh,
                       int nw, void* stream) {
  if (P < 1 || P > MC_PLANES || nh < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return by_width(nw, [&](auto w) {
    constexpr int NW = decltype(w)::value;
    using GR = Grid<T, NW, 2>;
    mc_compound_kernel<T, NW><<<GR::of(P, B, nh), MC_THREADS, GR::shm, (cudaStream_t)stream>>>(
        r0, r1, r2, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0_idx, ref1_idx, ftab_x, ftab_y, out, B,
        nref, H, W, nh);
    return launch_status();
  });
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

// ref0..ref2: (NREF, H, W) stacks, NULL past the P planes
extern "C" int mc_compound_launch(const uint8_t* ref0, const uint8_t* ref1, const uint8_t* ref2,
                                  const int* ys, const int* xs, const int* mv0y, const int* mv0x,
                                  const int* mv1y, const int* mv1x, const int* ref0_idx,
                                  const int* ref1_idx, const int* ftab_x, const int* ftab_y,
                                  int* out, int P, int B, int nref, int H, int W, int nh, int nw,
                                  int bd, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes: 8-bit only
  return launch_mc_compound(ref0, ref1, ref2, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0_idx, ref1_idx,
                            ftab_x, ftab_y, out, P, B, nref, H, W, nh, nw, stream);
}

extern "C" int mc_compound16_launch(const int16_t* ref0, const int16_t* ref1,
                                    const int16_t* ref2, const int* ys, const int* xs,
                                    const int* mv0y, const int* mv0x, const int* mv1y,
                                    const int* mv1x, const int* ref0_idx, const int* ref1_idx,
                                    const int* ftab_x, const int* ftab_y, int* out, int P, int B,
                                    int nref, int H, int W, int nh, int nw, int bd,
                                    void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // int16 planes: the 10-bit constants
  return launch_mc_compound(ref0, ref1, ref2, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0_idx, ref1_idx,
                            ftab_x, ftab_y, out, P, B, nref, H, W, nh, nw, stream);
}
