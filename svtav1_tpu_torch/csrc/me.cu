// K8 me_sad: the full-pel motion search of a frame against one reference,
// two launches behind one entry point:
//   mode 0 pyramid: the 2x2-average levels 1 and 2, (p00 + p01 + p10 + p11 +
//          2) >> 2, of one or two uint8 planes (the source and the
//          reference), each read as if edge-padded to its (H, W);
//   mode 1 frame:  per 64x64 superblock (SB), the L2 search (16x16 at
//          +-16 on level 2, bias |dy| + |dx|), the L1 (32x32, +-2, bias x2)
//          and L0 (64x64, +-2, bias x4) refinements around twice the previous
//          winner, giving the SB MV; then the 8x8 SAD maps of the SB's 64
//          leaves at +-4 around the SB MV and around zero, summed up the
//          quadtree to 16x16, 32x32 and 64x64, the biased argmin of every
//          block and size (bias (|dy| + |dx|) * n * n / 16), and the merge of
//          the two centres (zero wins only if strictly better). Every argmin
//          takes the first minimum in (dy, dx) raster order. Writes every
//          size's MVs and the SB MVs.
// A plane smaller than the SB grid is read as if edge-padded to it: the
// source to (64 sb_rows, 64 sb_cols), the reference to at least that. The
// reference may be wider than the source: a source column x sits at
// reference column x + ox (a tile's halo-cropped reference), ox / 2 and
// ox / 4 on levels 1 and 2. Reads clamp to each level's own dims.
//
// Replaces svtav1_tpu/ops/me_jax.py::me_fullpel_frame (:86-152): :31
// decimate2_j, :40 gather_windows, :54 sad_maps, :64 _argmin2d, :77
// _search_centered, the two leaf-map windows, the quadtree sums, the
// per-size argmin and the two-centre merge, with its ref_off_x.
//
// Bound: operations. A 1080p frame (510 SBs) against one reference takes
// 0.34 G absolute differences for the leaf maps and 0.21 G for the searches,
// from about 6 MB of uint8 planes. Design: the pyramid is one launch, and
// the whole search of an SB runs in one CTA of 320 threads with every
// window, map and partial result in shared memory: nothing between the
// levels goes through device memory, and there is no glue. Planes are uint8;
// each SAD step is one VABSDIFF4.U8.ACC (four absolute differences and the
// sum) on four packed samples, with the window's unaligned words formed by
// PRMT. In the L2 search a thread owns a displacement row and four
// neighbouring columns and loops over the source rows, so each window word
// serves four displacements (33 x 9 items: one round of 320 threads); in L1
// and L0 a warp owns a displacement row and its lanes the source rows
// (shuffle sums); in the leaf maps a thread owns (centre, leaf, dy) and
// slides over the 9 dx from 4 window words per row, both centres in one
// pass. Keys pack (value, index) so that one integer min is the first
// minimum.
//
// 10 bits (me_sad16_launch): the same kernels on int16 planes, templates on
// the sample type. A 32-bit word then packs two samples and each SAD step is
// one VABSDIFF2 (two absolute differences of 16-bit halves and the sum), so
// every search takes twice the steps. The samples in shared memory double
// (49.7 KB with the leaf maps, above the 48 KB default limit, which the
// launcher raises). Every width holds at 10 bits: a leaf's 8x8 SAD
// is at most 64 x 1023 = 65,472 (its uint16 map entry), a quadtree sum 64
// times that, below the 2^25 of its key (value << 7); the L2 key (value <<
// 11) holds 256 x 1023 + 32, the refinement key (value << 5) 4,096 x 1023
// + 16.
#include "common.cuh"

namespace {

constexpr int NT = 320;      // threads per CTA of the frame search: the 297 L2 items in one round
constexpr int R1 = 2;        // L1 and L0 refinement radius
constexpr int D1 = 2 * R1 + 1;
constexpr int NBLK = 64 + 16 + 4 + 1;  // blocks of every size in one SB

// sum of the four byte-wise absolute differences of a and b, plus c
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// |a - b| + c of two 32-bit words (chip_smoke.py's scalar rate only)
__device__ __forceinline__ unsigned sad1(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// sum of the two absolute differences of the unsigned 16-bit halves, plus c
__device__ __forceinline__ unsigned sad2(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff2.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the four bytes at byte offset j (0..3) of the little-endian pair (lo, hi)
__device__ __forceinline__ unsigned bytes_at(unsigned lo, unsigned hi, int j) {
  return __byte_perm(lo, hi, 0x3210u + 0x1111u * j);
}

// Samples of type T (uint8_t; uint16_t for the 10-bit int16 planes, whose
// samples are never negative) packed S to a 32-bit word, and the SAD step
// of one pair of words.
template <typename T>
struct Pk {
  static constexpr int S = 4 / (int)sizeof(T);
  static __device__ __forceinline__ unsigned sad(unsigned a, unsigned b, unsigned c) {
    return sizeof(T) == 1 ? sad4(a, b, c) : sad2(a, b, c);
  }
};

// the word of S samples that starts at sample e of the N words w (e, and so
// the words read, known once the loops are unrolled)
template <typename T, int N>
__device__ __forceinline__ unsigned word_at(const unsigned* w, int e) {
  constexpr int S = Pk<T>::S;
  const int q = e / S, j = e % S;
  return j ? bytes_at(w[q], w[min(q + 1, N - 1)], j * (int)sizeof(T)) : w[q];
}

__device__ __forceinline__ unsigned warp_min(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void pyramid_kernel(const T* __restrict__ a0, T* __restrict__ a1, T* __restrict__ a2,
                               int ha, int wa, int Ha, int Wa, const T* __restrict__ b0,
                               T* __restrict__ b1, T* __restrict__ b2, int hb, int wb, int Hb,
                               int Wb) {
  const bool second = blockIdx.y == 1;
  const T* p = second ? b0 : a0;
  T* l1 = second ? b1 : a1;
  T* l2 = second ? b2 : a2;
  const int h = second ? hb : ha, w = second ? wb : wa;
  const int H1 = (second ? Hb : Ha) >> 1, W1 = (second ? Wb : Wa) >> 1;
  const int H2 = H1 >> 1, W2 = W1 >> 1, QW = (W1 + 1) >> 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ((H1 + 1) >> 1) * QW) return;
  const int qy = i / QW, qx = i - qy * QW;
  int s = 0;
  for (int u = 0; u < 2; ++u)
    for (int v = 0; v < 2; ++v) {
      const int y = 2 * qy + u, x = 2 * qx + v;
      if (y >= H1 || x >= W1) continue;
      const T* r0 = p + (size_t)min(2 * y, h - 1) * w;
      const T* r1 = p + (size_t)min(2 * y + 1, h - 1) * w;
      const int c0 = min(2 * x, w - 1), c1 = min(2 * x + 1, w - 1);
      const int m = (r0[c0] + r0[c1] + r1[c0] + r1[c1] + 2) >> 2;
      l1[(size_t)y * W1 + x] = (T)m;
      s += m;
    }
  if (qy < H2 && qx < W2) l2[(size_t)qy * W2 + qx] = (T)((s + 2) >> 2);
}

// ROWS x COLS samples of a plane (H, W) from (y0, x0), each coordinate
// clamped, into shared memory with a row stride of `stride` samples: a
// thread stores the S samples of a word at once (COLS and stride multiples
// of S)
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage(uint8_t* dst, int stride, const T* __restrict__ plane, int H,
                                      int W, int y0, int x0) {
  constexpr int S = Pk<T>::S, BITS = 8 * (int)sizeof(T);
  static_assert(COLS % S == 0, "whole words");
  constexpr int G = COLS / S;
#pragma unroll 2
  for (int i = threadIdx.x; i < ROWS * G; i += NT) {
    const int r = i / G, x = x0 + S * (i - r * G);
    const T* row = plane + (size_t)clampi(y0 + r, 0, H - 1) * W;
    unsigned v = 0;
    if (x >= 0 && x + S - 1 < W) {
#pragma unroll
      for (int m = 0; m < S; ++m) v |= (unsigned)row[x + m] << (BITS * m);
    } else {
#pragma unroll
      for (int m = 0; m < S; ++m) v |= (unsigned)row[clampi(x + m, 0, W - 1)] << (BITS * m);
    }
    *(unsigned*)(dst + (r * stride + S * (i - r * G)) * (int)sizeof(T)) = v;
  }
}

// the SV words of one row of a block in shared memory, by 16-byte loads
template <int SV>
__device__ __forceinline__ void load_row(unsigned (&s)[SV], const uint8_t* p) {
  static_assert(SV % 2 == 0, "8-byte multiples");
  if constexpr (SV % 4 == 0) {
#pragma unroll
    for (int k = 0; k < SV / 4; ++k) {
      const uint4 v = ((const uint4*)p)[k];
      s[4 * k] = v.x;
      s[4 * k + 1] = v.y;
      s[4 * k + 2] = v.z;
      s[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SV / 2; ++k) {
      const uint2 v = ((const uint2*)p)[k];
      s[2 * k] = v.x;
      s[2 * k + 1] = v.y;
    }
  }
}

// one SB's centred +-R1 refinement of an n x n block (n = 32 or 64) in
// shared memory against its (n + 4)^2 window: a warp per displacement row,
// a lane per source row (two for n = 64); atomicMin of the biased keys
template <typename T, int n>
__device__ void refine(const uint8_t* s, const uint8_t* win, int scale, unsigned* best) {
  constexpr int S = Pk<T>::S, WS = n + 2 * R1;  // samples per word; window stride
  constexpr int SW = n / S, WW = WS / S;         // words per source and window row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= D1) return;
  unsigned acc[D1] = {};
  for (int a = lane; a < n; a += 32) {
    const unsigned* sr = (const unsigned*)(s + a * n * (int)sizeof(T));
    const unsigned* wr = (const unsigned*)(win + (warp + a) * WS * (int)sizeof(T));
    unsigned sw[SW], ww[WW];
#pragma unroll
    for (int k = 0; k < SW; ++k) sw[k] = sr[k];
#pragma unroll
    for (int k = 0; k < WW; ++k) ww[k] = wr[k];
#pragma unroll
    for (int dx = 0; dx < D1; ++dx) {
#pragma unroll
      for (int k = 0; k < SW; ++k)
        acc[dx] = Pk<T>::sad(sw[k], word_at<T, WW>(ww, dx + S * k), acc[dx]);
    }
  }
  unsigned key = ~0u;
#pragma unroll
  for (int dx = 0; dx < D1; ++dx) {
    const unsigned v = warp_sum(acc[dx]) + (abs(warp - R1) + abs(dx - R1)) * scale;
    key = min(key, (v << 5) | (unsigned)(warp * D1 + dx));
  }
  if (lane == 0) atomicMin(best, key);
}

// The frame search's shared layout, in bytes, for samples of type T: the
// SB's source and the zero-centre leaf window, then either the searches'
// blocks and windows or the SB-MV leaf window and the leaf maps of both
// centres (the two sets are never live together).
template <typename T, int R2, int RL>
struct FrameLayout {
  static constexpr int Z = (int)sizeof(T);
  static constexpr int D2 = 2 * R2 + 1, S2 = 16 + 2 * R2, G2 = (D2 + 3) / 4;
  static constexpr int S2S = S2 + 4;  // L2 window stride: the last group reads past a row
  static constexpr int DL = 2 * RL + 1, SL = 64 + 2 * RL, DD = DL * DL;
  static constexpr int LWB = SL * SL * Z;
  static constexpr int O_LWZ = 4096 * Z, O_A = O_LWZ + LWB;
  static constexpr int O_S2 = O_A, O_W2 = O_S2 + 256 * Z, O_S1 = O_W2 + S2 * S2S * Z;
  static constexpr int O_W1 = O_S1 + 1024 * Z, O_W0 = O_W1 + 36 * 36 * Z;
  static constexpr int END_A = O_W0 + 68 * 68 * Z;
  static constexpr int O_LW0 = O_A, O_MAPS = O_LW0 + LWB, END_B = O_MAPS + 2 * 64 * DD * 2;
  static constexpr int SMEM = END_A > END_B ? END_A : END_B;
};

// The frame search of one SB per CTA (see the header), its windows and maps
// in dynamic shared memory of FrameLayout::SMEM bytes (35.2 KB at 8 bits,
// 49.7 KB at 10).
template <typename T, int R2, int RL>
__global__ void __launch_bounds__(NT)
frame_kernel(const T* __restrict__ src0, const T* __restrict__ src1, const T* __restrict__ src2,
             const T* __restrict__ ref0, const T* __restrict__ ref1, const T* __restrict__ ref2,
             int* __restrict__ out, int hs, int ws, int Hs, int Ws, int hr, int wr, int Hr, int Wr,
             int ox, int sb_rows, int sb_cols) {
  using Ly = FrameLayout<T, R2, RL>;
  constexpr int S = Pk<T>::S, Z = Ly::Z;
  constexpr int D2 = Ly::D2, S2 = Ly::S2, G2 = Ly::G2, S2S = Ly::S2S;
  constexpr int DL = Ly::DL, SL = Ly::SL, DD = Ly::DD;
  constexpr int O_LWZ = Ly::O_LWZ, O_S2 = Ly::O_S2, O_W2 = Ly::O_W2, O_S1 = Ly::O_S1;
  constexpr int O_W1 = Ly::O_W1, O_W0 = Ly::O_W0, O_LW0 = Ly::O_LW0, O_MAPS = Ly::O_MAPS;
  static_assert(S2 % 4 == 0 && SL % 4 == 0 && DL <= 9, "word-aligned windows, dx within 4 words");
  static_assert(D2 * D2 <= 2048 && DD <= 128, "key index bits");
  static_assert(Ly::O_A % 16 == 0 && O_MAPS % 4 == 0, "aligned regions");
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ unsigned keys[2][NBLK];
  __shared__ unsigned best[3];
  uint8_t* s0 = sm;
  uint16_t* maps = (uint16_t*)(sm + O_MAPS);  // [centre][leaf][dy][dx]; a leaf SAD < 2^16
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, sr = b / sb_cols, sc = b - sr * sb_cols;
  const int H1s = Hs >> 1, W1s = Ws >> 1, H1r = Hr >> 1, W1r = Wr >> 1;

  if (tid < 3) best[tid] = ~0u;
  stage<T, 64, 64>(s0, 64, src0, hs, ws, 64 * sr, 64 * sc);
  stage<T, SL, SL>(sm + O_LWZ, SL, ref0, hr, wr, 64 * sr - RL, 64 * sc + ox - RL);
  stage<T, 16, 16>(sm + O_S2, 16, src2, H1s >> 1, W1s >> 1, 16 * sr, 16 * sc);
  stage<T, 32, 32>(sm + O_S1, 32, src1, H1s, W1s, 32 * sr, 32 * sc);
  stage<T, S2, S2>(sm + O_W2, S2S, ref2, H1r >> 1, W1r >> 1, 16 * sr - R2,
                   16 * sc + (ox >> 2) - R2);
  __syncthreads();

  // ---- L2: a thread owns (dy, four dx); the source rows are broadcasts
  {
    constexpr int SV = 16 / S, NW = 19 / S + 1;  // words per source row; window words read
    unsigned key = ~0u;
    for (int it = tid; it < D2 * G2; it += NT) {
      const int dy = it / G2, g = it - dy * G2;
      unsigned acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int a = 0; a < 16; ++a) {
        unsigned s[SV], w[NW];
        load_row(s, sm + O_S2 + a * 16 * Z);
        const unsigned* wr = (const unsigned*)(sm + O_W2 + (dy + a) * S2S * Z) + g * (4 / S);
#pragma unroll
        for (int k = 0; k < NW; ++k) w[k] = wr[k];
#pragma unroll
        for (int k = 0; k < SV; ++k) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = Pk<T>::sad(s[k], word_at<T, NW>(w, S * k + j), acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dx = 4 * g + j;
        if (dx < D2) {
          const unsigned v = acc[j] + abs(dy - R2) + abs(dx - R2);
          key = min(key, (v << 11) | (unsigned)(dy * D2 + dx));
        }
      }
    }
    key = warp_min(key);
    if (lane == 0) atomicMin(&best[0], key);
  }
  __syncthreads();
  const int d2 = best[0] & 2047;
  const int c1y = 2 * (d2 / D2 - R2), c1x = 2 * (d2 % D2 - R2);
  stage<T, 36, 36>(sm + O_W1, 36, ref1, H1r, W1r, 32 * sr + c1y - R1,
                   32 * sc + (ox >> 1) + c1x - R1);
  __syncthreads();
  refine<T, 32>(sm + O_S1, sm + O_W1, 2, &best[1]);
  __syncthreads();
  const int d1 = best[1] & 31;
  const int c0y = 2 * (c1y + d1 / D1 - R1), c0x = 2 * (c1x + d1 % D1 - R1);
  stage<T, 68, 68>(sm + O_W0, 68, ref0, hr, wr, 64 * sr + c0y - R1, 64 * sc + ox + c0x - R1);
  __syncthreads();
  refine<T, 64>(s0, sm + O_W0, 4, &best[2]);
  __syncthreads();
  const int d0 = best[2] & 31;
  const int my = c0y + d0 / D1 - R1, mx = c0x + d0 % D1 - R1;  // the SB MV

  // ---- the leaf maps around the SB MV (k = 0) and zero (k = 1), both in
  // one pass: a thread owns (k, leaf, dy) and slides over the dx
  stage<T, SL, SL>(sm + O_LW0, SL, ref0, hr, wr, 64 * sr + my - RL, 64 * sc + ox + mx - RL);
  __syncthreads();
  for (int it = tid; it < 2 * 64 * DL; it += NT) {
    constexpr int SV = 8 / S, NW = 16 / S;  // words per leaf row; window words read
    const int k = it >= 64 * DL, leaf = (it - k * 64 * DL) / DL, dy = it - k * 64 * DL - leaf * DL;
    const int li = leaf >> 3, lj = leaf & 7;
    const uint8_t* lw = sm + (k ? O_LWZ : O_LW0);
    unsigned acc[DL] = {};
#pragma unroll 2
    for (int a = 0; a < 8; ++a) {
      unsigned sv[SV], w[NW];
      load_row(sv, s0 + ((8 * li + a) * 64 + 8 * lj) * Z);
      const unsigned* wr = (const unsigned*)(lw + ((8 * li + dy + a) * SL + 8 * lj) * Z);
#pragma unroll
      for (int q = 0; q < NW; ++q) w[q] = wr[q];
#pragma unroll
      for (int dx = 0; dx < DL; ++dx) {
#pragma unroll
        for (int q = 0; q < SV; ++q)
          acc[dx] = Pk<T>::sad(sv[q], word_at<T, NW>(w, dx + S * q), acc[dx]);
      }
    }
    uint16_t* m = maps + (k * 64 + leaf) * DD + dy * DL;
#pragma unroll
    for (int dx = 0; dx < DL; ++dx) m[dx] = (uint16_t)acc[dx];
  }
  __syncthreads();
  // the quadtree sums and each block's biased first minimum, a warp per
  // (centre, block): 64 blocks of 8x8, 16 of 16x16, 4 of 32x32, 1 of 64x64;
  // a lane owns the displacements lane, lane + 32 and lane + 64
  {
    constexpr int DJ = (DD + 31) / 32;
    int dist[DJ];  // |dy| + |dx| of the lane's displacements
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j, dy = d / DL, dx = d - dy * DL;
      dist[j] = abs(dy - RL) + abs(dx - RL);
    }
    for (int kq = warp; kq < 2 * NBLK; kq += NT / 32) {
      const int k = kq >= NBLK, q = kq - k * NBLK;
      const int lg = q < 64 ? 0 : q < 80 ? 1 : q < 84 ? 2 : 3;  // log2(n / 8)
      const int qq = q - (lg == 0 ? 0 : lg == 1 ? 64 : lg == 2 ? 80 : 84);
      const int per = 8 >> lg, bi = qq / per, bj = qq - bi * per, kk = 1 << lg;
      const uint16_t* mk = maps + (k * 64 + bi * kk * 8 + bj * kk) * DD;
      unsigned kb = ~0u;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + 32 * j;
        if (d < DD) {
          int s = 0;
          for (int u = 0; u < kk; ++u)
            for (int v = 0; v < kk; ++v) s += mk[(u * 8 + v) * DD + d];
          kb = min(kb, (((unsigned)s + dist[j] * (4 << (2 * lg))) << 7) | (unsigned)d);
        }
      }
      kb = warp_min(kb);
      if (lane == 0) keys[k][q] = kb;
    }
  }
  __syncthreads();

  // ---- merge the centres (the SB MV wins ties) and write every size
  const int B = sb_rows * sb_cols;
  if (tid < NBLK) {
    const unsigned k0 = keys[0][tid], k1 = keys[1][tid];
    const bool zero = (k1 >> 7) < (k0 >> 7);
    const int d = (zero ? k1 : k0) & 127;
    const int vy = (zero ? 0 : my) + d / DL - RL, vx = (zero ? 0 : mx) + d % DL - RL;
    const int lg = tid < 64 ? 0 : tid < 80 ? 1 : tid < 84 ? 2 : 3;
    const int qq = tid - (lg == 0 ? 0 : lg == 1 ? 64 : lg == 2 ? 80 : 84);
    const int per = 8 >> lg, bi = qq / per, bj = qq - bi * per;
    // region of size n: B * per^2 blocks, raster over the frame's block grid
    const int base = lg == 0 ? 0 : lg == 1 ? 64 * B : lg == 2 ? 80 * B : 84 * B;
    int* o = out + 2 * (base + (sr * per + bi) * (sb_cols * per) + sc * per + bj);
    o[0] = vy;
    o[1] = vx;
  }
  if (tid == 0) {
    out[2 * (NBLK * B + b)] = my;
    out[2 * (NBLK * B + b) + 1] = mx;
  }
}

// chip_smoke.py's rate of the packed instructions the kernels rest on: each
// thread runs `iters` steps of 8 independent chains of one instruction
// (0 VABSDIFF4.U8.ACC, 1 IDP.2A, 2 IDP.4A, 3 IMAD, 4 VABSDIFF2 with the sum,
// 5 the scalar VABSDIFF with the sum)
template <int which>
__global__ void packed_rate_kernel(int iters, unsigned* out) {
  unsigned a[8], acc[8], b = threadIdx.x * 0x01010101u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = (threadIdx.x + i) * 0x00010203u;
    acc[i] = 0;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (which == 0) acc[i] = sad4(a[i], b, acc[i]);
      else if (which == 1) acc[i] = (unsigned)__dp2a_lo((int)a[i], (int)b, (int)acc[i]);
      else if (which == 2) acc[i] = (unsigned)__dp4a((int)a[i], (int)b, (int)acc[i]);
      else if (which == 3) acc[i] = a[i] * b + acc[i];
      else if (which == 4) acc[i] = sad2(a[i], b, acc[i]);
      else acc[i] = sad1(a[i], b, acc[i]);
    }
    b += 0x01010101u;
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename T>
int me_sad(int mode, const T* src0, const T* src1, const T* src2, const T* ref0, const T* ref1,
           const T* ref2, int* out, int hs, int ws, int Hs, int Ws, int hr, int wr, int Hr, int Wr,
           int ox, int sb_rows, int sb_cols, int l2r, int leafr, cudaStream_t st) {
  if (mode == 0) {  // pyramid of the source (unless src0 is NULL) and the reference
    const bool two = src0 != nullptr;
    const int qa = two ? (((Hs >> 1) + 1) >> 1) * (((Ws >> 1) + 1) >> 1) : 0;
    const int qb = (((Hr >> 1) + 1) >> 1) * (((Wr >> 1) + 1) >> 1);
    const int quads = qa > qb ? qa : qb;
    if (quads == 0) return 0;
    T *a1 = (T*)src1, *a2 = (T*)src2, *b1 = (T*)ref1, *b2 = (T*)ref2;
    if (two)
      pyramid_kernel<T><<<dim3((quads + 255) / 256, 2), 256, 0, st>>>(
          src0, a1, a2, hs, ws, Hs, Ws, ref0, b1, b2, hr, wr, Hr, Wr);
    else
      pyramid_kernel<T><<<dim3((quads + 255) / 256, 1), 256, 0, st>>>(
          ref0, b1, b2, hr, wr, Hr, Wr, nullptr, nullptr, nullptr, 0, 0, 0, 0);
  } else if (mode == 1) {
    if (l2r != 16 || leafr != 4) return (int)cudaErrorInvalidValue;
    const int B = sb_rows * sb_cols;
    if (B == 0) return 0;
    constexpr int smem = FrameLayout<T, 16, 4>::SMEM;
    if (const int err = allow_smem(frame_kernel<T, 16, 4>, smem)) return err;
    frame_kernel<T, 16, 4><<<B, NT, smem, st>>>(src0, src1, src2, ref0, ref1, ref2, out, hs, ws,
                                               Hs, Ws, hr, wr, Hr, Wr, ox, sb_rows, sb_cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}

}  // namespace

extern "C" int me_sad_launch(int mode, const uint8_t* src0, const uint8_t* src1,
                             const uint8_t* src2, const uint8_t* ref0, const uint8_t* ref1,
                             const uint8_t* ref2, int* out, int hs, int ws, int Hs, int Ws, int hr,
                             int wr, int Hr, int Wr, int ox, int sb_rows, int sb_cols, int l2r,
                             int leafr, void* stream) {
  return me_sad<uint8_t>(mode, src0, src1, src2, ref0, ref1, ref2, out, hs, ws, Hs, Ws, hr, wr, Hr,
                         Wr, ox, sb_rows, sb_cols, l2r, leafr, (cudaStream_t)stream);
}

// the 10-bit form: int16 planes of samples in 0..1023, read as uint16
extern "C" int me_sad16_launch(int mode, const int16_t* src0, const int16_t* src1,
                               const int16_t* src2, const int16_t* ref0, const int16_t* ref1,
                               const int16_t* ref2, int* out, int hs, int ws, int Hs, int Ws,
                               int hr, int wr, int Hr, int Wr, int ox, int sb_rows, int sb_cols,
                               int l2r, int leafr, void* stream) {
  using U = const uint16_t*;
  return me_sad<uint16_t>(mode, (U)src0, (U)src1, (U)src2, (U)ref0, (U)ref1, (U)ref2, out, hs, ws,
                          Hs, Ws, hr, wr, Hr, Wr, ox, sb_rows, sb_cols, l2r, leafr,
                          (cudaStream_t)stream);
}

extern "C" int packed_rate_launch(int which, int blocks, int iters, unsigned* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 0) packed_rate_kernel<0><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 1) packed_rate_kernel<1><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 2) packed_rate_kernel<2><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 3) packed_rate_kernel<3><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 4) packed_rate_kernel<4><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 5) packed_rate_kernel<5><<<blocks, 256, 0, st>>>(iters, out);
  else return (int)cudaErrorInvalidValue;
  return launch_status();
}
