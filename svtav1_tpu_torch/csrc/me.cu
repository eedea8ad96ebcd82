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

// the four bytes at byte offset j (0..3) of the little-endian pair (lo, hi)
__device__ __forceinline__ unsigned bytes_at(unsigned lo, unsigned hi, int j) {
  return __byte_perm(lo, hi, 0x3210u + 0x1111u * j);
}

__device__ __forceinline__ unsigned warp_min(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void pyramid_kernel(const uint8_t* __restrict__ a0, uint8_t* __restrict__ a1,
                               uint8_t* __restrict__ a2, int ha, int wa, int Ha, int Wa,
                               const uint8_t* __restrict__ b0, uint8_t* __restrict__ b1,
                               uint8_t* __restrict__ b2, int hb, int wb, int Hb, int Wb) {
  const bool second = blockIdx.y == 1;
  const uint8_t* p = second ? b0 : a0;
  uint8_t* l1 = second ? b1 : a1;
  uint8_t* l2 = second ? b2 : a2;
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
      const uint8_t* r0 = p + (size_t)min(2 * y, h - 1) * w;
      const uint8_t* r1 = p + (size_t)min(2 * y + 1, h - 1) * w;
      const int c0 = min(2 * x, w - 1), c1 = min(2 * x + 1, w - 1);
      const int m = (r0[c0] + r0[c1] + r1[c0] + r1[c1] + 2) >> 2;
      l1[(size_t)y * W1 + x] = (uint8_t)m;
      s += m;
    }
  if (qy < H2 && qx < W2) l2[(size_t)qy * W2 + qx] = (uint8_t)((s + 2) >> 2);
}

// ROWS x COLS samples of a plane (H, W) from (y0, x0), each coordinate
// clamped, into shared memory with a row stride of `stride` bytes: a thread
// stores four samples of a row as one word (COLS and stride multiples of 4)
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(uint8_t* dst, int stride, const uint8_t* __restrict__ plane,
                                      int H, int W, int y0, int x0) {
  static_assert(COLS % 4 == 0, "whole words");
  constexpr int G = COLS / 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < ROWS * G; i += NT) {
    const int r = i / G, x = x0 + 4 * (i - r * G);
    const uint8_t* row = plane + (size_t)clampi(y0 + r, 0, H - 1) * W;
    unsigned v;
    if (x >= 0 && x + 3 < W) {
      v = row[x] | (row[x + 1] << 8) | (row[x + 2] << 16) | ((unsigned)row[x + 3] << 24);
    } else {
      v = row[clampi(x, 0, W - 1)] | (row[clampi(x + 1, 0, W - 1)] << 8) |
          (row[clampi(x + 2, 0, W - 1)] << 16) | ((unsigned)row[clampi(x + 3, 0, W - 1)] << 24);
    }
    *(unsigned*)(dst + r * stride + 4 * (i - r * G)) = v;
  }
}

// one SB's centred +-R1 refinement of an n x n block (n = 32 or 64) in
// shared memory against its (n + 4)^2 window: a warp per displacement row,
// a lane per source row (two for n = 64); atomicMin of the biased keys
template <int n>
__device__ void refine(const uint8_t* s, const uint8_t* win, int scale, unsigned* best) {
  constexpr int SW = n / 4, WW = SW + 1, WS = n + 2 * R1;  // words per row; window stride
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= D1) return;
  unsigned acc[D1] = {};
  for (int a = lane; a < n; a += 32) {
    const unsigned* sr = (const unsigned*)(s + a * n);
    const unsigned* wr = (const unsigned*)(win + (warp + a) * WS);
    unsigned sw[SW], ww[WW];
#pragma unroll
    for (int k = 0; k < SW; ++k) sw[k] = sr[k];
#pragma unroll
    for (int k = 0; k < WW; ++k) ww[k] = wr[k];
#pragma unroll
    for (int dx = 0; dx < D1; ++dx) {
      const int q = dx >> 2, j = dx & 3;
#pragma unroll
      for (int k = 0; k < SW; ++k)
        acc[dx] = sad4(sw[k], j ? bytes_at(ww[k + q], ww[min(k + q + 1, WW - 1)], j) : ww[k + q],
                       acc[dx]);
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

// The frame search of one SB per CTA (see the header).
template <int R2, int RL>
__global__ void __launch_bounds__(NT)
frame_kernel(const uint8_t* __restrict__ src0, const uint8_t* __restrict__ src1,
             const uint8_t* __restrict__ src2, const uint8_t* __restrict__ ref0,
             const uint8_t* __restrict__ ref1, const uint8_t* __restrict__ ref2,
             int* __restrict__ out, int hs, int ws, int Hs, int Ws, int hr, int wr, int Hr, int Wr,
             int ox, int sb_rows, int sb_cols) {
  constexpr int D2 = 2 * R2 + 1, S2 = 16 + 2 * R2, G2 = (D2 + 3) / 4;
  constexpr int S2S = S2 + 4;  // L2 window stride: the last group reads one word past a row
  constexpr int DL = 2 * RL + 1, SL = 64 + 2 * RL, DD = DL * DL;
  static_assert(S2 % 4 == 0 && SL % 4 == 0 && DL <= 9, "word-aligned windows, dx within 4 words");
  static_assert(D2 * D2 <= 2048 && DD <= 128, "key index bits");
  // shared layout: the SB's source and the zero-centre leaf window, then
  // the searches' blocks and windows or the SB-MV leaf window and the leaf
  // maps of both centres (the two sets are never live together)
  constexpr int LWB = SL * SL;
  constexpr int O_LWZ = 4096, O_A = O_LWZ + LWB;
  constexpr int O_S2 = O_A, O_W2 = O_S2 + 256, O_S1 = O_W2 + S2 * S2S, O_W1 = O_S1 + 1024;
  constexpr int O_W0 = O_W1 + 36 * 36, END_A = O_W0 + 68 * 68;
  constexpr int O_LW0 = O_A, O_MAPS = O_LW0 + LWB, END_B = O_MAPS + 2 * 64 * DD * 2;
  constexpr int SMEM = END_A > END_B ? END_A : END_B;
  static_assert(O_A % 16 == 0 && O_MAPS % 4 == 0, "aligned regions");
  __shared__ __align__(16) uint8_t sm[SMEM];
  __shared__ unsigned keys[2][NBLK];
  __shared__ unsigned best[3];
  uint8_t* s0 = sm;
  uint16_t* maps = (uint16_t*)(sm + O_MAPS);  // [centre][leaf][dy][dx]; a leaf SAD < 2^14
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, sr = b / sb_cols, sc = b - sr * sb_cols;
  const int H1s = Hs >> 1, W1s = Ws >> 1, H1r = Hr >> 1, W1r = Wr >> 1;

  if (tid < 3) best[tid] = ~0u;
  stage<64, 64>(s0, 64, src0, hs, ws, 64 * sr, 64 * sc);
  stage<SL, SL>(sm + O_LWZ, SL, ref0, hr, wr, 64 * sr - RL, 64 * sc + ox - RL);
  stage<16, 16>(sm + O_S2, 16, src2, H1s >> 1, W1s >> 1, 16 * sr, 16 * sc);
  stage<32, 32>(sm + O_S1, 32, src1, H1s, W1s, 32 * sr, 32 * sc);
  stage<S2, S2>(sm + O_W2, S2S, ref2, H1r >> 1, W1r >> 1, 16 * sr - R2, 16 * sc + (ox >> 2) - R2);
  __syncthreads();

  // ---- L2: a thread owns (dy, four dx); the source rows are broadcasts
  {
    unsigned key = ~0u;
    for (int it = tid; it < D2 * G2; it += NT) {
      const int dy = it / G2, g = it - dy * G2;
      unsigned acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int a = 0; a < 16; ++a) {
        const uint4 sv = *(const uint4*)(sm + O_S2 + a * 16);
        const unsigned* wr = (const unsigned*)(sm + O_W2 + (dy + a) * S2S) + g;
        const unsigned w[5] = {wr[0], wr[1], wr[2], wr[3], wr[4]};
        const unsigned s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[0] = sad4(s[k], w[k], acc[0]);
          acc[1] = sad4(s[k], bytes_at(w[k], w[k + 1], 1), acc[1]);
          acc[2] = sad4(s[k], bytes_at(w[k], w[k + 1], 2), acc[2]);
          acc[3] = sad4(s[k], bytes_at(w[k], w[k + 1], 3), acc[3]);
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
  stage<36, 36>(sm + O_W1, 36, ref1, H1r, W1r, 32 * sr + c1y - R1, 32 * sc + (ox >> 1) + c1x - R1);
  __syncthreads();
  refine<32>(sm + O_S1, sm + O_W1, 2, &best[1]);
  __syncthreads();
  const int d1 = best[1] & 31;
  const int c0y = 2 * (c1y + d1 / D1 - R1), c0x = 2 * (c1x + d1 % D1 - R1);
  stage<68, 68>(sm + O_W0, 68, ref0, hr, wr, 64 * sr + c0y - R1, 64 * sc + ox + c0x - R1);
  __syncthreads();
  refine<64>(s0, sm + O_W0, 4, &best[2]);
  __syncthreads();
  const int d0 = best[2] & 31;
  const int my = c0y + d0 / D1 - R1, mx = c0x + d0 % D1 - R1;  // the SB MV

  // ---- the leaf maps around the SB MV (k = 0) and zero (k = 1), both in
  // one pass: a thread owns (k, leaf, dy) and slides over the dx
  stage<SL, SL>(sm + O_LW0, SL, ref0, hr, wr, 64 * sr + my - RL, 64 * sc + ox + mx - RL);
  __syncthreads();
  for (int it = tid; it < 2 * 64 * DL; it += NT) {
    const int k = it >= 64 * DL, leaf = (it - k * 64 * DL) / DL, dy = it - k * 64 * DL - leaf * DL;
    const int li = leaf >> 3, lj = leaf & 7;
    const uint8_t* lw = sm + (k ? O_LWZ : O_LW0);
    unsigned acc[DL] = {};
#pragma unroll 2
    for (int a = 0; a < 8; ++a) {
      const uint2 sv = *(const uint2*)(s0 + (8 * li + a) * 64 + 8 * lj);
      const unsigned* wr = (const unsigned*)(lw + (8 * li + dy + a) * SL + 8 * lj);
      const unsigned w[4] = {wr[0], wr[1], wr[2], wr[3]};
#pragma unroll
      for (int dx = 0; dx < DL; ++dx) {
        const int q = dx >> 2, j = dx & 3;
        const unsigned lo = j ? bytes_at(w[q], w[q + 1], j) : w[q];
        const unsigned hi = j ? bytes_at(w[q + 1], w[min(q + 2, 3)], j) : w[q + 1];
        acc[dx] = sad4(sv.y, hi, sad4(sv.x, lo, acc[dx]));
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
// (0 VABSDIFF4.U8.ACC, 1 IDP.2A, 2 IDP.4A, 3 IMAD)
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
      else acc[i] = a[i] * b + acc[i];
    }
    b += 0x01010101u;
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int me_sad_launch(int mode, const uint8_t* src0, const uint8_t* src1,
                             const uint8_t* src2, const uint8_t* ref0, const uint8_t* ref1,
                             const uint8_t* ref2, int* out, int hs, int ws, int Hs, int Ws, int hr,
                             int wr, int Hr, int Wr, int ox, int sb_rows, int sb_cols, int l2r,
                             int leafr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {  // pyramid of the source (unless src0 is NULL) and the reference
    const bool two = src0 != nullptr;
    const int qa = two ? (((Hs >> 1) + 1) >> 1) * (((Ws >> 1) + 1) >> 1) : 0;
    const int qb = (((Hr >> 1) + 1) >> 1) * (((Wr >> 1) + 1) >> 1);
    const int quads = qa > qb ? qa : qb;
    if (quads == 0) return 0;
    uint8_t *a1 = (uint8_t*)src1, *a2 = (uint8_t*)src2, *b1 = (uint8_t*)ref1, *b2 = (uint8_t*)ref2;
    if (two)
      pyramid_kernel<<<dim3((quads + 255) / 256, 2), 256, 0, st>>>(
          src0, a1, a2, hs, ws, Hs, Ws, ref0, b1, b2, hr, wr, Hr, Wr);
    else
      pyramid_kernel<<<dim3((quads + 255) / 256, 1), 256, 0, st>>>(
          ref0, b1, b2, hr, wr, Hr, Wr, nullptr, nullptr, nullptr, 0, 0, 0, 0);
  } else if (mode == 1) {
    if (l2r != 16 || leafr != 4) return (int)cudaErrorInvalidValue;
    const int B = sb_rows * sb_cols;
    if (B == 0) return 0;
    frame_kernel<16, 4><<<B, NT, 0, st>>>(src0, src1, src2, ref0, ref1, ref2, out, hs, ws, Hs,
                                          Ws, hr, wr, Hr, Wr, ox, sb_rows, sb_cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}

extern "C" int packed_rate_launch(int which, int blocks, int iters, unsigned* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 0) packed_rate_kernel<0><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 1) packed_rate_kernel<1><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 2) packed_rate_kernel<2><<<blocks, 256, 0, st>>>(iters, out);
  else if (which == 3) packed_rate_kernel<3><<<blocks, 256, 0, st>>>(iters, out);
  else return (int)cudaErrorInvalidValue;
  return launch_status();
}
