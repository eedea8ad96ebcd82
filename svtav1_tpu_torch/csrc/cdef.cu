// K6 cdef_dir and K7 cdef_search / cdef_apply: CDEF (AV1 spec 7.15) on whole
// frames.
//
// K6 gives, per 8x8 luma cell, the normative direction (the first of the
// eight with the largest cost) and the variance (best cost minus the cost of
// the orthogonal direction, >> 10). Replaces
// svtav1_tpu/filters/cdef_jax.py::find_dir_j (:26-65), which keeps each cost
// as a split (hi, lo) int32 pair because a TPU has no int64. Bound: bytes,
// F·H·W·4 read and 2·cells·4 written (0.0026 ms for a 1080p luma plane on
// the H100); its 1,000 or so integer operations per cell are below that.
// Exact for samples in [0, 2^(8 + coeff_shift) - 1], the range of every
// recon plane (the plain version, find_dir_plain, is int64 for any int32).
// Design, against what held the first port's thread-per-cell kernel back:
// - Two threads per cell on one code path. The costs of directions 0-3 of
//   the cell rotated by 90 degrees (y[i][j] = x[j][7 - i]) are the costs of
//   directions 4-7 of the cell: the bins come out reversed and the weights
//   are symmetric. So lane 0 of a pair runs directions 0-3 on the cell and
//   lane 1 the same instructions on the rotated cell, read from a rotated
//   copy: twice the threads in flight (64,800 at 1080p), half the chain
//   each. The pair swaps its four costs with shuffles; both lanes take the
//   first of the eight with the largest cost and lane 0 writes.
// - 16-byte loads. A CTA stages a band of 8 rows by kDirCells cells with
//   coalesced int4 loads, 8 in flight per thread (scalar loads where the
//   plane is not 16-byte aligned), as int8 x = (p >> coeff_shift) - 128 in
//   shared memory: the cells as they are and rotated, in padded row-major
//   bands that the staging stores and the lanes' 8-byte row reads touch
//   without bank conflicts.
// - 32-bit costs: the partials, costs, argmax and subtraction are int32
//   (the bound is kDirCostMax below), where the first port kept int64.
// - A shorter chain: directions 1-3 take the columns two at a time, so the
//   column pairs are summed once for all three.
//
// K7 is two entry points. cdef_search gives, per strength candidate of a
// ladder (K <= 8) and frame, the int64 SSE of the luma plane's masked
// filtered samples against the source: the frame-level strength search.
// cdef_apply takes each frame's candidate of least SSE (the first on ties,
// as torch.argmin), derives the chroma strengths (uv = y >> 1), writes the
// (F, 4) strengths and filters Y, U and V with them in one launch. The
// primary strength is adjusted per luma cell by its variance; cells outside
// the non-skip mask keep their input. Replaces cdef_jax.py::_tap_stack_j
// (:129-163), _filter_from_taps_j (:166-191) and _adjust_strength_j
// (:68-72) as cdef_frames_j (:203-284) chains them, with its argmin and
// strength glue. The reference shifts the whole padded plane for all eight
// directions and selects per pixel (a TPU workaround for dynamic gathers);
// here each sample reads its twelve taps directly. Samples outside the
// plane are CDEF_VERY_LARGE, which never wins the max.
//
// Bound: the search's operations (per unmasked sample, the tap work once
// and a constrained sum per candidate; utils/profile_keyframes
// cdef_search_work), the apply's bytes (three planes read and written).
// Design of the search: a CTA stages a tile of 4 x 8 luma cells and its
// 2-sample halo once in shared memory as int16 (16-byte loads); a warp per
// cell reads the cell's mask, direction and variance once, and a masked-out
// cell (or a tile without one unmasked cell) costs nothing more. Per sample
// the twelve tap differences and the max and min over the taps are
// computed once; per candidate only the strengths, the constrained sum, the
// clamp and the squared error. The K sums stay in registers, are reduced per
// warp and per CTA and added with one 64-bit atomic per candidate and CTA.
// The apply: one thread per sample, the three planes' blocks in one grid;
// each CTA takes its frame's argmin from the search's sums itself, so no
// host or PyTorch step sits between the two launches.
#include "common.cuh"

namespace {

constexpr int CDEF_VERY_LARGE = 0x7F7F;

// Cdef_Directions (spec 7.15.3): (dy, dx) per direction and tap k = 0, 1.
__constant__ int c_dirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
__constant__ int c_pri_taps[2][2] = {{4, 2}, {3, 3}};
__constant__ int c_sec_taps[2] = {2, 1};

__device__ __forceinline__ int msb(int v) { return v > 0 ? 31 - __clz(v) : 0; }

// K6's staging: a CTA's band of 8 rows by kDirCells cells, as words of four
// int8 samples. Rows of kDirPitch words: rows 4 apart lie 16 banks apart.
// The rotated band starts kDirBand words on, 16 banks on from the first.
constexpr int kDirCells = 16;
constexpr int kDirPitch = 2 * kDirCells + 4;
constexpr int kDirBand = 8 * kDirPitch + 16;
static_assert((4 * kDirPitch) % 32 == 16 && kDirBand % 32 == 16, "K6's staging banks");

// A bin of n samples weighs 840 / n, and |x| <= 128 makes |partial| <= 128 n,
// so a direction's cost is at most sum_k 128^2 n_k (840 / n_k) n_k = 2^14 · 840
// · 64 over its 64 samples: an int32 holds every partial, cost and
// difference of costs (flat cells of 0 reach the bound).
constexpr long long kDirCostMax = 128LL * 128 * 840 * 64;
static_assert(kDirCostMax == 880803840LL && kDirCostMax < (1LL << 31), "K6's costs in int32");

// find_dir's weights of directions 0-3 per partial-sum bin (filters/cdef.py
// _cost_weights); directions 4-7 repeat them
__constant__ int c_cw[4][15] = {
    {840, 420, 280, 210, 168, 140, 120, 105, 120, 140, 168, 210, 280, 420, 840},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {105, 105, 105, 105, 105, 105, 105, 105, 0, 0, 0, 0, 0, 0, 0},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0}};

template <int D, int N>
__device__ __forceinline__ int weigh(const int (&p)[15]) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) s += p[k] * p[k] * c_cw[D][k];
  return s;
}

// The costs of directions 0-3 of an 8x8 cell of samples in [-128, 127]
// (filters/cdef.py _partial_matrices: bins i + j, i + j / 2, i, 3 + i - j / 2)
__device__ __forceinline__ void dir_costs(const int (&x)[8][8], int (&cost)[4]) {
  int p[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) p[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) p[i + j] += x[i][j];
  cost[0] = weigh<0, 15>(p);
  int two[8][4];  // directions 1-3 take the columns two at a time
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) two[i][m] = x[i][2 * m] + x[i][2 * m + 1];
#pragma unroll
  for (int k = 0; k < 11; ++k) p[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) p[i + m] += two[i][m];
  cost[1] = weigh<1, 11>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = two[i][0] + two[i][1] + two[i][2] + two[i][3];
  cost[2] = weigh<2, 8>(p);
#pragma unroll
  for (int k = 0; k < 11; ++k) p[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) p[3 + i - m] += two[i][m];
  cost[3] = weigh<3, 11>(p);
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (unsigned)(a & 255) | (unsigned)(b & 255) << 8 | (unsigned)(c & 255) << 16 |
         (unsigned)d << 24;
}

// Grid (ceil(C / kDirCells), H / 8, F), 2 kDirCells threads: thread t is lane
// t & 1 of cell t >> 1 of the band and stages the cell's columns 4 (t & 1) to
// 4 (t & 1) + 3.
__global__ void __launch_bounds__(2 * kDirCells)
    cdef_dir_kernel(const int* __restrict__ plane, int* __restrict__ dirs,
                    int* __restrict__ var, int H, int W, int coeff_shift, bool vec) {
  __shared__ __align__(16) unsigned band[2 * kDirBand];
  const int C = W >> 3, r = blockIdx.y, f = blockIdx.z;
  const int t = threadIdx.x, cell = t >> 1, lane = t & 1;
  const int c = blockIdx.x * kDirCells + cell;
  if (c < C) {
    const int* P = plane + ((size_t)f * H + r * 8) * W + c * 8 + lane * 4;
    int v[8][4];
    if (vec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(P + (size_t)i * W));
        v[i][0] = q.x;
        v[i][1] = q.y;
        v[i][2] = q.z;
        v[i][3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) v[i][k] = __ldg(P + (size_t)i * W + k);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[i][k] = (v[i][k] >> coeff_shift) - 128;
#pragma unroll
    for (int i = 0; i < 8; ++i)  // row i of the band: this thread's four samples
      band[i * kDirPitch + t] = pack4(v[i][0], v[i][1], v[i][2], v[i][3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // column 4 lane + k, top down: row 7 - 4 lane - k rotated
      const uint2 w = make_uint2(pack4(v[0][k], v[1][k], v[2][k], v[3][k]),
                                 pack4(v[4][k], v[5][k], v[6][k], v[7][k]));
      *reinterpret_cast<uint2*>(band + kDirBand + (7 - 4 * lane - k) * kDirPitch + 2 * cell) = w;
    }
  }
  __syncthreads();
  if (c >= C) return;
  const unsigned* rows = band + lane * kDirBand + 2 * cell;  // the cell, or the rotated cell
  int x[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint2 w = *reinterpret_cast<const uint2*>(rows + i * kDirPitch);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i][j] = (int)(signed char)((j < 4 ? w.x : w.y) >> (8 * (j & 3)));
  }
  int own[4], lo[4], hi[4];
  dir_costs(x, own);
  const unsigned pair = 3u << (t & 30);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int other = __shfl_xor_sync(pair, own[k], 1);
    lo[k] = lane ? other : own[k];  // directions 0-3
    hi[k] = lane ? own[k] : other;  // directions 4-7
  }
  // the first direction of the largest cost, and the cost of the one 4 on
  int best = 0, bc = lo[0], oc = hi[0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (lo[k] > bc) {
      best = k;
      bc = lo[k];
      oc = hi[k];
    }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (hi[k] > bc) {
      best = 4 + k;
      bc = hi[k];
      oc = lo[k];
    }
  if (lane == 0) {
    const size_t o = ((size_t)f * (H >> 3) + r) * C + c;
    dirs[o] = best;
    var[o] = (bc - oc) >> 10;
  }
}

// CDEF's constrain(diff, s, damping), given the strength's shift
// max(0, damping - msb(s))
__device__ __forceinline__ int constrain_sh(int diff, int s, int shift) {
  const int ad = abs(diff);
  const int mag = min(ad, max(0, s - (ad >> shift)));
  return s <= 0 ? 0 : (diff < 0 ? -mag : mag);
}

// adjust_strength: the luma primary strength by the cell's variance
__device__ __forceinline__ int adjust_strength(int ps, int vv) {
  const int i = (vv >> 6) > 0 ? min(msb(vv >> 6), 12) : 0;
  return vv != 0 ? (ps * (4 + i) + 8) >> 4 : 0;
}

constexpr int kMaxCand = 8;

// A ladder of strength candidates, passed by value (unshifted values).
struct Ladder {
  int pri[kMaxCand], sec[kMaxCand];
};

constexpr int kTileR = 4, kTileC = 8;  // the search's tile of luma cells
constexpr int kSH = kTileR * 8 + 4, kSW = kTileC * 8 + 4;  // with the 2-sample halo
constexpr int kSearchWarps = 8;

__global__ void __launch_bounds__(kSearchWarps * 32)
    cdef_search_kernel(const int* __restrict__ plane, const int* __restrict__ dirs,
                       const int* __restrict__ var, const uint8_t* __restrict__ mask,
                       const int* __restrict__ src, unsigned long long* __restrict__ sse,
                       Ladder lad, int K, int F, int H, int W, int damping, int coeff_shift,
                       bool vec) {
  __shared__ short tile[kSH][kSW];
  __shared__ unsigned long long part[kSearchWarps][kMaxCand];
  const int R = H >> 3, C = W >> 3;
  const int f = blockIdx.z;
  const int cr0 = blockIdx.y * kTileR, cc0 = blockIdx.x * kTileC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a tile without an unmasked cell ends here
  bool on = false;
  if (threadIdx.x < kTileR * kTileC) {
    const int r = cr0 + threadIdx.x / kTileC, c = cc0 + threadIdx.x % kTileC;
    on = r < R && c < C && mask[((size_t)f * R + r) * C + c];
  }
  if (!__syncthreads_or(on)) return;

  // stage rows y0 - 2 .. and columns x0 - 2 .. of the tile as int16
  const int* P = plane + (size_t)f * H * W;
  const int y0 = cr0 * 8 - 2, x0 = cc0 * 8 - 2;
  if (vec) {  // 16-byte chunks from x0 - 2, a multiple of 4
    constexpr int kChunks = (kSW + 4) / 4;
    for (int q = threadIdx.x; q < kSH * kChunks; q += blockDim.x) {
      const int ty = q / kChunks, xc = x0 - 2 + 4 * (q % kChunks), y = y0 + ty;
      int4 v = make_int4(CDEF_VERY_LARGE, CDEF_VERY_LARGE, CDEF_VERY_LARGE, CDEF_VERY_LARGE);
      if (y >= 0 && y < H && xc >= 0 && xc < W)
        v = __ldg(reinterpret_cast<const int4*>(P + (size_t)y * W + xc));
      const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tx = xc + u - x0;
        if (tx >= 0 && tx < kSW) tile[ty][tx] = (short)vals[u];
      }
    }
  } else {
    for (int q = threadIdx.x; q < kSH * kSW; q += blockDim.x) {
      const int ty = q / kSW, tx = q % kSW, y = y0 + ty, x = x0 + tx;
      tile[ty][tx] = (short)((y >= 0 && y < H && x >= 0 && x < W) ? P[(size_t)y * W + x]
                                                                    : CDEF_VERY_LARGE);
    }
  }
  __syncthreads();

  unsigned acc[kMaxCand];
#pragma unroll
  for (int k = 0; k < kMaxCand; ++k) acc[k] = 0;
  for (int ci = warp; ci < kTileR * kTileC; ci += kSearchWarps) {
    const int lr = ci / kTileC, lc = ci % kTileC;
    const int r = cr0 + lr, c = cc0 + lc;
    if (r >= R || c >= C) continue;
    const size_t cell = ((size_t)f * R + r) * C + c;
    if (!mask[cell]) continue;
    const int d = dirs[cell], vv = var[cell];
    const int d2 = (d + 2) & 7, d6 = (d - 2) & 7;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two samples of the cell per lane
      const int s = lane + 32 * h, i = s >> 3, j = s & 7;
      const int ty = lr * 8 + i + 2, tx = lc * 8 + j + 2;
      const int x = tile[ty][tx];
      // the twelve tap differences (primary, then the two secondary
      // directions; taps k = 0, 1; signs +, -) and the max and min
      int dp[4], ds[8];
      int mx = x, mn = x;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int tt = 0; tt < 3; ++tt) {
          const int dd = tt == 0 ? d : (tt == 1 ? d2 : d6);
          const int dy = c_dirs[dd][k][0], dx = c_dirs[dd][k][1];
#pragma unroll
          for (int sg = 0; sg < 2; ++sg) {
            const int tv = sg == 0 ? tile[ty + dy][tx + dx] : tile[ty - dy][tx - dx];
            if (tt == 0) dp[2 * k + sg] = tv - x;
            else ds[4 * (tt - 1) + 2 * k + sg] = tv - x;
            if (tv != CDEF_VERY_LARGE) mx = max(mx, tv);
            mn = min(mn, tv);
          }
        }
      }
      const int sv = src[((size_t)f * H + r * 8 + i) * W + c * 8 + j];
#pragma unroll
      for (int k = 0; k < kMaxCand; ++k) {
        if (k >= K) break;
        const int ps = adjust_strength(lad.pri[k] << coeff_shift, vv);
        const int ss = lad.sec[k] << coeff_shift;
        const int psh = max(0, damping - msb(ps)), ssh = max(0, damping - msb(ss));
        const int ts = (ps >> coeff_shift) & 1;
        int sum = 0;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int w = c_pri_taps[ts][kk];
          sum += w * constrain_sh(dp[2 * kk], ps, psh);
          sum += w * constrain_sh(dp[2 * kk + 1], ps, psh);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) sum += c_sec_taps[(q >> 1) & 1] * constrain_sh(ds[q], ss, ssh);
        const int v = clampi(x + ((8 + sum - (sum < 0)) >> 4), mn, mx);
        acc[k] += (unsigned)((v - sv) * (v - sv));
      }
    }
  }
  // per warp, then per CTA, one 64-bit atomic per candidate
#pragma unroll
  for (int k = 0; k < kMaxCand; ++k) {
    unsigned long long tot = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    if (lane == 0) part[warp][k] = tot;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    unsigned long long tot = 0;
#pragma unroll
    for (int w = 0; w < kSearchWarps; ++w) tot += part[w][threadIdx.x];
    if (tot) atomicAdd(sse + (size_t)threadIdx.x * F + f, tot);
  }
}

// One sample of a CDEF-filtered plane: direction d, primary strength ps
// (already adjusted), secondary ss.
__device__ __forceinline__ int cdef_sample(const int* __restrict__ P, int H, int W, int y, int x,
                                           int d, int ps, int ss, int damping,
                                           int coeff_shift) {
  const int x0 = P[(size_t)y * W + x];
  const int ts = (ps >> coeff_shift) & 1;
  const int psh = max(0, damping - msb(ps)), ssh = max(0, damping - msb(ss));
  int sum = 0, mx = x0, mn = x0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // primary, then the two secondary directions
      const int dd = t == 0 ? d : (t == 1 ? (d + 2) & 7 : (d - 2) & 7);
      const int dy = c_dirs[dd][k][0], dx = c_dirs[dd][k][1];
#pragma unroll
      for (int sg = 1; sg >= -1; sg -= 2) {
        const int yy = y + sg * dy, xx = x + sg * dx;
        const int tv = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? P[(size_t)yy * W + xx]
                                                                 : CDEF_VERY_LARGE;
        if (t == 0) sum += c_pri_taps[ts][k] * constrain_sh(tv - x0, ps, psh);
        else sum += c_sec_taps[k] * constrain_sh(tv - x0, ss, ssh);
        if (tv != CDEF_VERY_LARGE) mx = max(mx, tv);
        mn = min(mn, tv);
      }
    }
  }
  return clampi(x0 + ((8 + sum - (sum < 0)) >> 4), mn, mx);
}

struct Planes3 {
  const int* in[3];
  int* out[3];
};

__global__ void __launch_bounds__(256)
    cdef_apply_kernel(Planes3 pls, const int* __restrict__ dirs, const int* __restrict__ var,
                      const uint8_t* __restrict__ mask, const unsigned long long* __restrict__ sse,
                      int* __restrict__ strengths, Ladder lad, int K, int F, int H, int W,
                      int damping, int coeff_shift) {
  // blockIdx.x: the luma plane's blocks, then each chroma plane's
  const int f = blockIdx.y;
  const int nby = (H * W + 255) / 256, nbc = ((H >> 1) * (W >> 1) + 255) / 256;
  const int bx = blockIdx.x;
  const int pl = bx < nby ? 0 : (bx < nby + nbc ? 1 : 2);
  const int Hp = pl ? H >> 1 : H, Wp = pl ? W >> 1 : W, log2m = pl ? 2 : 3;
  const int p = (pl == 0 ? bx : bx - nby - (pl - 1) * nbc) * blockDim.x + threadIdx.x;
  // the frame's candidate: least SSE, the first on ties, by the first warp
  // (a lane per candidate); the ladder read at static indices only (a
  // dynamic index would copy it to local memory)
  __shared__ int s_pri, s_sec;
  if (threadIdx.x < 32) {
    const int k = threadIdx.x;
    unsigned long long v = k < K ? sse[(size_t)k * F + f] : ~0ull;
    int bk = k;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      if (ov < v || (ov == v && ok < bk)) {
        v = ov;
        bk = ok;
      }
    }
    if (k == 0) {
      int y_pri = lad.pri[0], y_sec = lad.sec[0];
#pragma unroll
      for (int c = 1; c < kMaxCand; ++c) {
        if (c == bk) {
          y_pri = lad.pri[c];
          y_sec = lad.sec[c];
        }
      }
      s_pri = y_pri;
      s_sec = y_sec;
      if (bx == 0) {
        int* st = strengths + 4 * (size_t)f;
        st[0] = y_pri;
        st[1] = y_sec;
        st[2] = y_pri >> 1;  // ladder sec 0/1/2 -> 0/1, never 3
        st[3] = y_sec >> 1;
      }
    }
  }
  __syncthreads();
  const int y_pri = s_pri, y_sec = s_sec;
  if (p >= Hp * Wp) return;
  const int y = p / Wp, x = p - y * Wp;
  const int C = W >> 3;
  const size_t ci = ((size_t)f * (H >> 3) + (y >> log2m)) * C + (x >> log2m);
  const size_t off = (size_t)f * Hp * Wp;
  const int* P = (pl == 0 ? pls.in[0] : pl == 1 ? pls.in[1] : pls.in[2]) + off;
  int* out = (pl == 0 ? pls.out[0] : pl == 1 ? pls.out[1] : pls.out[2]) + off;
  int v = P[p];
  if (mask[ci]) {
    int ps, ss, damp;
    if (pl == 0) {
      ps = adjust_strength(y_pri << coeff_shift, var[ci]);
      ss = y_sec << coeff_shift;
      damp = damping + coeff_shift;
    } else {
      ps = (y_pri >> 1) << coeff_shift;
      ss = (y_sec >> 1) << coeff_shift;
      damp = damping + coeff_shift - 1;
    }
    v = cdef_sample(P, Hp, Wp, y, x, dirs[ci], ps, ss, damp, coeff_shift);
  }
  out[p] = v;
}

}  // namespace

extern "C" int cdef_dir_launch(const int* plane, int* dirs, int* var, int F, int H, int W,
                               int coeff_shift, void* stream) {
  if (F * (H >> 3) * (W >> 3) == 0) return 0;
  const bool vec = ((uintptr_t)plane & 15) == 0 && (W & 3) == 0;
  const dim3 grid(((W >> 3) + kDirCells - 1) / kDirCells, H >> 3, F);
  cdef_dir_kernel<<<grid, 2 * kDirCells, 0, (cudaStream_t)stream>>>(plane, dirs, var, H, W,
                                                                   coeff_shift, vec);
  return launch_status();
}

static bool ladder_of(const int* pri, const int* sec, int K, Ladder& lad) {
  if (K < 1 || K > kMaxCand) return false;
  for (int k = 0; k < kMaxCand; ++k) {
    lad.pri[k] = k < K ? pri[k] : 0;
    lad.sec[k] = k < K ? sec[k] : 0;
  }
  return true;
}

// plane, src (F, H, W) int32 luma; dirs, var (F, H/8, W/8) int32; mask
// (F, H/8, W/8) bool; sse (K, F) int64, zeroed by the caller; pri, sec: the
// K <= 8 candidates' strengths in host memory; damping: the frame's luma
// damping before the coefficient shift.
extern "C" int cdef_search_launch(const int* plane, const int* dirs, const int* var,
                                  const uint8_t* mask, const int* src, unsigned long long* sse,
                                  const int* pri, const int* sec, int K, int F, int H, int W,
                                  int damping, int coeff_shift, void* stream) {
  Ladder lad;
  if (!ladder_of(pri, sec, K, lad)) return (int)cudaErrorInvalidValue;
  if (F * H * W == 0) return 0;
  const bool vec = ((uintptr_t)plane & 15) == 0 && (W & 3) == 0;
  const dim3 grid(((W >> 3) + kTileC - 1) / kTileC, ((H >> 3) + kTileR - 1) / kTileR, F);
  cdef_search_kernel<<<grid, kSearchWarps * 32, 0, (cudaStream_t)stream>>>(
      plane, dirs, var, mask, src, sse, lad, K, F, H, W, damping + coeff_shift, coeff_shift, vec);
  return launch_status();
}

// y, u, v -> oy, ou, ov: (F, H, W) luma and (F, H/2, W/2) chroma int32;
// strengths (F, 4) int32 out; the rest as cdef_search_launch.
extern "C" int cdef_apply_launch(const int* y, const int* u, const int* v, int* oy, int* ou,
                                 int* ov, const int* dirs, const int* var, const uint8_t* mask,
                                 const unsigned long long* sse, int* strengths, const int* pri,
                                 const int* sec, int K, int F, int H, int W, int damping,
                                 int coeff_shift, void* stream) {
  Ladder lad;
  if (!ladder_of(pri, sec, K, lad)) return (int)cudaErrorInvalidValue;
  if (F * H * W == 0) return 0;
  const Planes3 pls = {{y, u, v}, {oy, ou, ov}};
  const dim3 grid((H * W + 255) / 256 + 2 * (((H >> 1) * (W >> 1) + 255) / 256), F);
  cdef_apply_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(pls, dirs, var, mask, sse, strengths,
                                                            lad, K, F, H, W, damping,
                                                            coeff_shift);
  return launch_status();
}
