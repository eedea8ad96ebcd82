// MCTF (motion-compensated temporal filtering) kernels of the port.
//
// K12 tf_filter: the weighted temporal average of the three planes of one
// frame. For each sample of the centre frame, a = centre and ws = 1; then
// for each of the K motion-compensated neighbours k in order: s = the 5x5
// edge-replicated window sum of the squared error pred_k - centre, d = s /
// 25, w = exp(-d / h2), a += w * pred_k, ws += w. The output is clip(rint(a /
// ws), 0, 2^bd - 1), rint rounding half to even.
// Replaces svtav1_tpu/ops/tf_jax.py::_tf_jit.run's weighting and
// normalisation (:106-118, with _box5 at :49), which takes the window mean
// from a float32 summed-area table over the whole plane. Here the window sum
// is an exact int32 sum (at most 25 * 1023^2 < 2^31), divided by 25 in
// float32; every float32 step is an explicitly rounded intrinsic in the
// reference's order (no multiply-add contraction), and exp is computed in
// double and rounded once to float32, so the kernel equals its plain
// PyTorch version. Where the reference's float32 table is exact (planes
// small enough, as at the test sizes) the two agree.
// Bound: bytes. The K predictions are int32 (K9's luma blocks, K10's U and V
// blocks) and are read once; the centre is read once in its plane dtype and
// the output written once as int32. One launch takes the three planes: the
// predictions in their block layout, the decay h2 from the card (K13).
// Design: a CTA per group of four consecutive blocks of a block row (a 16x64
// luma tile, 4 KB of contiguous int32 per neighbour, and the co-located 8x32
// U and V tiles): the centre tiles and their 2-sample halos are staged once;
// per neighbour each thread forms the squared errors of one 8-sample row
// segment and its 2-sample halos (16-byte prediction loads, the next
// neighbour's issued before this one's passes; coordinates clamped to the
// plane as the window replicates edges) and their 5-wide row sums, into one
// of two shared buffers; then a thread per column and 8 output rows keeps
// the 5-row window as a running integer sum and its 8 samples' accumulators
// in registers across all K. One barrier per neighbour.
// The weight depends only on s within a launch (h2 is fixed), so it comes
// from a table of w(s) for s below `cap`, filled by the launch itself with
// the same expression (equal by construction): each CTA, as it starts,
// claims a chunk of 256 entries while any is left and fills it; every CTA
// waits for the whole table before its first weight, and a CTA that started
// after it was complete does not wait. The eight weights of a thread's
// column are eight independent loads (L1); a window sum at or past `cap`
// (none on the 8-bit clip, 0.03% on the 10-bit one) computes the
// expression out of line, and past -d / h2 <= -104 (below ln(2^-150), where
// every w rounds to +0.0f) needs no exp. The scratch (claims, fills, CTAs
// done) is zeroed by the last CTA to finish, for the next launch.
//
// K13 tf_noise: the noise estimate's two exact sums over the interior
// samples of the luma plane: the sum of |Laplacian| (3x3 kernel 4, -2 at the
// four edges, 1 at the corners) over the flat samples, and their count, a
// sample being flat when |dx| + |dy| of its central differences is below the
// edge threshold 40 << (bd - 8); then, in the last CTA, the filter's decay h2
// as a float32 on the card, rounded as the host computes it
// (ops/tf_torch.py: estimate_noise, the 0.5 * 2^(bd-8) floor, tf_decay).
// Replaces svtav1_tpu/ops/tf_jax.py::estimate_noise_j (:30-46), which adds
// float32 values in an order that changes the result once the sum passes
// 2^24 (a 1080p plane does), and the decay of :75-87. Bound: bytes (one
// sample read per sample; about 20 operations). Design: a thread per column
// of a 32-row band, the 3x3 window sliding down in registers over coalesced
// row loads, int32 sums per thread and CTA (a static_assert bounds them), one
// 64-bit atomic pair per CTA, and a ticket: the last CTA reads and zeroes the
// sums (the scratch is left zeroed for the next call) and computes h2.
//
// Both kernels are templates on the centre's sample type: uint8_t planes at 8
// bits (tf_filter_launch, tf_noise_launch), int16_t planes at 10 bits
// (tf_filter16_launch, tf_noise16_launch); each entry refuses the other depth.
#include "common.cuh"

namespace {

// ---- K12 tf_filter ----
constexpr int TF_KMAX = 8;        // neighbours a launch takes
constexpr int TF_THREADS = 256;   // a row-segment task each; 192 filter columns
constexpr int LW = 64, LH = 16;   // the luma tile: four 16x16 blocks
constexpr int CW = 32, CH = 8;    // the U and V tiles: four 8x8 blocks each
constexpr int LS = LW + 4, CS = CW + 4;  // centre rows with their halos
constexpr int CEN_U = (LH + 4) * LS, CEN_V = CEN_U + (CH + 4) * CS;
constexpr int CEN_N = CEN_V + (CH + 4) * CS;
constexpr int HS_U = (LH + 4) * LW, HS_V = HS_U + (CH + 4) * CW, HS_N = HS_V + (CH + 4) * CW;
constexpr int PR_U = LH * LW, PR_V = PR_U + CH * CW, PR_N = PR_V + CH * CW;
constexpr int TF_CHUNK = TF_THREADS;  // table entries one claim fills (one a thread)
// one row-segment task per thread: 20 luma rows and 12 rows of U and of V
static_assert((LH + 4) * (LW / 8) + 2 * (CH + 4) * (CW / 8) == TF_THREADS, "tasks");
static_assert(CEN_U % 4 == 0 && CEN_V % 4 == 0 && LS % 4 == 0 && CS % 4 == 0, "16-byte rows");
static_assert(PR_U % 8 == 0 && PR_V % 8 == 0, "16-byte rows of 16-bit predictions");
static_assert(4 * CEN_N + 8 * HS_N + 4 * PR_N <= 48 * 1024, "static shared memory");
// the scratch: the next table chunk to claim, chunks filled, CTAs done
enum { SC_NEXT, SC_DONE, SC_EXITED };

struct TfPreds {
  const int* y[TF_KMAX];   // (B, 16, 16) luma blocks
  const int* uv[TF_KMAX];  // (2, B, 8, 8) U and V blocks
};

__device__ __forceinline__ float tf_exponent(int s, float h2) {
  const float d = __fdiv_rn(__int2float_rn(s), 25.0f);
  return __fdiv_rn(-d, h2);
}

// w(s) = (float)exp((double)(-(s / 25) / h2)). At or below -104 (under
// ln(2^-150)) exp is below half the least float32 denormal and w rounds to
// +0: that needs no exp.
__device__ __forceinline__ float tf_weight(int s, float h2) {
  const float x = tf_exponent(s, h2);
  return x <= -104.0f ? 0.0f : __double2float_rn(exp((double)x));
}

// tf_weight for the window sums past the table (rare: kept out of line)
__device__ __noinline__ float tf_weight_far(int s, float h2) { return tf_weight(s, h2); }

// The launch's table w(s), s < nchunk * TF_CHUNK. Thread 0 looked at the
// start of the CTA: the table was complete then (`ready`), or it claimed a
// chunk (`*claim`; nchunk when none was left). The CTA fills its chunk and
// claims the next until none is left, then thread 0 waits until every chunk
// is in. A chunk is claimed only by a running CTA that fills it before it
// waits, so every wait ends.
__device__ void tf_table(float* table, int* scratch, float h2, int nchunk, bool ready,
                         int* claim) {
  for (int c = *claim; c < nchunk; c = *claim) {
    table[c * TF_CHUNK + threadIdx.x] = tf_weight(c * TF_CHUNK + threadIdx.x, h2);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(&scratch[SC_DONE], 1);
      *claim = atomicAdd(&scratch[SC_NEXT], 1);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && !ready) wait_flag(&scratch[SC_DONE], nchunk);
}

__device__ __forceinline__ int4 ld4(const int* p) { return *reinterpret_cast<const int4*>(p); }
__device__ __forceinline__ int2 ld2(const int* p) { return *reinterpret_cast<const int2*>(p); }
__device__ __forceinline__ void st4(void* p, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}
__device__ __forceinline__ int pack16(int lo, int hi) { return (lo & 0xffff) | (hi << 16); }

// a thread's predictions of one neighbour: 8 samples and the two on each side
struct Seg {
  int4 m0, m1;
  int2 l, r;
};

template <typename T>
__global__ void __launch_bounds__(TF_THREADS, 4)
    tf_filter_kernel(const T* __restrict__ cy, const T* __restrict__ cu, const T* __restrict__ cv,
                     const __grid_constant__ TfPreds preds, int* __restrict__ out,
                     const float* __restrict__ h2p,
                     float* table, int* scratch, int K, int R, int C, int bd, int nchunk) {
  __shared__ __align__(16) int cen[CEN_N];
  __shared__ __align__(16) int hs[2][HS_N];
  __shared__ __align__(16) short pr[2][PR_N];
  __shared__ int claim;
  const int tid = threadIdx.x;
  const float h2 = *h2p;
  const int maxv = (1 << bd) - 1, cap = nchunk * TF_CHUNK;
  bool ready = false;  // thread 0: the table was complete at the start, or a chunk is claimed
  if (tid == 0) {
    ready = ld_acquire(&scratch[SC_DONE]) == nchunk;
    claim = ready ? nchunk : atomicAdd(&scratch[SC_NEXT], 1);
  }
  const int B = R * C, br = blockIdx.x / (C >> 2);
  const int x0 = (blockIdx.x - br * (C >> 2)) * LW, y0 = br * LH;
  const int H = R * LH, W = C * 16, Hc = H >> 1, Wc = W >> 1;
  // the centre tiles with their 2-sample halos, clamped to the planes: loads, then stores
  constexpr int CEN_IT = (CEN_N + TF_THREADS - 1) / TF_THREADS;
  int staged[CEN_IT];
#pragma unroll
  for (int j = 0; j < CEN_IT; ++j) {
    const int e = tid + j * TF_THREADS;
    if (e >= CEN_N) break;
    if (e < CEN_U) {
      const int r = e / LS, c = e - r * LS;
      staged[j] = cy[clampi(y0 + r - 2, 0, H - 1) * W + clampi(x0 + c - 2, 0, W - 1)];
    } else {
      const int v = e < CEN_V ? e - CEN_U : e - CEN_V, r = v / CS, c = v - r * CS;
      staged[j] = (e < CEN_V ? cu : cv)[clampi((y0 >> 1) + r - 2, 0, Hc - 1) * Wc +
                                        clampi((x0 >> 1) + c - 2, 0, Wc - 1)];
    }
  }
#pragma unroll
  for (int j = 0; j < CEN_IT; ++j)
    if (tid + j * TF_THREADS < CEN_N) cen[tid + j * TF_THREADS] = staged[j];
  // this thread's row-segment task: plane (0 Y, 1 U, 2 V), halo row i, 8 columns from lc
  int i, lc, ln2, oy, ox, h, w, cbase, hbase, pbase, pw, rows, plane;
  if (tid < (LH + 4) * (LW / 8)) {
    i = tid >> 3, lc = (tid & 7) * 8, ln2 = 4, oy = y0, ox = x0, h = H, w = W;
    cbase = i * LS + lc, hbase = i * LW + lc, pbase = 0, pw = LW, rows = LH, plane = 0;
  } else {
    const int u = tid - (LH + 4) * (LW / 8), p = u / ((CH + 4) * (CW / 8));
    const int v = u - p * ((CH + 4) * (CW / 8));
    i = v >> 2, lc = (v & 3) * 8, ln2 = 3, oy = y0 >> 1, ox = x0 >> 1, h = Hc, w = Wc;
    cbase = (p ? CEN_V : CEN_U) + i * CS + lc, hbase = (p ? HS_V : HS_U) + i * CW + lc;
    pbase = p ? PR_V : PR_U, pw = CW, rows = CH, plane = 1 + p;
  }
  const int n = 1 << ln2, gy = clampi(oy + i - 2, 0, h - 1), x = ox + lc;
  // offsets in the block layout: row gy's start in its block row, and columns
  const int rowoff = ((gy >> ln2) * C << (2 * ln2)) + ((gy & (n - 1)) << ln2);
  auto at = [&](int col) { return rowoff + ((col >> ln2) << (2 * ln2)) + (col & (n - 1)); };
  const int om = at(x), ol = x > 0 ? at(x - 2) : om, orr = x + 8 < w ? at(x + 8) : om;
  auto load = [&](int k) {
    const int* P = plane == 0 ? preds.y[k] : preds.uv[k] + (plane - 1) * B * 64;
    return Seg{ld4(P + om), ld4(P + om + 4), ld2(P + ol), ld2(P + orr)};
  };
  // the pass-2 role: luma columns (two halves of 8 rows), then U and V
  const bool filters = tid < 192;
  const int fl = tid < 128 ? 0 : 1 + ((tid - 128) >> 5);
  const int fc = tid < 128 ? (tid & 63) : (tid & 31), fr = tid < 128 ? (tid >> 6) * 8 : 0;
  const int fw = fl ? CW : LW, fs = fl ? CS : LS;
  const int fh = fl == 0 ? 0 : fl == 1 ? HS_U : HS_V, fp = fl == 0 ? 0 : fl == 1 ? PR_U : PR_V;
  const int fcen = (fl == 0 ? 0 : fl == 1 ? CEN_U : CEN_V) + (fr + 2) * fs + fc + 2;
  Seg next = load(0);
  __syncthreads();  // the centre is staged
  float a[8], ws[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) a[r] = __int2float_rn(cen[fcen + r * fs]), ws[r] = 1.0f;
  for (int k = 0; k < K; ++k) {
    const int b = k & 1;
    const Seg cur = next;
    if (k + 1 < K) next = load(k + 1);  // in flight through this neighbour's passes
    int pv[12];
    pv[2] = cur.m0.x, pv[3] = cur.m0.y, pv[4] = cur.m0.z, pv[5] = cur.m0.w;
    pv[6] = cur.m1.x, pv[7] = cur.m1.y, pv[8] = cur.m1.z, pv[9] = cur.m1.w;
    pv[0] = x > 0 ? cur.l.x : pv[2], pv[1] = x > 0 ? cur.l.y : pv[2];
    pv[10] = x + 8 < w ? cur.r.x : pv[9], pv[11] = x + 8 < w ? cur.r.y : pv[9];
    const int4 c0 = ld4(cen + cbase), c1 = ld4(cen + cbase + 4), c2 = ld4(cen + cbase + 8);
    const int cn[12] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
    int e[12];
#pragma unroll
    for (int m = 0; m < 12; ++m) e[m] = (pv[m] - cn[m]) * (pv[m] - cn[m]);
    int hsum[8];
    hsum[0] = e[0] + e[1] + e[2] + e[3] + e[4];
#pragma unroll
    for (int m = 1; m < 8; ++m) hsum[m] = hsum[m - 1] + e[m + 4] - e[m - 1];
    st4(hs[b] + hbase, hsum[0], hsum[1], hsum[2], hsum[3]);
    st4(hs[b] + hbase + 4, hsum[4], hsum[5], hsum[6], hsum[7]);
    if (i >= 2 && i < rows + 2)
      st4(pr[b] + pbase + (i - 2) * pw + lc, pack16(pv[2], pv[3]), pack16(pv[4], pv[5]),
          pack16(pv[6], pv[7]), pack16(pv[8], pv[9]));
    if (k == 0) tf_table(table, scratch, h2, nchunk, ready, &claim);  // complete before read
    __syncthreads();
    if (filters) {
      const int* hcol = hs[b] + fh + fr * fw + fc;
      const short* pcol = pr[b] + fp + fr * fw + fc;
      int sv[8];
      sv[0] = hcol[0] + hcol[fw] + hcol[2 * fw] + hcol[3 * fw] + hcol[4 * fw];
#pragma unroll
      for (int r = 1; r < 8; ++r) sv[r] = sv[r - 1] + hcol[(r + 4) * fw] - hcol[(r - 1) * fw];
      float wt[8];  // all eight loads in flight at once; past the table, the expression
#pragma unroll
      for (int r = 0; r < 8; ++r) wt[r] = table[min(sv[r], cap - 1)];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (sv[r] >= cap) wt[r] = tf_weight_far(sv[r], h2);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        a[r] = __fadd_rn(a[r], __fmul_rn(wt[r], __int2float_rn(pcol[r * fw])));
        ws[r] = __fadd_rn(ws[r], wt[r]);
      }
    }
  }
  if (filters) {
    const int ow = fl ? Wc : W, oy0 = (fl ? y0 >> 1 : y0) + fr, ox0 = (fl ? x0 >> 1 : x0) + fc;
    int* o = out + (fl == 0 ? 0 : fl == 1 ? H * W : H * W + Hc * Wc) + oy0 * ow + ox0;
#pragma unroll
    for (int r = 0; r < 8; ++r) o[r * ow] = clampi((int)rintf(__fdiv_rn(a[r], ws[r])), 0, maxv);
  }
  if (tid == 0 && atomicAdd(&scratch[SC_EXITED], 1) == (int)gridDim.x - 1) {
    scratch[SC_NEXT] = 0;  // the last CTA leaves the scratch zeroed for the next launch
    scratch[SC_DONE] = 0;
    scratch[SC_EXITED] = 0;
  }
}

template <typename T>
int tf_filter_run(const T* cy, const T* cu, const T* cv, const long long* ptrs, int* out,
                  const float* h2, float* table, int* scratch, int K, int R, int C, int bd,
                  int cap, void* stream) {
  if (K < 1 || K > TF_KMAX || R < 1 || C < 4 || C % 4 || cap < TF_CHUNK || cap % TF_CHUNK)
    return (int)cudaErrorInvalidValue;
  if ((long long)R * C * 384 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  TfPreds p;
  for (int k = 0; k < K; ++k) {
    p.y[k] = (const int*)ptrs[k];
    p.uv[k] = (const int*)ptrs[K + k];
    if (((size_t)p.y[k] | (size_t)p.uv[k]) & 15) return (int)cudaErrorInvalidValue;
  }
  if ((size_t)table & 15) return (int)cudaErrorInvalidValue;
  tf_filter_kernel<T><<<R * (C / 4), TF_THREADS, 0, (cudaStream_t)stream>>>(
      cy, cu, cv, p, out, h2, table, scratch, K, R, C, bd, cap / TF_CHUNK);
  return launch_status();
}

// ---- K13 tf_noise ----
constexpr int NZ_THREADS = 128, NZ_BAND = 32;
// a CTA's |Laplacian| sum (at most 16 * 1023 a sample) fits int32
static_assert((long long)NZ_THREADS * NZ_BAND * 16 * 1023 < (1LL << 31), "int32 CTA sums");

// h2 = 2 (sigma^2 + strength^2), sigma = max(s / max(cnt, 1) * scale,
// 0.5 * 2^(bd-8)), each step rounded as ops/tf_torch.py rounds it in numpy:
// float32 quotient and product, the exact double product sigma * sigma plus
// the float32 strength^2 rounded once to float32 (tf_decay), times 2.
__device__ float tf_decay(long long s, long long cnt, float scale, float strength, int bd) {
  const float mean = __fdiv_rn(__ll2float_rn(s), __ll2float_rn(cnt > 1 ? cnt : 1));
  const float sigma = fmaxf(__fmul_rn(mean, scale), 0.5f * (float)(1 << (bd - 8)));
  const double fused = __dadd_rn(__dmul_rn((double)sigma, (double)sigma),
                                 (double)__fmul_rn(strength, strength));
  return __fmul_rn(2.0f, __double2float_rn(fused));
}

template <typename T>
__global__ void __launch_bounds__(NZ_THREADS)
    tf_noise_kernel(const T* __restrict__ y, unsigned long long* acc, long long* __restrict__ sums,
                    float* __restrict__ h2, int H, int W, int bd, float scale, float strength) {
  __shared__ int part[NZ_THREADS / 32][2];
  const int thr = 40 << (bd - 8);  // ops/tf_torch.py _flat_threshold
  const int c = 1 + blockIdx.x * NZ_THREADS + threadIdx.x;
  const int r0 = 1 + blockIdx.y * NZ_BAND, r1 = min(r0 + NZ_BAND, H - 1);
  int s = 0, cnt = 0;
  if (c < W - 1 && r0 < r1) {
    const T* p = y + (r0 - 1) * W + c;
    int a0 = p[-1], a1 = p[0], a2 = p[1];
    p += W;
    int b0 = p[-1], b1 = p[0], b2 = p[1];
    for (int r = r0; r < r1; ++r) {
      p += W;
      const int c0 = p[-1], c1 = p[0], c2 = p[1];
      const int lap = 4 * b1 - 2 * (b0 + b2 + a1 + c1) + a0 + a2 + c0 + c2;
      if (abs(b2 - b0) + abs(c1 - a1) < thr) {
        s += abs(lap);
        ++cnt;
      }
      a0 = b0, a1 = b1, a2 = b2, b0 = c0, b1 = c1, b2 = c2;
    }
  }
  s = __reduce_add_sync(0xffffffffu, s);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][0] = s, part[threadIdx.x >> 5][1] = cnt;
  __syncthreads();
  if (threadIdx.x) return;
  for (int w = 1; w < NZ_THREADS / 32; ++w) s += part[w][0], cnt += part[w][1];
  atomicAdd(&acc[0], (unsigned long long)s);
  atomicAdd(&acc[1], (unsigned long long)cnt);
  __threadfence();
  if (atomicAdd(&acc[2], 1ull) != (unsigned long long)gridDim.x * gridDim.y - 1) return;
  // the last CTA: every other CTA's sums are in; read them and leave zeros
  const long long S = (long long)atomicExch(&acc[0], 0ull);
  const long long N = (long long)atomicExch(&acc[1], 0ull);
  atomicExch(&acc[2], 0ull);
  sums[0] = S;
  sums[1] = N;
  *h2 = tf_decay(S, N, scale, strength, bd);
}

template <typename T>
int tf_noise_run(const T* y, unsigned long long* acc, long long* sums, float* h2, int H, int W,
                 int bd, float scale, float strength, void* stream) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // at least one CTA, so that a plane without interior samples still gets its h2
  const dim3 grid((max(W - 2, 1) + NZ_THREADS - 1) / NZ_THREADS,
                  (max(H - 2, 1) + NZ_BAND - 1) / NZ_BAND);
  tf_noise_kernel<T><<<grid, NZ_THREADS, 0, (cudaStream_t)stream>>>(y, acc, sums, h2, H, W, bd,
                                                                    scale, strength);
  return launch_status();
}

}  // namespace

// Y, U, V centre planes; ptrs (host): K luma then K U+V prediction pointers;
// out: Y, U, V int32 planes back to back; h2: the decay on the card; table:
// cap floats (a multiple of 1024); scratch: 3 int32, zero before the first
// launch (each launch leaves them zeroed)
extern "C" int tf_filter_launch(const uint8_t* cy, const uint8_t* cu, const uint8_t* cv,
                                const long long* ptrs, int* out, const float* h2, float* table,
                                int* scratch, int K, int R, int C, int bd, int cap, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes
  return tf_filter_run(cy, cu, cv, ptrs, out, h2, table, scratch, K, R, C, bd, cap, stream);
}

extern "C" int tf_filter16_launch(const int16_t* cy, const int16_t* cu, const int16_t* cv,
                                  const long long* ptrs, int* out, const float* h2, float* table,
                                  int* scratch, int K, int R, int C, int bd, int cap,
                                  void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;  // int16 planes: the 10-bit constants
  return tf_filter_run(cy, cu, cv, ptrs, out, h2, table, scratch, K, R, C, bd, cap, stream);
}

// acc: 3 uint64, zero before the first launch (each launch leaves them
// zeroed); sums: the |Laplacian| sum over the flat samples and their count;
// h2: the decay at this strength (float32)
extern "C" int tf_noise_launch(const uint8_t* y, unsigned long long* acc, long long* sums,
                               float* h2, int H, int W, int bd, float scale, float strength,
                               void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;
  return tf_noise_run(y, acc, sums, h2, H, W, bd, scale, strength, stream);
}

extern "C" int tf_noise16_launch(const int16_t* y, unsigned long long* acc, long long* sums,
                                 float* h2, int H, int W, int bd, float scale, float strength,
                                 void* stream) {
  if (bd != 10) return (int)cudaErrorInvalidValue;
  return tf_noise_run(y, acc, sums, h2, H, W, bd, scale, strength, stream);
}
