// K2 txfm_quant_recon: residual -> forward 2-D DCT/ADST -> dead-zone quant
// (clipped to +-32767) -> dequant -> inverse 2-D transform -> + prediction,
// clipped to the bit depth; optionally the integer SSE of the recon against
// the source. Square blocks n in {4, 8, 16, 32, 64}; per-lane vertical and
// horizontal DCT/ADST choice (ADST only up to 16 points, ADST4 by sinpi).
// Three entries (`stage`): 0 the whole chain; 1 the forward half, giving the
// levels and, optionally, the unquantized coefficients of the coded (at most
// 32x32) region; 2 the inverse half from levels (dequant, inverse, add,
// clip). RDOQ (K5, csrc/rdoq.cu) runs between 1 and 2 in the commit.
//
// Replaces svtav1_tpu/ops/transforms_jax.py::fwd_txfm2d_j, fwd_txfm2d_sel_j,
// quantize_j, dequantize_j, inv_txfm2d_add_j and inv_txfm2d_add_sel_j as the
// decide (device_decide.py:128-147, :242-244, :270-276) and the commit's
// select_txfm (device_commit.py:308-336) chain them.
//
// Bound: integer operations. Each 1-D stage is two multiply-adds and a shift
// per sample; a 2-D block runs four 1-D networks of up to 12 stages, against
// 3 int32 reads and 2-3 writes per sample. Design: one block per transform
// block; the block lives in shared memory (two n*n int32 buffers, at most
// 32 KB) for all four passes, so nothing but the inputs and the final levels,
// recon and SSE touch device memory. The stage tables (one packed int32
// buffer per size, uploaded once) are read through the read-only cache.
// Arithmetic is int32 that wraps, like the reference. b0/b1/b2 are the
// forward shifts as round_shift_array bits (> 0 rounds right, < 0 shifts left).
#include "common.cuh"

namespace {

// The packed stage-table buffer starts with a 32-int header. Tables: 0 fwd col DCT, 1 fwd col ADST, 2 fwd row DCT,
// 3 fwd row ADST, 4 inv DCT, 5 inv ADST; [6..11] stage counts;
// [12..16] sinpi(col cos bit), [17..21] sinpi(row), [22..26] sinpi(inverse);
// [27] col cos bit, [28] row cos bit.

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int apply_shift(int x, int bit) {
  if (bit > 0) return round_shift(x, bit);
  if (bit < 0) return (int)((unsigned)x << (-bit));
  return x;
}

__device__ __forceinline__ int get_elem(const int* X, bool col, int v, int e, int log2n) {
  return col ? X[(e << log2n) + v] : X[(v << log2n) + e];
}

__device__ int adst4(const int* X, bool col, int v, int k, int log2n, const int* sp,
                     int cos_bit, bool inverse) {
  const unsigned x0 = get_elem(X, col, v, 0, log2n), x1 = get_elem(X, col, v, 1, log2n);
  const unsigned x2 = get_elem(X, col, v, 2, log2n), x3 = get_elem(X, col, v, 3, log2n);
  const unsigned s1p = sp[1], s2p = sp[2], s3p = sp[3], s4p = sp[4];
  unsigned o;
  if (inverse) {
    const unsigned s0 = s1p * x0 + s4p * x2 + s2p * x3;
    const unsigned s1 = s2p * x0 - s1p * x2 - s4p * x3;
    const unsigned s2 = s3p * ((x0 - x2) + x3);
    const unsigned s3 = s3p * x1;
    o = k == 0 ? s0 + s3 : k == 1 ? s1 + s3 : k == 2 ? s2 : s0 + s1 - s3;
  } else {
    const unsigned a0 = s1p * x0 + s2p * x1 + s4p * x3;
    const unsigned a1 = s3p * (x0 + x1 - x3);
    const unsigned a2 = s4p * x0 - s1p * x1 + s2p * x3;
    const unsigned a3 = s3p * x2;
    o = k == 0 ? a0 + a3 : k == 1 ? a1 : k == 2 ? a2 - a3 : a2 - a0 + a3;
  }
  return round_shift((int)o, cos_bit);
}

// One 1-D pass over every row (col=false) or column (col=true) of the n x n
// block in X; the result ends in X (buffers swap). `tab` < 0 selects ADST4.
__device__ void pass1d(int*& X, int*& Y, const int* __restrict__ tb, int tab, int n, int log2n,
                       bool col, int clamp_bits, const int* sp, int cos_bit, bool inverse) {
  const int nn = n * n;
  if (tab < 0) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int v = col ? (idx & (n - 1)) : (idx >> log2n);
      const int k = col ? (idx >> log2n) : (idx & (n - 1));
      Y[idx] = adst4(X, col, v, k, log2n, sp, cos_bit, inverse);
    }
    __syncthreads();
    int* t = X; X = Y; Y = t;
    return;
  }
  const int off = tb[tab], nst = tb[6 + tab];
  const int lo = clamp_bits ? -(1 << (clamp_bits - 1)) : 0;
  const int hi = clamp_bits ? (1 << (clamp_bits - 1)) - 1 : 0;
  for (int s = 0; s < nst; ++s) {
    const int* st = tb + off + s * n * 6;
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int v = col ? (idx & (n - 1)) : (idx >> log2n);
      const int k = col ? (idx >> log2n) : (idx & (n - 1));
      const int* e = st + k * 6;
      const int sh = __ldg(e + 4);
      const int a = get_elem(X, col, v, __ldg(e), log2n);
      const int b = get_elem(X, col, v, __ldg(e + 2), log2n);
      int y = wrap_mad2(a, __ldg(e + 1), b, __ldg(e + 3), sh > 0 ? 1 << (sh - 1) : 0) >> sh;
      if (clamp_bits && __ldg(e + 5)) y = clampi(y, lo, hi);
      Y[idx] = y;
    }
    __syncthreads();
    int* t = X; X = Y; Y = t;
  }
}

__global__ void txfm_quant_recon_kernel(const int* __restrict__ src, const int* __restrict__ pred,
                                        const uint8_t* __restrict__ v_adst,
                                        const uint8_t* __restrict__ h_adst,
                                        const int* __restrict__ tb, int* __restrict__ levels,
                                        int* __restrict__ coeff, int* __restrict__ recon,
                                        unsigned long long* __restrict__ sse, int stage, int rep,
                                        int n,
                                        int log2n, int b0, int b1, int b2, int sh_row,
                                        int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  extern __shared__ int smem[];
  __shared__ unsigned long long s_sse;
  const int nn = n * n;
  int* X = smem;
  int* Y = smem + nn;
  const int lane = blockIdx.x;
  const int* S = src + (size_t)(lane / rep) * nn;
  const int* P = pred + (size_t)lane * nn;
  // per-lane 1-D kinds: ADST4 (table -1) at 4 points, no ADST above 16
  const bool va = v_adst[lane] && n <= 16, ha = h_adst[lane] && n <= 16;
  const int fcol = va ? (n == 4 ? -1 : 1) : 0;
  const int frow = ha ? (n == 4 ? -1 : 3) : 2;
  const int icol = va ? (n == 4 ? -1 : 5) : 4;
  const int irow = ha ? (n == 4 ? -1 : 5) : 4;
  const int adj = n < 32 ? n : 32;
  if (threadIdx.x == 0) s_sse = 0ull;

  const int dqmax = (1 << (bd + 7)) - 1;
  if (stage != 2) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
      X[idx] = apply_shift(S[idx] - P[idx], b0);
    __syncthreads();
    pass1d(X, Y, tb, fcol, n, log2n, true, 0, tb + 12, tb[27], false);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) X[idx] = apply_shift(X[idx], b1);
    __syncthreads();
    pass1d(X, Y, tb, frow, n, log2n, false, 0, tb + 17, tb[28], false);
  }
  // quant (+ 64-point zero-out), levels out, dequant in place; stage 2 reads
  // the levels instead
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int r = idx >> log2n, c = idx & (n - 1);
    const bool coded = r < adj && c < adj;
    const size_t at = (size_t)lane * adj * adj + r * adj + c;
    const int dq = idx == 0 ? dq_dc : dq_ac;
    int lv;
    if (stage == 2) {
      lv = coded ? levels[at] : 0;
    } else {
      int x = apply_shift(X[idx], b2);
      if (n == 64 && (r >= 32 || c >= 32)) x = 0;
      const int absc = (int)((unsigned)abs(x) << ls);
      lv = floordiv((int)((unsigned)absc + (unsigned)(dq >> 1)), dq);
      lv = x > 0 ? lv : (x < 0 ? -lv : 0);
      lv = clampi(lv, -32767, 32767);
      if (coded) {
        levels[at] = lv;
        if (coeff) coeff[at] = x;
      }
    }
    int d = min((abs(lv) * dq) >> ls, dqmax);
    d = lv > 0 ? d : (lv < 0 ? -d : 0);
    X[idx] = clampi(d, -(1 << (bd + 7)), (1 << (bd + 7)) - 1);
  }
  if (stage == 1) return;
  __syncthreads();
  pass1d(X, Y, tb, irow, n, log2n, false, bd == 8 ? 16 : 18, tb + 22, 12, true);
  const int cb = bd + 6 > 16 ? bd + 6 : 16;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    X[idx] = clampi(round_shift(X[idx], sh_row), -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
  __syncthreads();
  pass1d(X, Y, tb, icol, n, log2n, true, 16, tb + 22, 12, true);
  const int pmax = (1 << bd) - 1;
  unsigned long long acc = 0;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int rec = clampi(P[idx] + round_shift(X[idx], sh_col), 0, pmax);
    if (recon) recon[(size_t)lane * nn + idx] = rec;
    if (sse) {
      const long long d = rec - S[idx];
      acc += (unsigned long long)(d * d);
    }
  }
  if (sse) {
    atomicAdd(&s_sse, acc);
    __syncthreads();
    if (threadIdx.x == 0) sse[lane] = s_sse;
  }
}

// K15 tpl_cost: the TPL dispenser's two transform-domain costs of square
// DCT_DCT blocks, on K2's forward and inverse networks and quantizer:
//   mode 0: satd = sum |fwd_txfm2d(src - pred)| >> 2 (int32);
//   mode 1: the quantization error err = sum ((co - dqc) >> 2)^2 (exact,
//           int64) of the coefficients co and their dequantized levels dqc
//           (levels clipped to +-32767), and optionally the recon
//           inv_txfm2d_add(dqc, pred), clipped to the bit depth.
// Replaces the cost expressions of svtav1_tpu/pipeline/tpl.py:82-83, :101-102
// (mode 0) and :115-123 (mode 1, `recon_err`) inside _tpl_frame_jit.run.
//
// Bound: integer operations (the two or four 1-D passes of K2 per block
// against 2 int32 reads and one output per sample). Design: K2's, one block
// per lane with the block in shared memory; the reductions are a warp
// shuffle and one shared atomic per warp, so the coefficients never reach
// device memory.
__global__ void tpl_cost_kernel(const int* __restrict__ src, const int* __restrict__ pred,
                                const int* __restrict__ tb, int* __restrict__ satd,
                                unsigned long long* __restrict__ err, int* __restrict__ recon,
                                int mode, int rep, int n, int log2n, int b0, int b1, int b2,
                                int sh_row, int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  extern __shared__ int smem[];
  __shared__ unsigned long long s_acc;
  const int nn = n * n;
  int* X = smem;
  int* Y = smem + nn;
  const int lane = blockIdx.x;
  const int* S = src + (size_t)(lane / rep) * nn;
  const int* P = pred + (size_t)lane * nn;
  if (threadIdx.x == 0) s_acc = 0ull;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    X[idx] = apply_shift(S[idx] - P[idx], b0);
  __syncthreads();
  pass1d(X, Y, tb, 0, n, log2n, true, 0, tb + 12, tb[27], false);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) X[idx] = apply_shift(X[idx], b1);
  __syncthreads();
  pass1d(X, Y, tb, 2, n, log2n, false, 0, tb + 17, tb[28], false);
  unsigned long long acc = 0;
  const int dqmax = (1 << (bd + 7)) - 1;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int co = apply_shift(X[idx], b2);
    if (mode == 0) {
      acc += (unsigned)abs(co);
      continue;
    }
    const int dq = idx == 0 ? dq_dc : dq_ac;
    const int absc = (int)((unsigned)abs(co) << ls);
    int lv = floordiv((int)((unsigned)absc + (unsigned)(dq >> 1)), dq);
    lv = clampi(co > 0 ? lv : (co < 0 ? -lv : 0), -32767, 32767);
    int d = min((abs(lv) * dq) >> ls, dqmax);
    d = lv > 0 ? d : (lv < 0 ? -d : 0);
    const long long e = (co - d) >> 2;
    acc += (unsigned long long)(e * e);
    X[idx] = clampi(d, -(1 << (bd + 7)), (1 << (bd + 7)) - 1);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_acc, acc);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (mode == 0)
      satd[lane] = (int)(unsigned)s_acc >> 2;
    else
      err[lane] = s_acc;
  }
  if (mode == 0 || !recon) return;
  pass1d(X, Y, tb, 4, n, log2n, false, bd == 8 ? 16 : 18, tb + 22, 12, true);
  const int cb = bd + 6 > 16 ? bd + 6 : 16;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    X[idx] = clampi(round_shift(X[idx], sh_row), -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
  __syncthreads();
  pass1d(X, Y, tb, 4, n, log2n, true, 16, tb + 22, 12, true);
  const int pmax = (1 << bd) - 1;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    recon[(size_t)lane * nn + idx] = clampi(P[idx] + round_shift(X[idx], sh_col), 0, pmax);
}

}  // namespace

extern "C" int tpl_cost_launch(const int* src, const int* pred, const int* tables, int* satd,
                               unsigned long long* err, int* recon, int mode, int L, int rep,
                               int n, int b0, int b1, int b2, int sh_row, int sh_col, int dq_dc,
                               int dq_ac, int ls, int bd, int log2n, void* stream) {
  if (L == 0) return 0;
  const int nn = n * n;
  const int threads = nn >= 256 ? 256 : (nn < 32 ? 32 : nn);
  const size_t shm = 2 * (size_t)nn * sizeof(int);
  tpl_cost_kernel<<<L, threads, shm, (cudaStream_t)stream>>>(
      src, pred, tables, satd, err, recon, mode, rep, n, log2n, b0, b1, b2, sh_row, sh_col,
      dq_dc, dq_ac, ls, bd);
  return launch_status();
}

extern "C" int txfm_quant_recon_launch(const int* src, const int* pred, const uint8_t* v_adst,
                                       const uint8_t* h_adst, const int* tables, int* levels,
                                       int* coeff, int* recon, unsigned long long* sse,
                                       int stage, int L, int rep, int n, int b0, int b1,
                                       int b2, int sh_row, int sh_col, int dq_dc, int dq_ac,
                                       int ls, int bd, int log2n, void* stream) {
  if (L == 0) return 0;
  const int nn = n * n;
  const int threads = nn >= 256 ? 256 : (nn < 32 ? 32 : nn);
  const size_t shm = 2 * (size_t)nn * sizeof(int);
  txfm_quant_recon_kernel<<<L, threads, shm, (cudaStream_t)stream>>>(
      src, pred, v_adst, h_adst, tables, levels, coeff, recon, sse, stage, rep, n, log2n, b0,
      b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd);
  return launch_status();
}
