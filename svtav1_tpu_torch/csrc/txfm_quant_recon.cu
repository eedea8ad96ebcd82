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
// The stage networks and the block body (txq_block) are in txfm.cuh, which
// K16 (commit.cu) runs for the commit's intra blocks.
#include "txfm.cuh"

namespace {

__global__ void txfm_quant_recon_kernel(const int* __restrict__ src, const int* __restrict__ pred,
                                        const uint8_t* __restrict__ v_adst,
                                        const uint8_t* __restrict__ h_adst,
                                        const int* __restrict__ tb, int* __restrict__ levels,
                                        int* __restrict__ coeff, int* __restrict__ recon,
                                        unsigned long long* __restrict__ sse, int stage, int rep,
                                        int n, int log2n, int b0, int b1, int b2, int sh_row,
                                        int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  extern __shared__ int smem[];
  const int nn = n * n;
  const int lane = blockIdx.x;
  const size_t at = (size_t)lane * (n < 32 ? n : 32) * (n < 32 ? n : 32);
  txq_block(src ? src + (size_t)(lane / rep) * nn : nullptr, n, pred + (size_t)lane * nn,
            v_adst[lane] != 0, h_adst[lane] != 0, tb, levels + at, coeff ? coeff + at : nullptr,
            recon ? recon + (size_t)lane * nn : nullptr, sse ? sse + lane : nullptr, stage, n,
            log2n, b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd, smem, smem + nn);
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
