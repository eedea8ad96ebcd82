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
// per sample; a 2-D block runs four 1-D networks of up to 11 stages, against
// 3 int32 reads and 2-3 writes per sample. Design: the stage networks are
// compiled (txfm_nets.cuh, generated with every index and weight a literal),
// so a line of n samples lives in one thread's registers. A block's n lines
// go to n consecutive threads, several blocks per CTA: the forward column
// pass, a transpose through shared memory (row stride n + 1), then the
// forward row pass, quantizer, levels, dequantizer and inverse row pass in
// the same thread, a second transpose, the inverse column pass, the add, the
// clip and the SSE (a warp shuffle over the block's threads). Below 64
// points a block lies in one warp and the transposes need only __syncwarp;
// at 64 points the CTA syncs, the forward passes produce only the 32x32
// coded corner and the inverse row pass skips the zero rows (both exact).
// The sources of the CTA's lanes (`rep` lanes per source) are staged once in
// shared memory with 16-byte loads; levels and coefficients move as 16-byte
// rows. Arithmetic is int32 that wraps, like the reference. b0/b1/b2 are the
// forward shifts as round_shift_array bits (> 0 rounds right, < 0 shifts
// left). K16 (commit.cu) runs the same networks, one block per warp, and
// K15 (below) the same lines with its cost epilogues.
#include "txfm_nets.cuh"

#include <algorithm>

namespace {

__host__ __device__ constexpr int txq_threads(int n) { return n == 64 ? 128 : 256; }

template <int N>
__device__ __forceinline__ void group_sync() {
  if constexpr (N <= 32) __syncwarp(); else __syncthreads();
}

__device__ __forceinline__ void store4(int* p, const int (&v)[4], bool vec) {
  if (vec) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] = v[u];
  }
}

__device__ __forceinline__ void load4(const int* p, int (&v)[4], bool vec) {
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(p + u);
  }
}

// The sum of v over a lane's N threads (a warp shuffle; at 64 points the
// CTA's two warps of a lane meet in part[]).
template <int N>
__device__ __forceinline__ unsigned long long lane_sum(unsigned long long v,
                                                       unsigned long long* part) {
#pragma unroll
  for (int o = (N < 32 ? N : 32) / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (N == 64) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = part[(threadIdx.x >> 5) & ~1] + part[(threadIdx.x >> 5) | 1];
  }
  return v;
}

// The arguments of one launch of K2 or K15, as the launcher gathers them.
// K2: src|NULL, pred, v_adst, h_adst, levels, coeff|NULL, recon|NULL,
// sse|NULL. K15: src, pred, satd (stage 1) or err (stage 0), recon|NULL;
// DCT_DCT. nsrc: the source slots in shared memory (0 without src). `vec`:
// src, levels and coeff are 16-byte aligned. The kernels take them as
// separate __restrict__ parameters: passed as one struct, K2 took 4-7% more
// time at the decide's 8x8 to 32x32 shapes (H100, 45 registers at 8 points
// against 40).
struct Lines {
  const int* src;
  const int* pred;
  const uint8_t* v_adst;
  const uint8_t* h_adst;
  int* levels;
  int* coeff;
  int* recon;
  unsigned long long* sse;
  int* satd;
  unsigned long long* err;
  int stage, L, rep, nsrc;
  bool vec;
  int b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd;
};

// Lanes [blockIdx.x * lpc, + lpc) with N threads each (lpc = blockDim.x / N,
// at most txq_threads(N) / N); thread t of a lane holds column t in the
// column passes and row t in the row passes. TPL: K15's epilogues in place of
// the levels, coefficients and SSE.
template <int N, bool TPL>
__device__ __forceinline__ void txq_lines(
    const int* __restrict__ src, const int* __restrict__ pred,
    const uint8_t* __restrict__ v_adst, const uint8_t* __restrict__ h_adst,
    int* __restrict__ levels, int* __restrict__ coeff, int* __restrict__ recon,
    unsigned long long* __restrict__ sse, int* __restrict__ satd,
    unsigned long long* __restrict__ err, int stage, int L, int rep, int nsrc, bool vec, int b0,
    int b1, int b2, int sh_row, int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  constexpr int TPB = txq_threads(N), NN = N * N;
  constexpr int ADJ = N < 32 ? N : 32;  // coded rows and columns
  constexpr int TS = N + 1;             // transpose row stride
  constexpr bool KEEP_PRED = N <= 16;   // the prediction column stays in registers
  using Nets = txnets::TxNets<N>;
  extern __shared__ __align__(16) int txq_smem[];
  __shared__ unsigned long long s_part[TPB / 32];
  const int t = threadIdx.x % N;
  const int lpc = blockDim.x / N;
  const int l0 = blockIdx.x * lpc;
  const int lane_raw = l0 + threadIdx.x / N;
  const bool valid = lane_raw < L;
  const int lane = valid ? lane_raw : L - 1;  // the tail's idle lines redo the last lane
  const int s0 = l0 / rep;
  int* tile = txq_smem + nsrc * NN + (threadIdx.x / N) * ADJ * TS;
  const int* __restrict__ P = pred + (size_t)lane * NN;
  const int* S = txq_smem + (lane / rep - s0) * NN;
  const bool va = !TPL && v_adst[lane] != 0, ha = !TPL && h_adst[lane] != 0;
  const int dqmax = (1 << (bd + 7)) - 1;

  if (nsrc) {  // the CTA's sources, once
    const int cnt = ((min(l0 + lpc, L) - 1) / rep - s0 + 1) * NN;
    const int* g = src + (size_t)s0 * NN;
    if (vec) {
      for (int i = threadIdx.x; i < cnt / 4; i += blockDim.x)
        reinterpret_cast<int4*>(txq_smem)[i] = __ldg(reinterpret_cast<const int4*>(g) + i);
    } else {
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) txq_smem[i] = __ldg(g + i);
    }
    __syncthreads();
  }

  int p[KEEP_PRED ? N : 1];
  int y[N];  // this thread's row
  int* lrow = TPL ? nullptr : levels + (size_t)lane * ADJ * ADJ + t * ADJ;
  if (stage != 2) {
    int x[N];  // this thread's column
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int pv = __ldg(P + r * N + t);
      if constexpr (KEEP_PRED) p[r] = pv;
      x[r] = apply_shift(S[r * N + t] - pv, b0);
    }
    Nets::fwd_col(x, va);
#pragma unroll
    for (int k = 0; k < ADJ; ++k) tile[k * TS + t] = apply_shift(x[k], b1);
    group_sync<N>();
    // K15: stage 1 sums |co|, stage 0 ((co - dqc) >> 2)^2, exactly (int64)
    unsigned long long cost = 0;
    if (N < 64 || t < 32) {
#pragma unroll
      for (int c = 0; c < N; ++c) y[c] = tile[t * TS + c];
      Nets::fwd_row(y, ha);
      int* crow = !TPL && coeff ? coeff + (size_t)lane * ADJ * ADJ + t * ADJ : nullptr;
#pragma unroll
      for (int j0 = 0; j0 < ADJ; j0 += 4) {
        int lq[4], cq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          const int dq = (t == 0 && j == 0) ? dq_dc : dq_ac;
          cq[u] = apply_shift(y[j], b2);
          if (TPL && stage == 1) {
            cost += (unsigned)abs(cq[u]);
            continue;
          }
          lq[u] = quant_level(cq[u], dq, ls);
          y[j] = dequant_level(lq[u], dq, ls, dqmax);
          if constexpr (TPL) {
            const long long e = (cq[u] - y[j]) >> 2;
            cost += (unsigned long long)(e * e);
          }
        }
        if (!TPL && valid) {
          store4(lrow + j0, lq, vec);
          if (crow) store4(crow + j0, cq, vec);
        }
      }
    }
    if constexpr (TPL) {
      cost = lane_sum<N>(cost, s_part);
      if (t == 0 && valid) {
        if (stage == 1)
          satd[lane] = (int)(unsigned)cost >> 2;
        else
          err[lane] = cost;
      }
    }
    if (stage == 1 || (!recon && !sse)) return;
  } else if (N < 64 || t < 32) {
    if constexpr (KEEP_PRED) {
#pragma unroll
      for (int r = 0; r < N; ++r) p[r] = __ldg(P + r * N + t);
    }
#pragma unroll
    for (int j0 = 0; j0 < ADJ; j0 += 4) {
      int lq[4];
      load4(lrow + j0, lq, vec);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[j0 + u] =
            dequant_level(lq[u], (t == 0 && j0 + u == 0) ? dq_dc : dq_ac, ls, dqmax);
    }
  }
  // inverse rows (64 points: rows >= 32 and columns >= 32 are zero)
  if (N < 64 || t < 32) {
#pragma unroll
    for (int j = ADJ; j < N; ++j) y[j] = 0;
    const int rb = bd == 8 ? 16 : 18;
    Nets::inv(y, ha, -(1 << (rb - 1)), (1 << (rb - 1)) - 1);
    const int cb = bd + 6 > 16 ? bd + 6 : 16;
#pragma unroll
    for (int j = 0; j < N; ++j)
      tile[t * TS + j] =
          clampi(round_shift(y[j], sh_row), -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
  }
  group_sync<N>();
  // inverse columns, the add, the clip, the SSE
  int z[N];
#pragma unroll
  for (int k = 0; k < N; ++k) z[k] = k < ADJ ? tile[k * TS + t] : 0;
  Nets::inv(z, va, -32768, 32767);
  const int pmax = (1 << bd) - 1;
  unsigned acc = 0;  // at most 64 * 1023^2
#pragma unroll
  for (int r = 0; r < N; ++r) {
    int pv;
    if constexpr (KEEP_PRED) pv = p[r]; else pv = __ldg(P + r * N + t);
    const int rec = clampi(pv + round_shift(z[r], sh_col), 0, pmax);
    if (recon && valid) recon[(size_t)lane * NN + r * N + t] = rec;
    if (!TPL && sse) {
      const int d = rec - S[r * N + t];
      acc += (unsigned)(d * d);
    }
  }
  if (TPL || !sse) return;
  const unsigned long long tot = lane_sum<N>(acc, s_part);
  if (t == 0 && valid) sse[lane] = tot;
}

template <int N>
__global__ void __launch_bounds__(N == 64 ? 128 : 256) txq_lines_kernel(
    const int* __restrict__ src, const int* __restrict__ pred,
    const uint8_t* __restrict__ v_adst, const uint8_t* __restrict__ h_adst,
    int* __restrict__ levels, int* __restrict__ coeff, int* __restrict__ recon,
    unsigned long long* __restrict__ sse, int* __restrict__ satd,
    unsigned long long* __restrict__ err, int stage, int L, int rep, int nsrc, bool vec, int b0,
    int b1, int b2, int sh_row, int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  txq_lines<N, false>(src, pred, v_adst, h_adst, levels, coeff, recon, sse, satd, err, stage, L,
                      rep, nsrc, vec, b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd);
}

// K15 tpl_cost: the TPL dispenser's two transform-domain costs of square
// DCT_DCT blocks on K2's lines (the same networks, staging and quantizer):
//   mode 0 (stage 1): satd = sum |fwd_txfm2d(src - pred)| >> 2 (int32 that
//           wraps, as the reference's sum);
//   mode 1 (stage 0): the quantization error err = sum ((co - dqc) >> 2)^2
//           (exact, int64) of the coefficients co and their dequantized
//           levels dqc (levels clipped to +-32767), and optionally the recon
//           inv_txfm2d_add(dqc, pred), clipped to the bit depth.
// Replaces the cost expressions of svtav1_tpu/pipeline/tpl.py:82-83, :101-102
// (mode 0) and :115-123 (mode 1, `recon_err`) inside _tpl_frame_jit.run.
//
// Bound: integer operations (the two or four 1-D DCT passes per block
// against 2 int32 reads and one output per sample). Design: K2's, each
// thread's partial sum reduced by a warp shuffle over its lane's threads, so
// the coefficients never reach device memory; its own entry so that a
// profile tells it from K2.
template <int N>
__global__ void __launch_bounds__(256) tpl_cost_kernel(
    const int* __restrict__ src, const int* __restrict__ pred,
    const uint8_t* __restrict__ v_adst, const uint8_t* __restrict__ h_adst,
    int* __restrict__ levels, int* __restrict__ coeff, int* __restrict__ recon,
    unsigned long long* __restrict__ sse, int* __restrict__ satd,
    unsigned long long* __restrict__ err, int stage, int L, int rep, int nsrc, bool vec, int b0,
    int b1, int b2, int sh_row, int sh_col, int dq_dc, int dq_ac, int ls, int bd) {
  txq_lines<N, true>(src, pred, v_adst, h_adst, levels, coeff, recon, sse, satd, err, stage, L,
                     rep, nsrc, vec, b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd);
}

// One launch of L lanes of N points: lanes per CTA (fewer for a small launch,
// two CTAs per SM where L allows; whole warps always), the source slots and
// the alignment; the dynamic shared-memory limit raised once per kernel.
template <int N, bool TPL>
int launch_lines(Lines a, cudaStream_t stream) {
  constexpr int ADJ = N < 32 ? N : 32;
  auto kernel = txq_lines_kernel<N>;
  if constexpr (TPL) kernel = tpl_cost_kernel<N>;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 100 * 1024);
  }
  const int L = a.L;
  int lpc = txq_threads(N) / N;
  while (lpc > std::max(1, 32 / N) && (L + lpc - 1) / lpc < 2 * sms) lpc /= 2;
  if (a.stage == 2) a.src = nullptr;
  a.nsrc = a.src ? std::min(lpc, (lpc - 1) / a.rep + 2) : 0;
  const auto al = [](const void* q) { return q == nullptr || ((uintptr_t)q & 15) == 0; };
  a.vec = al(a.src) && al(a.levels) && al(a.coeff);
  const size_t shm = ((size_t)a.nsrc * N * N + (size_t)lpc * ADJ * (N + 1)) * sizeof(int);
  kernel<<<(L + lpc - 1) / lpc, lpc * N, shm, stream>>>(
      a.src, a.pred, a.v_adst, a.h_adst, a.levels, a.coeff, a.recon, a.sse, a.satd, a.err,
      a.stage, L, a.rep, a.nsrc, a.vec, a.b0, a.b1, a.b2, a.sh_row, a.sh_col, a.dq_dc, a.dq_ac,
      a.ls, a.bd);
  return launch_status();
}

}  // namespace

extern "C" int tpl_cost_launch(const int* src, const int* pred, int* satd,
                               unsigned long long* err, int* recon, int mode, int L, int rep,
                               int n, int b0, int b1, int b2, int sh_row, int sh_col, int dq_dc,
                               int dq_ac, int ls, int bd, void* stream) {
  if (L == 0) return 0;
  const Lines a{src, pred, nullptr, nullptr, nullptr, nullptr, mode == 0 ? nullptr : recon,
                nullptr, satd, err, mode == 0 ? 1 : 0, L, rep, 0, false, b0, b1, b2, sh_row,
                sh_col, dq_dc, dq_ac, ls, bd};
  const auto s = (cudaStream_t)stream;
  switch (n) {
    case 4: return launch_lines<4, true>(a, s);
    case 8: return launch_lines<8, true>(a, s);
    case 16: return launch_lines<16, true>(a, s);
    case 32: return launch_lines<32, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int txfm_quant_recon_launch(const int* src, const int* pred, const uint8_t* v_adst,
                                       const uint8_t* h_adst, int* levels, int* coeff,
                                       int* recon, unsigned long long* sse, int stage, int L,
                                       int rep, int n, int b0, int b1, int b2, int sh_row,
                                       int sh_col, int dq_dc, int dq_ac, int ls, int bd,
                                       void* stream) {
  if (L == 0) return 0;
  const Lines a{src, pred, v_adst, h_adst, levels, coeff, recon, sse, nullptr, nullptr, stage,
                L, rep, 0, false, b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd};
  const auto s = (cudaStream_t)stream;
  switch (n) {
    case 4: return launch_lines<4, false>(a, s);
    case 8: return launch_lines<8, false>(a, s);
    case 16: return launch_lines<16, false>(a, s);
    case 32: return launch_lines<32, false>(a, s);
    case 64: return launch_lines<64, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
