// K16 commit_wave: commit phase B, the intra wavefront, as one persistent
// kernel of warp workers over a dependency graph. Every task is one block
// of one plane (a size, a lane of that size's schedule and a plane). The
// host orders the tasks by wave and maps, per plane and 8x8 luma cell, the
// task that writes the cell's frontier samples (pipeline/wavefront.py
// wave_tasks' owner map; a cell of an inter lane, coded in phase A, has
// none). A task's predecessors are the owners of the cells it reads: the
// above row, the left column and the top-left corner. Each warp
// takes the next task of the table from one atomic counter, stages what
// does not depend on other tasks (the source block, the smooth weights, the
// directional table, K5's tables) in its shared memory, waits until its
// predecessors have published, and then, alone:
//   1. gathers the above row, left column and top-left sample from the
//      frontier maps, with the commit's fills for missing neighbours;
//   2. predicts the chosen mode sample by sample (K1's intra_pred_sample)
//      into the warp's shared memory;
//   3. runs K2's compiled networks (txfm_nets.cuh): a column per lane in
//      registers, a transpose through the warp's shared memory, a row per
//      lane, the quantizer;
//   4. RDOQ with the size's tables (K5's rdoq_tile, one warp), when on;
//   5. dequantizes, runs the inverse networks and reconstructs;
//   6. writes the frontier cells (each cell has one writer), publishes its
//      ready flag, and then writes the levels and the recon, which no other
//      task reads, to the lane's slots.
// K1, K2 and K5 compute the same functions with the same device code or
// networks (each held against the plain version), so K16 is bit-exact with
// the wave loop of those kernels (commit_wave_plain); chip_smoke.py holds
// the two equal on four 1080p schedules.
//
// Replaces the wave loop of svtav1_tpu/pipeline/device_commit.py
// (_commit_device's phase B, `lax.fori_loop` over the waves at :542-552,
// with the wave body `_wave_step`), which the port first ran as a Python
// loop launching K1, K2 and K5 per wave and size, then as one cooperative
// launch with a grid barrier between anti-diagonal waves.
//
// Bound: latency, the chain bound. The tasks form a DAG whose longest path
// (utils/profile_keyframes.commit_wave_work's chain_ms: each task on it at
// one SM's share of the int32 rate, each edge one measured flag handoff)
// is far above the bytes and operations bounds. A wave barrier made every
// task wait for the slowest of the wave before it, and a P frame's intra
// blocks, which mostly have only inter neighbours, ran one wave after
// another. On the chain itself a task's time is mostly dependent memory
// round trips (descriptors, then tables, then contexts), not arithmetic.
// Design: a task waits only on its own predecessors: a lane of its warp per
// cell read looks up the cell's owner and spins on its flag, then the warp reads the edges through
// L2 (ld.global.cg: another SM wrote them); the writer orders its stores
// with a fence and __syncwarp and publishes with st.release.gpu. Everything
// a task reads that no other task writes is staged in the warp's shared
// memory before it waits, so that after the wait only the edges come from
// memory, and the flag goes out before the bulk of the stores. A warp per
// task, whatever its size, with __syncwarp only:
// up to 32 points a lane holds one line of the block in registers, at 64
// points two (the forward passes keep only the 32x32 coded corner and the
// inverse row pass runs on its 32 non-zero rows, as K2 does). The
// prediction waits in the warp's shared memory as uint16 for the add, and
// the recon takes its place. RDOQ's suffix sum stays one sequential float64
// chain (rdoq_suffix_sums_warp: the gains in registers, a lane's segment at
// a time), the longest step of a 32x32 block's task. No
// tensor cores or TMA: rounding integer stage networks on blocks of at
// most 64x64.
//
// Deadlock-freedom rests on the one queue: tasks go out in table order,
// which is topological (every predecessor has a lower index), and a warp
// takes a task only while it runs. So the lowest unfinished task always has
// its predecessors done and its holder resident. The launch need not be
// cooperative: a CTA that is not resident yet holds no task. The grid is
// the co-resident CTAs (one warp each), at most the task count.
#include "intra_pred.cuh"
#include "rdoq.cuh"
#include "txfm_nets.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSizes = 4;  // luma 8, 16, 32, 64 (device_decide.SIZES)

// The tables of one (size, plane group); every field 8 bytes, in the order
// of wavefront.py's PLANE_FIELDS.
struct PlaneDesc {
  long long weights;             // K1 smooth weights of the plane's block size
  long long flut, ilut, scan;    // K5 tables of the plane's tx size
  long long n, log2n, ntypes;    // block size, log2, tx types searched (1: DCT only)
  long long qls, rls, log2w;     // K2's quant scale, K5's scale, log2 of the coded width
  long long b0, b1, b2, sh_row, sh_col;  // K2's forward and inverse shifts
  long long dscale_bits, skip_bits;      // K5's float32 scalars, as bits
};

// One size's lanes (wavefront.py SIZE_FIELDS).
struct SizeDesc {
  long long coords;          // (N, 3) int64 (f, r8, c8), region-local
  long long mode, tx, uv_tx; // (N,) int32
  long long lv[3], rec[3];   // levels (N, adj, adj) and recon (N, m, m) per plane
  PlaneDesc pd[2];           // luma, chroma
};

struct FrameDesc {
  long long src[3];                    // (F, H, W) int32 source planes
  long long bmap[3], rmap[3], cmap[3]; // frontier maps per plane
  long long dr;                        // K1 directional table
  SizeDesc size[kSizes];
};

// The warp's shared memory, sized by the table's largest luma block max_n
// (adj = min(max_n, 32), the coded width), in ints: the two edges; a work
// area (the transposes, adj rows of N + 1; RDOQ's magnitudes and gains);
// the levels, coefficients and RDOQ'd levels; the smooth weights and the
// directional table; K5's tables of the task's tx size (flut, ilut, scan);
// and the source block and the prediction as uint16 (samples of at most 12
// bits).
struct WarpSmem {
  int *A, *L, *work, *lv0, *co, *lv1, *wts, *dr, *ilut, *scan;
  float* flut;
  uint16_t *src, *pred;
};

__host__ __device__ inline int work_ints(int max_n) {
  const int adj = max_n < 32 ? max_n : 32;
  const int tile = adj * (max_n + 1), rdoq = 2 * adj * adj + 1;
  return tile > rdoq ? tile : rdoq;
}

__host__ __device__ inline int smem_ints(int max_n) {
  const int a2 = max_n < 32 ? max_n * max_n : 1024;
  return 2 * max_n + work_ints(max_n) + 3 * a2 + max_n + 18 + (F_EOB + a2 + 1) + 5 * a2 +
         max_n * max_n;
}

__device__ inline WarpSmem warp_smem(int* base, int max_n) {
  const int a2 = max_n < 32 ? max_n * max_n : 1024;
  WarpSmem m;
  m.A = base;
  m.L = m.A + max_n;
  m.work = m.L + max_n;
  m.lv0 = m.work + work_ints(max_n);
  m.co = m.lv0 + a2;
  m.lv1 = m.co + a2;
  m.wts = m.lv1 + a2;
  m.dr = m.wts + max_n;
  m.flut = (float*)(m.dr + 18);
  m.ilut = (int*)(m.flut + F_EOB + a2 + 1);
  m.scan = m.ilut + 4 * a2;
  m.src = (uint16_t*)(m.scan + a2);
  m.pred = m.src + max_n * max_n;
  return m;
}

// The prediction of one mode, a sample per lane at a time; the mode is a
// constant of each loop (a switch per sample costs more than the sample).
template <int N, int LOG2N, int M>
__device__ __forceinline__ void predict_mode(uint16_t* __restrict__ P, const int* A, const int* L,
                                             int tl, int dc, const int* wts) {
  for (int i = threadIdx.x; i < N * N; i += 32)
    P[i] = (uint16_t)intra_pred_sample(A, L, tl, dc, M, wts, nullptr, N, i >> LOG2N, i & (N - 1));
}

template <int N, int LOG2N>
__device__ __forceinline__ void predict(uint16_t* __restrict__ P, const int* A, const int* L,
                                        int tl, int dc, int mode, const int* wts, const int* dr) {
  switch (mode) {
    case 0: predict_mode<N, LOG2N, 0>(P, A, L, tl, dc, wts); return;
    case 1: predict_mode<N, LOG2N, 1>(P, A, L, tl, dc, wts); return;
    case 2: predict_mode<N, LOG2N, 2>(P, A, L, tl, dc, wts); return;
    case 3: predict_mode<N, LOG2N, 3>(P, A, L, tl, dc, wts); return;
    case 4: predict_mode<N, LOG2N, 4>(P, A, L, tl, dc, wts); return;
    case 5: predict_mode<N, LOG2N, 5>(P, A, L, tl, dc, wts); return;
    case 6: predict_mode<N, LOG2N, 6>(P, A, L, tl, dc, wts); return;
    default: {  // directional: the mode's (dx, dy, zone) in registers
      const int d[3] = {dr[3 * (mode - 7)], dr[3 * (mode - 7) + 1], dr[3 * (mode - 7) + 2]};
      for (int i = threadIdx.x; i < N * N; i += 32)
        P[i] = (uint16_t)intra_dr_sample(A, L, tl, N, d, i >> LOG2N, i & (N - 1));
    }
  }
}

// One task of size N (the plane's block size) with the calling warp, after
// the owners of the cells it reads (owner: (3, F, R8p, C8p), the grid padded
// to whole superblocks; -1 for a cell no task writes) have published their
// flags in done[]; publishes its own in *flag.
template <int N>
__device__ __forceinline__ void commit_task(const FrameDesc* __restrict__ fd, int si, int pl,
                                            int ln, int R8, int C8, int dq_dc, int dq_ac, int bd,
                                            bool rdoq, float lam, const WarpSmem& m,
                                            const int* __restrict__ owner, int F,
                                            const int* done, int* flag) {
  constexpr int ADJ = N < 32 ? N : 32;  // coded rows and columns
  constexpr int TS = N + 1;             // transpose row stride
  constexpr int LINES = N > 32 ? 2 : 1; // lines per lane in the column passes
  constexpr int LOG2N = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : N == 32 ? 5 : 6;
  using Nets = txnets::TxNets<N>;
  const int t = threadIdx.x;
  const SizeDesc& S = fd->size[si];
  const PlaneDesc& D = S.pd[pl > 0];
  const long long* cd = (const long long*)S.coords + 3 * (size_t)ln;
  const int f = (int)cd[0], r8 = (int)cd[1], c8 = (int)cd[2];
  const int cell = pl ? 4 : 8;
  const int n8 = (N * (pl ? 2 : 1)) >> 3;
  const int pw = pl ? (C8 * 8) >> 1 : C8 * 8, ph = pl ? (R8 * 8) >> 1 : R8 * 8;
  const int xx = c8 * cell, yy = r8 * cell;
  const bool ha = r8 > 0, hl = c8 > 0;
  const int rr = ha ? r8 - 1 : 0, cc = hl ? c8 - 1 : 0;
  int* bm = (int*)fd->bmap[pl];
  int* rm = (int*)fd->rmap[pl];
  int* cm = (int*)fd->cmap[pl];
  const int base = 1 << (bd - 1);
  const int mode = ((const int*)S.mode)[ln];
  const int tx = pl ? ((const int*)S.uv_tx)[ln] : ((const int*)S.tx)[ln];
  const bool va = D.ntypes > 1 && (tx == 1 || tx == 2);
  const bool hv = D.ntypes > 1 && (tx == 1 || tx == 3);
  const int b0 = (int)D.b0, b1 = (int)D.b1, b2 = (int)D.b2;
  const int shr = (int)D.sh_row, shc = (int)D.sh_col, qls = (int)D.qls;
  const int log2w = (int)D.log2w, rls = (int)D.rls;
  const float dscale = __int_as_float((int)D.dscale_bits), skip = __int_as_float((int)D.skip_bits);
  int* lv_out = (int*)S.lv[pl] + (size_t)ln * ADJ * ADJ;
  int* rec_out = (int*)S.rec[pl] + (size_t)ln * N * N;

  // 0. before the predecessors publish (off the dependency chain): the
  // source block, the smooth weights, the directional table and K5's tables
  // into the warp's shared memory
  {
    const int* src = (const int*)fd->src[pl] + ((size_t)f * ph + yy) * pw + xx;
    for (int i = t; i < N * N; i += 32)
      m.src[i] = (uint16_t)__ldg(src + (size_t)(i >> LOG2N) * pw + (i & (N - 1)));
    for (int i = t; i < N; i += 32) m.wts[i] = __ldg((const int*)D.weights + i);
    if (t < 18) m.dr[t] = __ldg((const int*)fd->dr + t);
    if (rdoq) {
      const float* flut = (const float*)D.flut;
      const int* ilut = (const int*)D.ilut;
      const int* scan = (const int*)D.scan;
      for (int i = t; i < F_EOB + ADJ * ADJ + 1; i += 32) m.flut[i] = __ldg(flut + i);
      for (int i = t; i < 4 * ADJ * ADJ; i += 32) m.ilut[i] = __ldg(ilut + i);
      for (int i = t; i < ADJ * ADJ; i += 32) m.scan[i] = __ldg(scan + i);
    }
  }
  // wait for the writers of the cells read, a lane per cell (n8 <= 8): lane
  // k <= n8 the row above at column c8 - 1 + k (the top-left cell at k = 0,
  // where there is a left column), lane n8 < k <= 2 n8 the column to the
  // left at row r8 + k - n8 - 1; an owner waited on twice is harmless
  {
    const int R8p = (R8 + 7) & ~7, C8p = (C8 + 7) & ~7;
    const int* own = owner + (size_t)(pl * F + f) * R8p * C8p;
    const int r = t <= n8 ? r8 - 1 : r8 + t - n8 - 1;
    const int c = t <= n8 ? c8 - 1 + t : c8 - 1;
    const int w = t <= 2 * n8 && r >= 0 && c >= 0 ? __ldg(own + r * C8p + c) : -1;
    if (w >= 0) wait_flag(done + w, 1);
  }
  __syncwarp();

  // 1. edges (device_commit edges_from's fills) and the DC
  int* A = m.A;
  int* Lf = m.L;
  const int* brow = bm + ((size_t)f * R8 + rr) * pw + xx;
  const int* rcol = rm + ((size_t)f * C8 + cc) * ph + yy;
  const int a0 = ha ? __ldcg(brow) : 0, l0 = hl ? __ldcg(rcol) : 0;
  int sa = 0, sl = 0;
  for (int i = t; i < N; i += 32) {
    const int av = ha ? __ldcg(brow + i) : (hl ? l0 : base - 1);
    const int lv = hl ? __ldcg(rcol + i) : (ha ? a0 : base + 1);
    A[i] = av;
    Lf[i] = lv;
    sa += av;
    sl += lv;
  }
  const int tl = ha && hl ? __ldcg(cm + ((size_t)f * R8 + rr) * C8 + cc)
                          : (ha ? a0 : (hl ? l0 : base));
  const int dc = intra_dc(__reduce_add_sync(kFull, sa), __reduce_add_sync(kFull, sl), ha, hl, N,
                          LOG2N, bd);
  __syncwarp();

  const int dqmax = (1 << (bd + 7)) - 1;
  int* tile = m.work;
  uint16_t* P = m.pred;
  int *lv0 = m.lv0, *co = m.co, *lv1 = m.lv1;

  // 2. prediction of the chosen mode (uv_mode = y mode)
  predict<N, LOG2N>(P, A, Lf, tl, dc, mode, m.wts, m.dr);
  __syncwarp();
  // 3. forward columns; the coded rows of each column out
  if (N > 32 || t < N) {
#pragma unroll 1
    for (int h = 0; h < LINES; ++h) {
      const int c = t + 32 * h;
      int x[N];
#pragma unroll
      for (int r = 0; r < N; ++r)
        x[r] = apply_shift(m.src[r * N + c] - P[r * N + c], b0);
      Nets::fwd_col(x, va);
#pragma unroll
      for (int k = 0; k < ADJ; ++k) tile[k * TS + c] = apply_shift(x[k], b1);
    }
  }
  __syncwarp();
  // forward rows, the quantizer: levels (and coefficients for RDOQ) of row t
  if (t < ADJ) {
    int y[N];
#pragma unroll
    for (int c = 0; c < N; ++c) y[c] = tile[t * TS + c];
    Nets::fwd_row(y, hv);
#pragma unroll
    for (int j = 0; j < ADJ; ++j) {
      const int cq = apply_shift(y[j], b2);
      lv0[t * ADJ + j] = quant_level(cq, (t == 0 && j == 0) ? dq_dc : dq_ac, qls);
      if (rdoq) co[t * ADJ + j] = cq;
    }
  }
  __syncwarp();
  // 4. RDOQ (its magnitudes and gains in the work area, the transpose done)
  const int* lv = lv0;
  if (rdoq) {
    rdoq_tile<1>(lv0, co, m.flut, m.ilut, m.scan, lv1, ADJ, ADJ, log2w, rls, dq_dc, dq_ac, lam,
                 dscale, skip, m.work, (float*)(m.work + ADJ * ADJ));
    lv = lv1;
  }
  // 5. dequantizer and inverse rows (64 points: rows and columns >= 32 are zero)
  if (t < ADJ) {
    int y[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      y[j] = j < ADJ ? dequant_level(lv[t * ADJ + j], (t == 0 && j == 0) ? dq_dc : dq_ac, qls,
                                     dqmax)
                     : 0;
    const int rb = bd == 8 ? 16 : 18;
    Nets::inv(y, hv, -(1 << (rb - 1)), (1 << (rb - 1)) - 1);
    const int cb = bd + 6 > 16 ? bd + 6 : 16;
#pragma unroll
    for (int j = 0; j < N; ++j)
      tile[t * TS + j] = clampi(round_shift(y[j], shr), -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
  }
  __syncwarp();
  // inverse columns, the add, the clip; 6. recon and frontier cells out
  const int pmax = (1 << bd) - 1;
  int* bw = bm + ((size_t)f * R8 + r8 + n8 - 1) * pw + xx;
  int* rw = rm + ((size_t)f * C8 + c8 + n8 - 1) * ph + yy;
  int* cw = cm + ((size_t)f * R8 + r8) * C8 + c8;
  if (N > 32 || t < N) {
#pragma unroll 1
    for (int h = 0; h < LINES; ++h) {
      const int c = t + 32 * h;
      int z[N];
#pragma unroll
      for (int k = 0; k < N; ++k) z[k] = k < ADJ ? tile[k * TS + c] : 0;
      Nets::inv(z, va, -32768, 32767);
      const bool corner_col = (c & (cell - 1)) == cell - 1;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const int rec = clampi(P[r * N + c] + round_shift(z[r], shc), 0, pmax);
        P[r * N + c] = (uint16_t)rec;  // the column's own prediction, read above
        if (c == N - 1) rw[r] = rec;
        if (corner_col && (r & (cell - 1)) == cell - 1)
          cw[(size_t)(r / cell) * C8 + c / cell] = rec;
        if (r == N - 1) bw[c] = rec;
      }
    }
  }
  // publish once the frontier cells are out (every lane's stores before the
  // flag); the levels and the recon, which no other task reads, after it
  __threadfence();
  __syncwarp();
  if (t == 0) st_release(flag, 1);
  for (int i = t; i < ADJ * ADJ; i += 32) lv_out[i] = lv[i];
  for (int i = t; i < N * N; i += 32) rec_out[i] = P[i];
  __syncwarp();
}

__global__ void __launch_bounds__(32)
    commit_wave_kernel(const FrameDesc* __restrict__ fd, const int* __restrict__ tasks,
                       const int* __restrict__ owner, int* __restrict__ sync, int T, int F,
                       int R8, int C8, int dq_dc, int dq_ac, int bd, int rdoq, float lam,
                       int max_n) {
  extern __shared__ __align__(16) int smem[];
  const WarpSmem m = warp_smem(smem, max_n);
  int* done = sync + 1;  // sync[0]: the queue's counter; done[t]: task t published
  for (;;) {
    int t = 0;
    if (threadIdx.x == 0) t = atomicAdd(sync, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= T) return;
    const int code = tasks[t];
    const int si = code & 7, pl = (code >> 3) & 3, ln = code >> 5;
    const int n = (int)fd->size[si].pd[pl > 0].n;
#define TASK(NN)                                                                           \
  commit_task<NN>(fd, si, pl, ln, R8, C8, dq_dc, dq_ac, bd, rdoq != 0, lam, m, owner, F, done, \
                  done + t)
    switch (n) {
      case 4: TASK(4); break;
      case 8: TASK(8); break;
      case 16: TASK(16); break;
      case 32: TASK(32); break;
      default: TASK(64); break;
    }
#undef TASK
  }
}

// One flag handed between two CTAs `rounds` times each way: CTA b waits
// for the value 2i + b and writes 2i + b + 1 (K16's cost per dependency
// edge, with the same acquire and release).
__global__ void flag_pingpong_kernel(int* flag, int rounds) {
  if (threadIdx.x) return;
  const int b = blockIdx.x;
  for (int i = 0; i < rounds; ++i) {
    wait_flag(flag, 2 * i + b);
    st_release(flag, 2 * i + b + 1);
  }
}

size_t smem_bytes(int max_n) { return (size_t)smem_ints(max_n) * sizeof(int); }

// The kernel's dynamic shared-memory limit raised once to what a 64x64
// table needs (above the 48 KB default).
int prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        commit_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(64));
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

}  // namespace

// The grid of a launch whose largest luma block is max_n over T tasks: the
// co-resident CTAs, at most T. Negative: a CUDA error code.
extern "C" int commit_wave_grid(int max_n, int T) {
  const int err = prepare();
  if (err) return -err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, commit_wave_kernel, 32,
                                                      smem_bytes(max_n));
  if (e != cudaSuccess) return -(int)e;
  const int grid = per_sm * sms;
  return grid < T ? grid : (T > 0 ? T : 1);
}

// fd: FrameDesc on the card; tasks (T,): the task table; owner (3, F, R8p,
// C8p), R8 and C8 rounded up to multiples of 8: per plane and 8x8 luma
// cell, the task that writes its frontier samples, -1 for none (an inter
// lane's or no lane's); sync: T + 1 ints of scratch,
// zeroed here before the kernel (the queue's counter and the ready flags);
// grid: commit_wave_grid's answer.
extern "C" int commit_wave_launch(const void* fd, const int* tasks, const int* owner, int* sync,
                                  int T, int F, int R8, int C8, int dq_dc, int dq_ac, int bd,
                                  int rdoq, float lam, int max_n, int grid, void* stream) {
  if (T == 0) return 0;
  const int err = prepare();
  if (err) return err;
  const auto s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sync, 0, (size_t)(T + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  commit_wave_kernel<<<grid, 32, smem_bytes(max_n), s>>>(
      (const FrameDesc*)fd, tasks, owner, sync, T, F, R8, C8, dq_dc, dq_ac, bd, rdoq, lam,
      max_n);
  return launch_status();
}

// `rounds` round trips of one flag between two co-resident CTAs (flag: one
// int on the card, zeroed here).
extern "C" int flag_pingpong_launch(int* flag, int rounds, void* stream) {
  const auto s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&flag, (void*)&rounds};
  e = cudaLaunchCooperativeKernel((void*)flag_pingpong_kernel, dim3(2), dim3(32), args, 0, s);
  return e != cudaSuccess ? (int)e : launch_status();
}
