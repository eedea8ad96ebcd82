// K16 commit_wave: commit phase B, the intra wavefront, as one persistent
// cooperative kernel. Every task is one block of one plane (a size, a lane
// of that size's schedule and a plane); the host orders the tasks by wave
// (pipeline/wavefront.py wave_tasks). The CTAs grid-stride over one
// wave's tasks, then meet at a grid barrier, then take the next wave. Per
// task, inside one CTA with every intermediate in shared memory:
//   1. gather the above row, left column and top-left sample from the
//      frontier maps, with the commit's fills for missing neighbours;
//   2. predict the chosen mode (K1's intra_pred_block);
//   3. transform and quantize (txfm.cuh's txq_block, forward half);
//   4. RDOQ with the size's tables (K5's rdoq_block), when on;
//   5. inverse transform and reconstruct (txq_block's inverse half);
//   6. write the levels to the lane's slot, the recon to the lane's slot and
//      the frontier cells (each cell has one writer).
// K1 and K5 call the same device functions, and txq_block computes what K2's
// generated networks compute (both are held against the plain version), so
// K16 is bit-exact with the wave loop of those kernels (commit_wave_plain);
// chip_smoke.py holds the two equal on four 1080p schedules.
//
// Replaces the wave loop of svtav1_tpu/pipeline/device_commit.py
// (_commit_device's phase B, `lax.fori_loop` over the waves at :542-552,
// with the wave body `_wave_step`), which the port ran as a Python loop over
// the waves launching K1, K2 and K5 per wave and size.
//
// Bound: latency. Phase B is a chain of up to a few hundred dependent waves
// (a 1080p key frame has 258), most of them a few blocks wide, so the card
// waits on the chain and not on bytes or operations: the summed K1/K2/K5
// bounds of a frame's lanes are tens of microseconds. Design: one launch per
// region instead of one host round trip and six launches per wave and size;
// the prediction, coefficients and levels stay in shared memory; frontier
// cells are read with ld.global.cg (L2, never a stale L1 line written by
// another SM in an earlier wave). No tensor cores or TMA: the transforms
// are rounding integer stage networks on blocks of at most 64x64 and the
// waves are latency-bound. The grid is the co-resident CTAs
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), cut to the widest
// wave.
#include <cooperative_groups.h>

#include "intra_pred.cuh"
#include "rdoq.cuh"
#include "txfm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSizes = 4;  // luma 8, 16, 32, 64 (device_decide.SIZES)

// The tables of one (size, plane group); every field 8 bytes, in the order
// of wavefront.py's PLANE_FIELDS.
struct PlaneDesc {
  long long tables;              // K2 packed stage tables of the plane's block size
  long long weights;             // K1 smooth weights of that size
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

__global__ void __launch_bounds__(kThreads)
    commit_wave_kernel(const FrameDesc* __restrict__ fd, const int* __restrict__ tasks,
                       const int* __restrict__ wave_start, int nwaves, int F, int R8, int C8,
                       int dq_dc, int dq_ac, int bd, int rdoq, float lam, int max_n) {
  extern __shared__ int smem[];
  const int nnmax = max_n * max_n;
  const int adjmax = max_n < 32 ? nnmax : 1024;
  int* X = smem;  // K2's buffers; K5's magnitudes (X) and n + 1 gains (Y)
  int* Y = X + nnmax + 4;
  int* P = Y + nnmax + 4;  // prediction, then recon
  int* lv0 = P + nnmax;
  int* lv1 = lv0 + adjmax;
  int* co = lv1 + adjmax;
  int* A = co + adjmax;
  int* Lf = A + max_n;
  __shared__ int s_tl;
  const int AW = C8 * 8, AH = R8 * 8;
  const int base = 1 << (bd - 1);
  const int* dr = (const int*)fd->dr;
  for (int w = 0; w < nwaves; ++w) {
    const int t1 = wave_start[w + 1];
    for (int t = wave_start[w] + blockIdx.x; t < t1; t += gridDim.x) {
      const int code = tasks[t];
      const int si = code & 7, pl = (code >> 3) & 3, lane = code >> 5;
      const SizeDesc& S = fd->size[si];
      const PlaneDesc& D = S.pd[pl > 0];
      const long long* cd = (const long long*)S.coords + 3 * (size_t)lane;
      const int f = (int)cd[0], r8 = (int)cd[1], c8 = (int)cd[2];
      const int n = (int)D.n, log2n = (int)D.log2n, nn = n * n;
      const int adj = n < 32 ? n : 32;
      const int cell = pl ? 4 : 8;
      const int n8 = (n * (pl ? 2 : 1)) >> 3;
      const int pw = pl ? AW >> 1 : AW, ph = pl ? AH >> 1 : AH;
      const int xx = c8 * cell, yy = r8 * cell;
      const bool ha = r8 > 0, hl = c8 > 0;
      const int rr = r8 > 0 ? r8 - 1 : 0, cc = c8 > 0 ? c8 - 1 : 0;
      int* bm = (int*)fd->bmap[pl];
      int* rm = (int*)fd->rmap[pl];
      int* cm = (int*)fd->cmap[pl];
      // 1. edges (device_commit edges_from's fills)
      const int* brow = bm + ((size_t)f * R8 + rr) * pw + xx;
      const int* rcol = rm + ((size_t)f * C8 + cc) * ph + yy;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        A[i] = ha ? __ldcg(brow + i) : (hl ? __ldcg(rcol) : base - 1);
        Lf[i] = hl ? __ldcg(rcol + i) : (ha ? __ldcg(brow) : base + 1);
      }
      if (threadIdx.x == 0) {
        s_tl = ha && hl ? __ldcg(cm + ((size_t)f * R8 + rr) * C8 + cc)
                        : ha ? __ldcg(brow) : (hl ? __ldcg(rcol) : base);
      }
      __syncthreads();
      // 2. prediction of the chosen mode (uv_mode = y mode)
      const int mode = ((const int*)S.mode)[lane];
      intra_pred_block(A, Lf, s_tl, ha, hl, mode, (const int*)D.weights, dr, P, n, log2n, 13);
      __syncthreads();
      // 3-5. transform, quantize, RDOQ, reconstruct (recon in place of P)
      const int tx = pl ? ((const int*)S.uv_tx)[lane] : ((const int*)S.tx)[lane];
      const bool va = D.ntypes > 1 && (tx == 1 || tx == 2);
      const bool hv = D.ntypes > 1 && (tx == 1 || tx == 3);
      const int* src = (const int*)fd->src[pl] + ((size_t)f * ph + yy) * pw + xx;
      const int* tb = (const int*)D.tables;
      const int b0 = (int)D.b0, b1 = (int)D.b1, b2 = (int)D.b2, shr = (int)D.sh_row;
      const int shc = (int)D.sh_col, qls = (int)D.qls;
      int* lv = lv0;
      if (rdoq) {
        txq_block(src, pw, P, va, hv, tb, lv0, co, nullptr, nullptr, 1, n, log2n, b0, b1, b2,
                  shr, shc, dq_dc, dq_ac, qls, bd, X, Y);
        __syncthreads();
        rdoq_block(lv0, co, (const float*)D.flut, (const int*)D.ilut, (const int*)D.scan, lv1,
                   adj, adj, (int)D.log2w, (int)D.rls, dq_dc, dq_ac, lam,
                   __int_as_float((int)D.dscale_bits), __int_as_float((int)D.skip_bits), X,
                   (float*)Y);
        __syncthreads();
        txq_block(nullptr, 0, P, va, hv, tb, lv1, nullptr, P, nullptr, 2, n, log2n, b0, b1, b2,
                  shr, shc, dq_dc, dq_ac, qls, bd, X, Y);
        lv = lv1;
      } else {
        txq_block(src, pw, P, va, hv, tb, lv0, nullptr, P, nullptr, 0, n, log2n, b0, b1, b2,
                  shr, shc, dq_dc, dq_ac, qls, bd, X, Y);
      }
      __syncthreads();
      // 6. levels, recon and frontier cells out
      int* lv_out = (int*)S.lv[pl] + (size_t)lane * adj * adj;
      int* rec_out = (int*)S.rec[pl] + (size_t)lane * nn;
      for (int i = threadIdx.x; i < adj * adj; i += blockDim.x) lv_out[i] = lv[i];
      for (int i = threadIdx.x; i < nn; i += blockDim.x) rec_out[i] = P[i];
      int* bw = bm + ((size_t)f * R8 + r8 + n8 - 1) * pw + xx;
      int* rw = rm + ((size_t)f * C8 + c8 + n8 - 1) * ph + yy;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        bw[i] = P[(n - 1) * n + i];
        rw[i] = P[i * n + n - 1];
      }
      for (int k = threadIdx.x; k < n8 * n8; k += blockDim.x) {
        const int a = k / n8, b = k - a * n8;
        cm[((size_t)f * R8 + r8 + a) * C8 + c8 + b] =
            P[(a * cell + cell - 1) * n + b * cell + cell - 1];
      }
      __syncthreads();  // shared memory is the next task's
    }
    if (w + 1 < nwaves) cg::this_grid().sync();
  }
}

// The barrier alone: `nbarriers` grid barriers of `grid` CTAs (K16's
// barrier cost at the same grid).
__global__ void __launch_bounds__(kThreads) grid_sync_kernel(int nbarriers) {
  for (int i = 0; i < nbarriers; ++i) cg::this_grid().sync();
}

// The kernel's dynamic shared memory: X, Y (with room for K5's n + 1
// gains), P, three level-sized buffers and the two edges.
size_t smem_bytes(int max_n) {
  const int nnmax = max_n * max_n, adjmax = max_n < 32 ? nnmax : 1024;
  return (size_t)(3 * nnmax + 8 + 3 * adjmax + 2 * max_n) * sizeof(int);
}

int prepare(int max_n) {
  static bool done = false;
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(commit_wave_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(64));
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

}  // namespace

// The grid of a launch whose largest luma block is max_n and whose widest
// wave holds max_tasks tasks: the co-resident CTAs, at most max_tasks.
// Negative: a CUDA error code.
extern "C" int commit_wave_grid(int max_n, int max_tasks) {
  int err = prepare(max_n);
  if (err) return -err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, commit_wave_kernel, kThreads,
                                                      smem_bytes(max_n));
  if (e != cudaSuccess) return -(int)e;
  const int grid = per_sm * sms;
  return grid < max_tasks ? grid : (max_tasks > 0 ? max_tasks : 1);
}

// fd: FrameDesc on the card; tasks / wave_start: the wave-major task table;
// grid: commit_wave_grid's answer.
extern "C" int commit_wave_launch(const void* fd, const int* tasks, const int* wave_start,
                                  int nwaves, int F, int R8, int C8, int dq_dc, int dq_ac, int bd,
                                  int rdoq, float lam, int max_n, int grid, void* stream) {
  if (nwaves == 0) return 0;
  int err = prepare(max_n);
  if (err) return err;
  const size_t smem = smem_bytes(max_n);
  const FrameDesc* fdp = (const FrameDesc*)fd;
  void* args[] = {(void*)&fdp, (void*)&tasks, (void*)&wave_start, (void*)&nwaves, (void*)&F,
                  (void*)&R8, (void*)&C8, (void*)&dq_dc, (void*)&dq_ac, (void*)&bd,
                  (void*)&rdoq, (void*)&lam, (void*)&max_n};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)commit_wave_kernel, dim3(grid),
                                              dim3(kThreads), args, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : launch_status();
}

extern "C" int grid_sync_launch(int grid, int nbarriers, void* stream) {
  void* args[] = {(void*)&nbarriers};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)grid_sync_kernel, dim3(grid),
                                              dim3(kThreads), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : launch_status();
}
