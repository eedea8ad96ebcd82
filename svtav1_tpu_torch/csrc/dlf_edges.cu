// K4 dlf_edges: AV1 deblocking of every vertical edge of one pass (4-, 6-, 8-
// and 14-tap filters with the mask, flat and hev decisions); the horizontal
// pass is the same kernel with the row and column strides swapped.
//
// Replaces svtav1_tpu/filters/dlf_jax.py::filter_vertical_edges_j (:64-215).
// Every edge takes its p/q samples from the unfiltered plane, so the kernel
// reads the pass's input buffer and writes a separate output buffer. Where
// the sample ranges of two edges overlap, the reference's stores run in
// order of the offset from the edge, so a sample keeps the value of the
// covering edge with the largest offset whose filter class writes that
// offset; each thread skips the samples such an edge to its left owns. The
// samples no edge writes are copied from the input by the thread whose
// four-column home range (x-2 .. x+1 around its edge x) holds them. So every
// output sample has exactly one writer, and the result does not depend on
// thread order.
//
// Bound: bytes (the plane read once and written once). Each (row, edge)
// thread reads up to 14 samples and writes up to 12; the filter arithmetic
// is ~100 integer ops. Design: one thread per (frame, edge column, plane
// row), with the plane row fastest so that the horizontal pass (rows are the
// plane's columns, stride 1) reads and writes coalesced; the vertical pass
// reads 14 samples within one row per thread.
#include "common.cuh"

namespace {

// offsets [lo, hi] a filter class stores (dlf_jax.py classmask)
__device__ __forceinline__ bool class_writes(int flen, int off) {
  if (flen == 14) return off >= -6 && off <= 5;
  if (flen == 8) return off >= -3 && off <= 2;
  if (flen == 4 || flen == 6) return off >= -2 && off <= 1;
  return false;
}

struct Narrow {
  int op1, op0, oq0, oq1;
};

__device__ __forceinline__ int clip8(int v, int half) { return clampi(v, -half, half - 1); }

__device__ Narrow narrow(const int* p, const int* q, bool mask, int thr, int half) {
  const int ps1 = p[1] - half, ps0 = p[0] - half, qs0 = q[0] - half, qs1 = q[1] - half;
  const bool hev = abs(p[1] - p[0]) > thr || abs(q[1] - q[0]) > thr;
  int f = hev ? clip8(ps1 - qs1, half) : 0;
  f = mask ? clip8(f + 3 * (qs0 - ps0), half) : 0;
  const int f1 = clip8(f + 4, half) >> 3;
  const int f2 = clip8(f + 3, half) >> 3;
  const int t = hev ? 0 : ((f1 + 1) >> 1);
  Narrow o;
  o.oq0 = clip8(qs0 - f1, half) + half;
  o.op0 = clip8(ps0 + f2, half) + half;
  o.oq1 = clip8(qs1 - t, half) + half;
  o.op1 = clip8(ps1 + t, half) + half;
  return o;
}

__device__ __forceinline__ int r2(int v, int s) { return (v + (1 << (s - 1))) >> s; }

// does any edge of this row (filter lengths frow[0..K)) store sample c?
__device__ bool covered(const int* frow, int K, int c) {
  const int k0 = max(0, (c - 2) / 4 - 1), k1 = min(K - 1, (c + 6) / 4 - 1);
  for (int k = k0; k <= k1; ++k)
    if (class_writes(frow[k], c - 4 * (k + 1))) return true;
  return false;
}

// The filter of one edge with length fl: v[off + 6] for offsets -6..5
// (the input sample where the filter leaves it).
__device__ void filter_edge(const int* p, const int* q, int fl, int lim, int blim, int thr,
                            int half, int fthr, int* v) {
  const bool m2 = abs(p[1] - p[0]) <= lim && abs(q[1] - q[0]) <= lim &&
                  abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) / 2 <= blim;
  const bool m3 = m2 && abs(p[2] - p[1]) <= lim && abs(q[2] - q[1]) <= lim;
  const bool mfull = m3 && abs(p[3] - p[2]) <= lim && abs(q[3] - q[2]) <= lim;
  const bool fl3 = abs(p[1] - p[0]) <= fthr && abs(q[1] - q[0]) <= fthr &&
                   abs(p[2] - p[0]) <= fthr && abs(q[2] - q[0]) <= fthr;
  const bool fl4 = fl3 && abs(p[3] - p[0]) <= fthr && abs(q[3] - q[0]) <= fthr;

  for (int i = 0; i < 6; ++i) {  // default: the input sample
    v[5 - i] = p[i];
    v[6 + i] = q[i];
  }
  if (fl == 4) {
    const Narrow o = narrow(p, q, m2, thr, half);
    v[4] = o.op1; v[5] = o.op0; v[6] = o.oq0; v[7] = o.oq1;
  } else if (fl == 6) {
    const bool flat = fl3 && m3;
    if (flat) {
      v[4] = r2(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3);
      v[5] = r2(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3);
      v[6] = r2(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3);
      v[7] = r2(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3);
    } else {
      const Narrow o = narrow(p, q, m3, thr, half);
      v[4] = o.op1; v[5] = o.op0; v[6] = o.oq0; v[7] = o.oq1;
    }
  } else {  // 8 or 14
    const bool flat = fl4 && mfull;
    bool flat2 = false;
    if (fl == 14)
      flat2 = flat && abs(p[6] - p[0]) <= fthr && abs(p[5] - p[0]) <= fthr &&
              abs(p[4] - p[0]) <= fthr && abs(q[4] - q[0]) <= fthr && abs(q[5] - q[0]) <= fthr &&
              abs(q[6] - q[0]) <= fthr;
    if (flat2) {
      v[0] = r2(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] + p[1] + p[0] + q[0], 4);
      v[1] = r2(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 + p[2] + p[1] + p[0] + q[0] + q[1], 4);
      v[2] = r2(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 + p[2] * 2 + p[1] + p[0] + q[0] + q[1] + q[2], 4);
      v[3] = r2(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 + p[1] * 2 + p[0] + q[0] + q[1] + q[2] +
                q[3], 4);
      v[4] = r2(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 + p[1] * 2 + p[0] * 2 + q[0] + q[1] + q[2] +
                q[3] + q[4], 4);
      v[5] = r2(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1] + q[2] +
                q[3] + q[4] + q[5], 4);
      v[6] = r2(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2] + q[3] +
                q[4] + q[5] + q[6], 4);
      v[7] = r2(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 + q[1] * 2 + q[2] * 2 + q[3] + q[4] +
                q[5] + q[6] * 2, 4);
      v[8] = r2(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 + q[2] * 2 + q[3] * 2 + q[4] + q[5] +
                q[6] * 3, 4);
      v[9] = r2(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 2 + q[4] * 2 + q[5] + q[6] * 4, 4);
      v[10] = r2(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 + q[4] * 2 + q[5] * 2 + q[6] * 5, 4);
      v[11] = r2(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 + q[5] * 2 + q[6] * 7, 4);
    } else if (flat) {
      v[3] = r2(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3);
      v[4] = r2(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3);
      v[5] = r2(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3);
      v[6] = r2(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3);
      v[7] = r2(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3);
      v[8] = r2(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3);
    } else {
      const Narrow o = narrow(p, q, mfull, thr, half);
      v[4] = o.op1; v[5] = o.op0; v[6] = o.oq0; v[7] = o.oq1;
    }
  }
}

__global__ void dlf_edges_kernel(const int* __restrict__ in, int* __restrict__ out,
                                 const int* __restrict__ flen, int F, int H, int W, int K, int sF,
                                 int sR, int sC, int lim, int blim, int thr, int bd) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)F * H * K) return;
  const int row = (int)(tid % H);
  const int k = (int)((tid / H) % K);
  const int f = (int)(tid / ((long long)H * K));
  const int* frow = flen + ((size_t)f * (H / 4) + row / 4) * K;
  const int fl = frow[k];
  const int x = (k + 1) * 4;
  const int* ibase = in + (size_t)f * sF + (size_t)row * sR;
  int* obase = out + (size_t)f * sF + (size_t)row * sR;
  if (fl) {
    const int sh = bd - 8;
    int p[7], q[7], v[12];
    for (int i = 0; i < 7; ++i) {
      p[i] = ibase[(size_t)clampi(x - 1 - i, 0, W - 1) * sC];
      q[i] = ibase[(size_t)clampi(x + i, 0, W - 1) * sC];
    }
    filter_edge(p, q, fl, lim << sh, blim << sh, thr << sh, 128 << sh, 1 << sh, v);
    for (int off = -6; off <= 5; ++off) {
      if (!class_writes(fl, off)) continue;
      const int c = x + off;
      if (c < 0 || c >= W) continue;
      // a covering edge further left (k - j, offset off + 4j) stores later
      bool owned = true;
      for (int j = 1; off + 4 * j <= 5 && k - j >= 0; ++j)
        if (class_writes(frow[k - j], off + 4 * j)) owned = false;
      if (owned) obase[(size_t)c * sC] = v[off + 6];
    }
  }
  // this thread's home columns that no edge stores keep the input sample
  const int lo = k == 0 ? 0 : x - 2, hi = k == K - 1 ? W : x + 2;
  for (int c = lo; c < hi; ++c)
    if (!covered(frow, K, c)) obase[(size_t)c * sC] = ibase[(size_t)c * sC];
}

}  // namespace

extern "C" int dlf_edges_launch(const int* in, int* out, const int* flen, int F, int H, int W,
                                int K, int sF, int sR, int sC, int lim, int blim, int thr, int bd,
                                void* stream) {
  const long long total = (long long)F * H * K;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  dlf_edges_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(in, out, flen, F, H, W, K, sF,
                                                                 sR, sC, lim, blim, thr, bd);
  return launch_status();
}
