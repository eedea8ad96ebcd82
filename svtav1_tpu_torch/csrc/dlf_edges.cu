// K4 dlf_edges: AV1 deblocking of a plane, both passes (every vertical edge,
// then every horizontal edge of the result; 4-, 6-, 8- and 14-tap filters
// with the mask, flat and hev decisions), for up to three jobs in one
// launch: a job is an input plane, its two filter-length maps, its levels'
// limits and an output plane (the luma level search: one plane at its
// nonzero candidate levels; the chroma: U and V, each with its own maps and
// level). A pass whose level is 0 leaves its input as it is.
//
// Replaces svtav1_tpu/filters/dlf_jax.py::filter_vertical_edges_j (:64-215),
// applied to the vertical edges and then, through the transpose, to the
// horizontal edges, as svtav1_tpu/pipeline/device_commit.py:790-823 does.
// Every edge of a pass takes its p/q samples from that pass's unfiltered
// input. Where the sample ranges of two edges overlap, the reference's
// stores run in order of the offset from the edge, so a sample keeps the
// value of the covering edge with the largest offset whose filter class
// writes that offset. An edge writes offsets [lo, hi] of its class (14: -6..5,
// 8: -3..2, 4 and 6: -2..1), and every class's lo reaches past the edges 4
// and 8 samples to its left, so what they store at the same samples is a
// prefix of the edge's range: the edge owns offsets max(lo, hi' - 3,
// hi'' - 7) .. hi, where hi' and hi'' are the classes' hi of the edges 4 and 8
// samples to its left (an edge 12 samples away cannot reach offset 5). The
// samples no edge writes keep the input.
//
// Bound: bytes (each job's plane read once and written once, and the maps);
// per edge and row the filter is ~150 integer operations. The first port's
// design (a thread per edge and plane row, int32 samples, a launch per pass
// and per candidate level, the horizontal pass reading back what the vertical
// one wrote, row-strided loads and stores in the vertical pass, per-sample
// loops over neighbouring edges for the ownership) took 13 to 17 times its
// bound per pass (1080p luma, H100). Design: one CTA per 64x64 output tile and
// job. The tile and a halo of 12 samples on each side are staged in shared
// memory as int16 with 16-byte loads. The halo: an output sample's owning edge
// lies at most 5 samples before it or 6 after it (offsets -6..5) and reads 7
// samples before the edge through 6 after it, so the horizontal pass reads
// rows 12 before through 11 after the tile, and the vertical pass that made
// those rows reads columns 12 before through 11 after it. The vertical pass
// runs over the box's rows into a second int16 buffer (initialised to the
// input), a thread per (edge, row), rows fastest; the horizontal pass reads
// that buffer and writes the output tile (initialised to it) in shared memory,
// a thread per (edge, column), columns fastest; the tile leaves as int32 in
// 16-byte stores. Ownership reads the filter-length bands staged with the tile
// through a table of each class's offset range. Nothing is read from or
// written to device memory row-strided, and the two passes share one launch.
#include "common.cuh"

namespace {

constexpr int TILE = 64;                // output tile side (samples)
constexpr int HALO = 12;                // staged samples on each side (derived above)
constexpr int BOX = TILE + 2 * HALO;    // 88: staged rows and columns
constexpr int SS = BOX + 2;             // row stride of the staged box: 45 words, odd
constexpr int VS = TILE + 2;            // row stride of the pass buffers: 33 words, odd
constexpr int NEDGE = TILE / 4 + 3;     // edges that write into a tile: 19
constexpr int NBAND = NEDGE + 2;        // with the two to their left that ownership reads
constexpr int DLF_THREADS = 256;
constexpr int DLF_JOBS = 3;

// a job's pointers (frame 0) and limits; flags 0 leave that pass out
struct DlfJobs {
  const int* in[DLF_JOBS];
  const int* fv[DLF_JOBS];  // (F, H/4, W/4 - 1) vertical edges' lengths
  const int* fh[DLF_JOBS];  // (F, W/4, H/4 - 1) horizontal edges' lengths
  int* out[DLF_JOBS];
  int lv[DLF_JOBS][8];      // on_v, lim_v, blim_v, thr_v, on_h, lim_h, blim_h, thr_h
};

// the offsets [lo, hi] a filter class stores (dlf_jax.py classmask); hi of
// length 0 is below every offset
__device__ __forceinline__ int class_lo(int fl) { return fl == 14 ? -6 : (fl == 8 ? -3 : -2); }
__device__ __forceinline__ int class_hi(int fl) {
  return fl == 14 ? 5 : (fl == 8 ? 2 : (fl ? 1 : -16));
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


// One pass over the edges of a tile: edge e (0..NEDGE-1) at plane position
// pos0 + 4 e on NL lines (the box's rows, or the tile's columns); line l
// (plane position lines0 + l) reads its 14 samples at src[l * sl + (c - org)
// * sc] for plane positions c clamped to [0, n - 1], its length at
// band[l / 4][e + 2] (e + 1 and e: the edges 4 and 8 samples to its left),
// and writes each owned offset that falls in [w0, w0 + TILE) and below n to
// dst[l * dl + (c - w0) * dc].
struct Pass {
  const int16_t* src;
  int sl, sc;          // src strides: line, sample
  int16_t* dst;
  int dl, dc;          // dst strides
  int org;             // plane position of src's sample 0
  int w0;              // plane position of dst's sample 0
  int n;               // plane extent along the samples
};

template <int NL>
__device__ void run_pass(const Pass& ps, const int8_t (*band)[NBAND], int pos0,
                         int lines0, int nlines_plane, const int* lv, int sh) {
  const int lim = lv[0] << sh, blim = lv[1] << sh, thr = lv[2] << sh;
  for (int i = threadIdx.x; i < NL * NEDGE; i += DLF_THREADS) {
    const int e = i / NL, l = i - e * NL;  // lines fastest: no bank conflicts
    const int gl = lines0 + l;  // the line's plane position
    if (gl < 0 || gl >= nlines_plane) continue;
    const int8_t* lens = band[l >> 2];
    const int fl = lens[e + 2];
    if (!fl) continue;
    const int x = pos0 + 4 * e;
    const int16_t* row = ps.src + l * ps.sl;
    int p[7], q[7], v[12];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      p[k] = row[(clampi(x - 1 - k, 0, ps.n - 1) - ps.org) * ps.sc];
      q[k] = row[(clampi(x + k, 0, ps.n - 1) - ps.org) * ps.sc];
    }
    filter_edge(p, q, fl, lim, blim, thr, 128 << sh, 1 << sh, v);
    const int first = max(class_lo(fl), max(class_hi(lens[e + 1]) - 3, class_hi(lens[e]) - 7));
    const int last = class_hi(fl);
    int16_t* drow = ps.dst + l * ps.dl;
#pragma unroll
    for (int off = -6; off <= 5; ++off) {
      const int c = x + off;
      if (off >= first && off <= last && c >= ps.w0 && c < ps.w0 + TILE && c < ps.n)
        drow[(c - ps.w0) * ps.dc] = (int16_t)v[off + 6];
    }
  }
}

// grid: (tiles, F, jobs)
__global__ void __launch_bounds__(DLF_THREADS)
dlf_edges_kernel(DlfJobs jobs, int H, int W, int bd) {
  __shared__ __align__(16) int16_t S[BOX * SS];  // the staged box; then the output tile
  __shared__ __align__(16) int16_t V[BOX * VS];  // the box's rows after the vertical pass
  __shared__ int8_t fvb[BOX / 4][NBAND];         // vertical edges' lengths per 4-row band
  __shared__ int8_t fhb[TILE / 4][NBAND];        // horizontal edges' lengths per 4-column band
  const int tiles_x = (W + TILE - 1) / TILE;
  const int ty0 = blockIdx.x / tiles_x * TILE, tx0 = blockIdx.x % tiles_x * TILE;
  const int by0 = ty0 - HALO, bx0 = tx0 - HALO;  // the box's origin (multiples of 4)
  const int f = blockIdx.y, j = blockIdx.z;
  const size_t fo = (size_t)f * H * W;
  const int* in = jobs.in[j] + fo;
  const int Kv = W / 4 - 1, Kh = H / 4 - 1;

  // stage the box (quads of 4 samples; W is a multiple of 4, so a quad lies
  // wholly inside or outside the plane, and no pass reads outside it) and
  // the vertical-pass buffer's columns
  const bool vec = ((size_t)in & 15) == 0;
  for (int i = threadIdx.x; i < BOX * (BOX / 4); i += DLF_THREADS) {
    const int r = i / (BOX / 4), qc = i - r * (BOX / 4);
    const int gy = by0 + r, gx = bx0 + 4 * qc;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const int* src = in + (size_t)gy * W + gx;
    const int4 v = vec ? __ldg((const int4*)src) : make_int4(src[0], src[1], src[2], src[3]);
    const unsigned lo = (unsigned)(v.x & 0xffff) | ((unsigned)v.y << 16);
    const unsigned hi = (unsigned)(v.z & 0xffff) | ((unsigned)v.w << 16);
    unsigned* s = (unsigned*)(S + r * SS + 4 * qc);
    s[0] = lo;
    s[1] = hi;
    if (qc >= HALO / 4 && qc < (HALO + TILE) / 4) {
      unsigned* d = (unsigned*)(V + r * VS + 4 * qc - HALO);
      d[0] = lo;
      d[1] = hi;
    }
  }
  // the lengths of the edges from 12 samples before the tile through 4 past
  // it (fvb, fhb [band][e]: the edge at the box's origin + 4 e)
  const int* fvm = jobs.fv[j] + (size_t)f * (H / 4) * Kv;
  const int* fhm = jobs.fh[j] + (size_t)f * (W / 4) * Kh;
  for (int i = threadIdx.x; i < (BOX / 4 + TILE / 4) * NBAND; i += DLF_THREADS) {
    const int bnd = i / NBAND, e = i - bnd * NBAND;
    if (bnd < BOX / 4) {  // vertical edges at x = bx0 + 4 e, rows of band by0 / 4 + bnd
      const int k = bx0 / 4 + e - 1, rb = by0 / 4 + bnd;
      fvb[bnd][e] = (k >= 0 && k < Kv && rb >= 0 && rb < H / 4) ? (int8_t)fvm[rb * Kv + k] : 0;
    } else {  // horizontal edges at y = by0 + 4 e, columns of band tx0 / 4 + bnd'
      const int b2 = bnd - BOX / 4, k = by0 / 4 + e - 1, cb = tx0 / 4 + b2;
      fhb[b2][e] = (k >= 0 && k < Kh && cb < W / 4) ? (int8_t)fhm[cb * Kh + k] : 0;
    }
  }
  __syncthreads();
  const int sh = bd - 8;
  const int* lv = jobs.lv[j];
  if (lv[0]) {  // vertical edges x = tx0 - 4 + 4 e over the box's rows, into V
    const Pass ps{S, SS, 1, V, VS, 1, bx0, tx0, W};
    run_pass<BOX>(ps, fvb, tx0 - 4, by0, H, lv + 1, sh);
  }
  __syncthreads();
  int16_t* O = S;  // the staged box is read no more: the output tile
  for (int i = threadIdx.x; i < TILE * (TILE / 2); i += DLF_THREADS) {
    const int r = i / (TILE / 2), c2 = i - r * (TILE / 2);
    ((unsigned*)(O + r * VS))[c2] = ((const unsigned*)(V + (r + HALO) * VS))[c2];
  }
  __syncthreads();
  if (lv[4]) {  // horizontal edges y = ty0 - 4 + 4 e over the tile's columns, into O
    const Pass ps{V, 1, VS, O, 1, VS, by0, ty0, H};
    run_pass<TILE>(ps, fhb, ty0 - 4, tx0, W, lv + 5, sh);
  }
  __syncthreads();
  int* out = jobs.out[j] + fo;
  for (int i = threadIdx.x; i < TILE * (TILE / 4); i += DLF_THREADS) {
    const int r = i / (TILE / 4), qc = i - r * (TILE / 4);
    const int gy = ty0 + r, gx = tx0 + 4 * qc;
    if (gy >= H || gx >= W) continue;
    const int16_t* o = O + r * VS + 4 * qc;
    *(int4*)(out + (size_t)gy * W + gx) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// ptrs: J x (in, flen_v, flen_h, out) device pointers and lv: J x 8 limits,
// both in host memory (copied into the kernel's parameter); planes (F, H, W)
// int32 with H and W multiples of 4, out 16-byte aligned.
extern "C" int dlf_edges_launch(const long long* ptrs, const int* lv, int J, int F, int H,
                                int W, int bd, void* stream) {
  if (J < 1 || J > DLF_JOBS || H % 4 || W % 4) return (int)cudaErrorInvalidValue;
  if (F == 0 || H == 0 || W == 0) return 0;
  DlfJobs jobs;
  for (int j = 0; j < J; ++j) {
    jobs.in[j] = (const int*)ptrs[4 * j];
    jobs.fv[j] = (const int*)ptrs[4 * j + 1];
    jobs.fh[j] = (const int*)ptrs[4 * j + 2];
    jobs.out[j] = (int*)ptrs[4 * j + 3];
    if ((size_t)jobs.out[j] & 15) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 8; ++k) jobs.lv[j][k] = lv[8 * j + k];
  }
  const dim3 grid(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), F, J);
  dlf_edges_kernel<<<grid, DLF_THREADS, 0, (cudaStream_t)stream>>>(jobs, H, W, bd);
  return launch_status();
}
