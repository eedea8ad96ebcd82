// K10 mc_lanes: batched normative AV1 subpel motion compensation (spec
// 7.11.3.4, single prediction) with a per-lane position and phase: the 8-tap
// (or, for a dimension <= 4, the 4-tap) kernels of the lane's 1/16-pel
// phases, the horizontal pass rounded by ROUND0 into an int32 intermediate,
// the vertical pass rounded by ROUND1, the result clipped to [0, 2^bd - 1].
// Reference samples are read with each coordinate clamped to the plane, from
// one plane or from a (NREF, H, W) stack by the lane's ref index.
//
// Replaces svtav1_tpu/ops/me_jax.py::mc_lanes (conv_buf=False), which the
// inter decide calls for the chroma of every block at its winning MV and for
// the GLOBALMV lane, and the commit for the Y, U and V of every inter block.
//
// Both kernels are templates on the sample type: uint8_t planes at 8 bits,
// int16_t planes at 10 bits (mc_lanes16_launch, mc_compound16_launch); only
// the global loads differ, the patch and the passes are int32 either way.
//
// Bound: bytes. A lane reads its (n_h+7)(n_w+7) uint8 patch (mostly from L2:
// neighbouring lanes overlap) and writes n_h*n_w int32 samples; the work is
// 16 multiply-adds per output sample. Design: one block per lane; the clamped
// patch is staged in shared memory once, the horizontal pass writes the
// intermediate rows to shared memory, the vertical pass reads them and writes
// consecutive output samples from consecutive threads (coalesced). The
// per-lane phase only selects a row of the 16x8 kernel table.
//
// K11 mc_compound: compound-average MC (spec 7.11.3.4 with InterRound1 =
// COMPOUND_ROUND1, then the average blend of 7.11.3.15 without distance
// weights). Replaces svtav1_tpu/ops/me_jax.py::mc_lanes_compound (its two
// mc_lanes(conv_buf=True) passes and compound_average_j), which the commit's
// phase A runs for the Y, U and V of every NEW_NEWMV block of a
// hierarchical-B frame. Bound: operations (two 8-tap passes per reference at
// the int32 rate, 0.0063 ms for 32,400 8x8 lanes on an H100), with the bytes
// (two uint8 patches per lane, mostly from L2) close behind.
// Design: one block per lane; the two references are filtered in turn
// through the same shared patch and intermediate, and the first conv-buf
// prediction is kept in shared memory (each thread rereads only the samples
// it wrote), so the offset-carrying intermediate never leaves the block; the
// second pass blends and writes.
#include "common.cuh"

namespace {

constexpr int FILTER_BITS = 7, ROUND0 = 3, ROUND1 = 11, COMPOUND_ROUND1 = 7;
static_assert(2 * FILTER_BITS - ROUND0 - ROUND1 == 0, "no third rounding stage");

template <typename T>
__global__ void mc_lanes_kernel(const T* __restrict__ ref, const int* __restrict__ ys,
                                const int* __restrict__ xs, const int* __restrict__ mvy,
                                const int* __restrict__ mvx, const int* __restrict__ ref_idx,
                                const int* __restrict__ ftab_x, const int* __restrict__ ftab_y,
                                int* __restrict__ out, int nref, int H, int W, int nh, int nw,
                                int bd) {
  extern __shared__ int smem[];
  __shared__ int fx[8], fy[8];
  const int b = blockIdx.x;
  const int ph = nh + 7, pw = nw + 7;
  int* patch = smem;            // ph x pw
  int* im = smem + ph * pw;     // ph x nw
  // floor of negative positions and phases: >> and & 15 as the reference
  const int fy0 = ys[b] * 16 + mvy[b];
  const int fx0 = xs[b] * 16 + mvx[b];
  const int iy = fy0 >> 4, sy = fy0 & 15;
  const int ix = fx0 >> 4, sx = fx0 & 15;
  const int ri = ref_idx ? clampi(ref_idx[b], 0, nref - 1) : 0;
  const T* R = ref + (size_t)ri * H * W;
  if (threadIdx.x < 8) {
    fx[threadIdx.x] = ftab_x[sx * 8 + threadIdx.x];
    fy[threadIdx.x] = ftab_y[sy * 8 + threadIdx.x];
  }
  for (int i = threadIdx.x; i < ph * pw; i += blockDim.x) {
    const int r = i / pw, c = i - r * pw;
    const int gy = clampi(iy - 3 + r, 0, H - 1), gx = clampi(ix - 3 + c, 0, W - 1);
    patch[i] = R[(size_t)gy * W + gx];
  }
  __syncthreads();
  const int hbase = 1 << (bd + FILTER_BITS - 1);
  for (int i = threadIdx.x; i < ph * nw; i += blockDim.x) {
    const int r = i / nw, c = i - r * nw;
    const int* p = patch + r * pw + c;
    int acc = hbase;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fx[k] * p[k];
    im[i] = (acc + (1 << (ROUND0 - 1))) >> ROUND0;
  }
  __syncthreads();
  const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
  const int sub = (1 << (offset_bits - ROUND1)) + (1 << (offset_bits - ROUND1 - 1));
  const int maxv = (1 << bd) - 1;
  int* o = out + (size_t)b * nh * nw;
  for (int i = threadIdx.x; i < nh * nw; i += blockDim.x) {
    const int r = i / nw, c = i - r * nw;
    int acc = 1 << offset_bits;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fy[k] * im[(r + k) * nw + c];
    o[i] = clampi(((acc + (1 << (ROUND1 - 1))) >> ROUND1) - sub, 0, maxv);
  }
}

// Stage the clamped (nh+7) x (nw+7) patch of plane R around (iy, ix) and run
// the horizontal pass into im; ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void mc_horizontal(const T* __restrict__ R, int H, int W, int iy,
                                              int ix, const int* fx, int* patch, int* im, int nh,
                                              int nw, int bd) {
  const int ph = nh + 7, pw = nw + 7;
  for (int i = threadIdx.x; i < ph * pw; i += blockDim.x) {
    const int r = i / pw, c = i - r * pw;
    const int gy = clampi(iy - 3 + r, 0, H - 1), gx = clampi(ix - 3 + c, 0, W - 1);
    patch[i] = R[(size_t)gy * W + gx];
  }
  __syncthreads();
  const int hbase = 1 << (bd + FILTER_BITS - 1);
  for (int i = threadIdx.x; i < ph * nw; i += blockDim.x) {
    const int r = i / nw, c = i - r * nw;
    const int* p = patch + r * pw + c;
    int acc = hbase;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += fx[k] * p[k];
    im[i] = (acc + (1 << (ROUND0 - 1))) >> ROUND0;
  }
  __syncthreads();
}

template <typename T>
__global__ void mc_compound_kernel(const T* __restrict__ ref, const int* __restrict__ ys,
                                   const int* __restrict__ xs, const int* __restrict__ mv0y,
                                   const int* __restrict__ mv0x, const int* __restrict__ mv1y,
                                   const int* __restrict__ mv1x, const int* __restrict__ ref0,
                                   const int* __restrict__ ref1, const int* __restrict__ ftab_x,
                                   const int* __restrict__ ftab_y, int* __restrict__ out, int nref,
                                   int H, int W, int nh, int nw, int bd) {
  extern __shared__ int smem[];
  __shared__ int fx[2][8], fy[2][8];
  const int b = blockIdx.x;
  const int total = nh * nw;
  int* patch = smem;                     // (nh+7) x (nw+7)
  int* im = patch + (nh + 7) * (nw + 7);  // (nh+7) x nw
  int* conv0 = im + (nh + 7) * nw;        // nh x nw, the first prediction
  const int offset_bits = bd + 2 * FILTER_BITS - ROUND0;
  const int sub = (1 << (offset_bits - COMPOUND_ROUND1)) + (1 << (offset_bits - COMPOUND_ROUND1 - 1));
  constexpr int round_bits = 2 * FILTER_BITS - ROUND0 - COMPOUND_ROUND1;
  const int maxv = (1 << bd) - 1;
  int* o = out + (size_t)b * total;
  for (int pass = 0; pass < 2; ++pass) {
    // floor of negative positions and phases: >> and & 15 as the reference
    const int fy0 = ys[b] * 16 + (pass ? mv1y[b] : mv0y[b]);
    const int fx0 = xs[b] * 16 + (pass ? mv1x[b] : mv0x[b]);
    const int iy = fy0 >> 4, sy = fy0 & 15;
    const int ix = fx0 >> 4, sx = fx0 & 15;
    const int ri = clampi(pass ? ref1[b] : ref0[b], 0, nref - 1);
    if (threadIdx.x < 8) {
      fx[pass][threadIdx.x] = ftab_x[sx * 8 + threadIdx.x];
      fy[pass][threadIdx.x] = ftab_y[sy * 8 + threadIdx.x];
    }
    // the previous pass's vertical reads of im end here
    __syncthreads();
    mc_horizontal(ref + (size_t)ri * H * W, H, W, iy, ix, fx[pass], patch, im, nh, nw, bd);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / nw, c = i - r * nw;
      int acc = 1 << offset_bits;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc += fy[pass][t] * im[(r + t) * nw + c];
      const int conv = (acc + (1 << (COMPOUND_ROUND1 - 1))) >> COMPOUND_ROUND1;
      if (pass == 0) {
        conv0[i] = conv;
      } else {
        const int tmp = ((conv0[i] + conv) >> 1) - sub;
        o[i] = clampi((tmp + (1 << (round_bits - 1))) >> round_bits, 0, maxv);
      }
    }
  }
}

template <typename T>
int launch_mc_lanes(const T* ref, const int* ys, const int* xs, const int* mvy, const int* mvx,
                    const int* ref_idx, const int* ftab_x, const int* ftab_y, int* out, int B,
                    int nref, int H, int W, int nh, int nw, int bd, void* stream) {
  if (B == 0) return 0;
  const int outs = nh * nw;
  const int threads = outs >= 256 ? 256 : (outs + 31) / 32 * 32;
  const size_t shm = (size_t)((nh + 7) * (nw + 7) + (nh + 7) * nw) * sizeof(int);
  mc_lanes_kernel<T><<<B, threads, shm, (cudaStream_t)stream>>>(
      ref, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, nref, H, W, nh, nw, bd);
  return launch_status();
}

template <typename T>
int launch_mc_compound(const T* ref, const int* ys, const int* xs, const int* mv0y,
                       const int* mv0x, const int* mv1y, const int* mv1x, const int* ref0,
                       const int* ref1, const int* ftab_x, const int* ftab_y, int* out, int B,
                       int nref, int H, int W, int nh, int nw, int bd, void* stream) {
  if (B == 0) return 0;
  const int outs = nh * nw;
  const int threads = outs >= 256 ? 256 : (outs + 31) / 32 * 32;
  const size_t shm = (size_t)((nh + 7) * (nw + 7) + (nh + 7) * nw + nh * nw) * sizeof(int);
  // 64x64 lanes: 54.7 KB, above the default limit
  if (const int err = allow_smem(mc_compound_kernel<T>, shm)) return err;
  mc_compound_kernel<T><<<B, threads, shm, (cudaStream_t)stream>>>(
      ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out, nref, H, W, nh, nw, bd);
  return launch_status();
}

}  // namespace

extern "C" int mc_lanes_launch(const uint8_t* ref, const int* ys, const int* xs, const int* mvy,
                               const int* mvx, const int* ref_idx, const int* ftab_x,
                               const int* ftab_y, int* out, int B, int nref, int H, int W, int nh,
                               int nw, int bd, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes: 8-bit only
  return launch_mc_lanes(ref, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, B, nref, H, W, nh,
                         nw, bd, stream);
}

extern "C" int mc_lanes16_launch(const int16_t* ref, const int* ys, const int* xs, const int* mvy,
                                 const int* mvx, const int* ref_idx, const int* ftab_x,
                                 const int* ftab_y, int* out, int B, int nref, int H, int W,
                                 int nh, int nw, int bd, void* stream) {
  return launch_mc_lanes(ref, ys, xs, mvy, mvx, ref_idx, ftab_x, ftab_y, out, B, nref, H, W, nh,
                         nw, bd, stream);
}

extern "C" int mc_compound_launch(const uint8_t* ref, const int* ys, const int* xs, const int* mv0y,
                                  const int* mv0x, const int* mv1y, const int* mv1x,
                                  const int* ref0, const int* ref1, const int* ftab_x,
                                  const int* ftab_y, int* out, int B, int nref, int H, int W,
                                  int nh, int nw, int bd, void* stream) {
  if (bd != 8) return (int)cudaErrorInvalidValue;  // uint8 planes: 8-bit only
  return launch_mc_compound(ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out,
                            B, nref, H, W, nh, nw, bd, stream);
}

extern "C" int mc_compound16_launch(const int16_t* ref, const int* ys, const int* xs,
                                    const int* mv0y, const int* mv0x, const int* mv1y,
                                    const int* mv1x, const int* ref0, const int* ref1,
                                    const int* ftab_x, const int* ftab_y, int* out, int B,
                                    int nref, int H, int W, int nh, int nw, int bd, void* stream) {
  return launch_mc_compound(ref, ys, xs, mv0y, mv0x, mv1y, mv1x, ref0, ref1, ftab_x, ftab_y, out,
                            B, nref, H, W, nh, nw, bd, stream);
}
