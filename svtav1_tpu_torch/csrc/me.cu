// K8 me_sad: the SAD work of the full-pel motion search, three entry modes of
// one launch function:
//   0 decimate: the pyramid's 2x2 average, (p00 + p01 + p10 + p11 + 2) >> 2;
//   1 search:   for B (n, n) source blocks at (ys, xs), the SAD against every
//               displacement of a (n+2r)^2 reference window around the
//               block's full-pel centre, plus the bias (|dy| + |dx|) * scale;
//               returns centre + the first-minimum displacement in (dy, dx)
//               raster order;
//   2 leaf:     for each 64x64 SB and each of K centres, the (2r+1)^2 SAD
//               map of each of its 64 8x8 leaves around the centre, int32,
//               SB-major, leaves raster in the SB.
// The reference plane has its own dims (Hr, Wr) and may be wider than the
// source: a source column x sits at reference column x + ox (a tile's
// halo-cropped reference, ox = the halo). Source reads clamp to (H, W),
// reference reads to (Hr, Wr).
// The quadtree sum of the leaf maps, the per-size biased argmin and the
// two-centre merge are PyTorch glue (ops/me_torch.py me_fullpel_frame).
//
// Replaces svtav1_tpu/ops/me_jax.py::me_fullpel_frame's device work: :31
// decimate2_j, :40 gather_windows, :54 sad_maps, :64 _argmin2d, :77
// _search_centered (L2 16x16 at +-16 on the 1/4-resolution plane, L1 32x32 and
// L0 64x64 at +-2) and the two leaf-map windows (:137-152), with its
// ref_off_x (:86-145).
//
// Bound: operations. A 1080p frame's leaf maps are 2 x 32,640 leaves x 81
// displacements x 64 absolute differences (about 0.34 G subtract-abs-adds per
// reference) from about 8 MB of int32 planes; the L2 search adds 510 x 1,089 x
// 256. Design: one block per source block (search) or per SB and centre
// (leaf); the source block and the whole reference window are staged in
// shared memory once, so every SAD reads shared memory only. In the search,
// work items are (row, displacement) pairs with the displacement fastest, so
// the lanes of a warp add into different SAD slots; one warp then takes the
// first minimum over packed (value, index) keys. In the leaf mode each thread
// sums whole 8x8 SADs of (leaf, displacement) items and writes them
// coalesced.
#include "common.cuh"

namespace {

__global__ void decimate_kernel(const int* __restrict__ in, int* __restrict__ out, int H, int W) {
  const int Ho = H >> 1, Wo = W >> 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Ho * Wo) return;
  const int y = i / Wo, x = i - y * Wo;
  const int* p = in + (size_t)(2 * y) * W + 2 * x;
  out[i] = (p[0] + p[1] + p[W] + p[W + 1] + 2) >> 2;
}

__global__ void search_kernel(const int* __restrict__ src, const int* __restrict__ ref,
                              const int* __restrict__ ys, const int* __restrict__ xs,
                              const int* __restrict__ centers, int* __restrict__ out, int H, int W,
                              int Hr, int Wr, int ox, int n, int r, int scale) {
  extern __shared__ int smem[];
  const int S = n + 2 * r, D = 2 * r + 1, DD = D * D;
  int* sblk = smem;             // n x n
  int* win = sblk + n * n;      // S x S
  int* sad = win + S * S;       // D x D
  const int b = blockIdx.x;
  const int by = ys[b], bx = xs[b];
  const int cy = centers[2 * b], cx = centers[2 * b + 1];
  const int wy = by + cy - r, wx = bx + ox + cx - r;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int a = i / n, c = i - a * n;
    sblk[i] = src[(size_t)clampi(by + a, 0, H - 1) * W + clampi(bx + c, 0, W - 1)];
  }
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int a = i / S, c = i - a * S;
    win[i] = ref[(size_t)clampi(wy + a, 0, Hr - 1) * Wr + clampi(wx + c, 0, Wr - 1)];
  }
  for (int i = threadIdx.x; i < DD; i += blockDim.x) sad[i] = 0;
  __syncthreads();
  for (int it = threadIdx.x; it < DD * n; it += blockDim.x) {
    const int row = it / DD, d = it - row * DD;
    const int dy = d / D, dx = d - dy * D;
    const int* w = win + (dy + row) * S + dx;
    const int* s = sblk + row * n;
    int acc = 0;
    for (int c = 0; c < n; ++c) acc += abs(w[c] - s[c]);
    atomicAdd(&sad[d], acc);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned long long best = ~0ull;
    for (int d = threadIdx.x; d < DD; d += 32) {
      const int dy = d / D, dx = d - dy * D;
      const int v = sad[d] + (abs(dy - r) + abs(dx - r)) * scale;
      const unsigned long long key = ((unsigned long long)(unsigned)v << 32) | (unsigned)d;
      best = key < best ? key : best;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_down_sync(0xffffffffu, best, o);
      best = other < best ? other : best;
    }
    if (threadIdx.x == 0) {
      const int d = (int)(best & 0xffffffffu);
      out[2 * b] = cy + d / D - r;
      out[2 * b + 1] = cx + d % D - r;
    }
  }
}

__global__ void leaf_kernel(const int* __restrict__ src, const int* __restrict__ ref,
                            const int* __restrict__ centers, int* __restrict__ out, int B,
                            int sb_cols, int H, int W, int Hr, int Wr, int ox, int r) {
  extern __shared__ int smem[];
  const int S = 64 + 2 * r, D = 2 * r + 1, DD = D * D;
  int* sblk = smem;            // 64 x 64
  int* win = sblk + 64 * 64;   // S x S
  const int b = blockIdx.x, k = blockIdx.y;
  const int oy = (b / sb_cols) * 64, sx = (b % sb_cols) * 64;
  const int* c = centers + ((size_t)k * B + b) * 2;
  const int wy = oy + c[0] - r, wx = sx + ox + c[1] - r;
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int a = i >> 6, x = i & 63;
    sblk[i] = src[(size_t)clampi(oy + a, 0, H - 1) * W + clampi(sx + x, 0, W - 1)];
  }
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int a = i / S, x = i - a * S;
    win[i] = ref[(size_t)clampi(wy + a, 0, Hr - 1) * Wr + clampi(wx + x, 0, Wr - 1)];
  }
  __syncthreads();
  int* o = out + ((size_t)k * B + b) * 64 * DD;
  for (int it = threadIdx.x; it < 64 * DD; it += blockDim.x) {
    const int leaf = it / DD, d = it - leaf * DD;
    const int li = leaf >> 3, lj = leaf & 7;
    const int dy = d / D, dx = d - dy * D;
    const int* w = win + (8 * li + dy) * S + 8 * lj + dx;
    const int* s = sblk + (8 * li) * 64 + 8 * lj;
    int acc = 0;
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc += abs(w[a * S + x] - s[a * 64 + x]);
    o[it] = acc;
  }
}

}  // namespace

extern "C" int me_sad_launch(int mode, const int* src, const int* ref, const int* ys, const int* xs,
                             const int* centers, int* out, int B, int K, int H, int W, int Hr,
                             int Wr, int ox, int n, int r, int scale, int sb_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    const int outs = (H >> 1) * (W >> 1);
    if (outs == 0) return 0;
    decimate_kernel<<<(outs + 255) / 256, 256, 0, st>>>(src, out, H, W);
  } else if (mode == 1) {
    if (B == 0) return 0;
    const int S = n + 2 * r, D = 2 * r + 1;
    const size_t shm = (size_t)(n * n + S * S + D * D) * sizeof(int);
    search_kernel<<<B, 256, shm, st>>>(src, ref, ys, xs, centers, out, H, W, Hr, Wr, ox, n, r,
                                       scale);
  } else if (mode == 2) {
    if (B == 0 || K == 0) return 0;
    const int S = 64 + 2 * r;
    const size_t shm = (size_t)(64 * 64 + S * S) * sizeof(int);
    leaf_kernel<<<dim3(B, K), 256, shm, st>>>(src, ref, centers, out, B, sb_cols, H, W, Hr, Wr,
                                               ox, r);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}
