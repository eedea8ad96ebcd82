// MCTF (motion-compensated temporal filtering) kernels of the port.
//
// K12 tf_filter: the weighted temporal average of one plane. For each
// sample of the centre frame, a = centre and ws = 1; then for each of the K
// motion-compensated neighbours k in order: d = (the 5x5 edge-replicated
// window sum of the squared error pred_k - centre) / 25, w = exp(-d / h2),
// a += w * pred_k, ws += w. The output is clip(rint(a / ws), 0, 2^bd - 1),
// rint rounding half to even.
// Replaces svtav1_tpu/ops/tf_jax.py::_tf_jit.run's weighting and
// normalisation (:106-118, with _box5 at :49), which takes the window mean
// from a float32 summed-area table over the whole plane. Here the window sum
// is an exact int32 sum (at most 25 * 1023^2 < 2^31), divided by 25 in
// float32; every float32 step is an explicitly rounded intrinsic in the
// reference's order (no multiply-add contraction), and exp is computed in
// double and rounded once to float32, so the kernel equals its plain
// PyTorch version. Where the reference's float32 table is exact (planes
// small enough, as at the test sizes) the two agree.
// Bound: bytes. Each sample reads the centre and K predictions once and
// writes one output; the work is about 20 operations per sample and
// neighbour. Design: one thread per sample of a 32x8 tile; per neighbour the
// block stages the squared error of its (8+4)x(32+4) halo in shared memory
// (coordinates clamped to the plane), sums rows of five, then each thread
// sums its column of five row sums. The accumulators a and ws stay in
// registers across all K neighbours: one launch per plane.
//
// K13 tf_noise: the noise estimate's two exact sums over the interior
// samples of a plane: the sum of |Laplacian| (3x3 kernel 4, -2 at the four
// edges, 1 at the corners) over the flat samples, and their count, a sample
// being flat when |dx| + |dy| of its central differences is below the edge
// threshold. Replaces the sums of svtav1_tpu/ops/tf_jax.py::estimate_noise_j
// (:30-46), which adds float32 values in an order that changes the result
// once the sum passes 2^24 (a 1080p plane does); the division and the
// sqrt(pi/2)/6 scale stay with the caller, in float32 at the reference's
// points. Bound: bytes (one int32 read per sample; about 20 operations).
// Design: a grid-stride loop with int64 per-thread sums, a warp shuffle
// reduction, and one 64-bit atomic add per warp: integer sums are exact in
// any order.
#include "common.cuh"

namespace {

constexpr int TF_TX = 32, TF_TY = 8;

__global__ void tf_filter_kernel(const int* __restrict__ center, const int* __restrict__ preds,
                                 int* __restrict__ out, int K, int H, int W, float h2, int bd) {
  __shared__ int sq[TF_TY + 4][TF_TX + 4];
  __shared__ int rows[TF_TY + 4][TF_TX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TF_TX + tx;
  const int x0 = blockIdx.x * TF_TX, y0 = blockIdx.y * TF_TY;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const size_t plane = (size_t)H * W;
  const int c = inside ? center[(size_t)y * W + x] : 0;
  float a = (float)c, ws = 1.0f;
  for (int k = 0; k < K; ++k) {
    const int* P = preds + (size_t)k * plane;
    for (int i = tid; i < (TF_TY + 4) * (TF_TX + 4); i += TF_TX * TF_TY) {
      const int r = i / (TF_TX + 4), cc = i - r * (TF_TX + 4);
      const int gy = clampi(y0 + r - 2, 0, H - 1), gx = clampi(x0 + cc - 2, 0, W - 1);
      const size_t g = (size_t)gy * W + gx;
      const int d = P[g] - center[g];
      sq[r][cc] = d * d;
    }
    __syncthreads();
    for (int i = tid; i < (TF_TY + 4) * TF_TX; i += TF_TX * TF_TY) {
      const int r = i / TF_TX, cc = i - r * TF_TX;
      rows[r][cc] = sq[r][cc] + sq[r][cc + 1] + sq[r][cc + 2] + sq[r][cc + 3] + sq[r][cc + 4];
    }
    __syncthreads();
    if (inside) {
      const int s = rows[ty][tx] + rows[ty + 1][tx] + rows[ty + 2][tx] + rows[ty + 3][tx] +
                    rows[ty + 4][tx];
      const float d = __fdiv_rn((float)s, 25.0f);
      const float w = (float)exp((double)__fdiv_rn(-d, h2));
      a = __fadd_rn(a, __fmul_rn(w, (float)P[(size_t)y * W + x]));
      ws = __fadd_rn(ws, w);
    }
    __syncthreads();  // the next neighbour overwrites sq and rows
  }
  if (inside) out[(size_t)y * W + x] = clampi((int)rintf(__fdiv_rn(a, ws)), 0, (1 << bd) - 1);
}

__global__ void tf_noise_kernel(const int* __restrict__ y, long long* __restrict__ out, int H,
                                int W, int thr) {
  const int iw = W - 2;
  const long long n = (long long)(H - 2) * iw;
  long long s = 0, cnt = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / iw) + 1, c = (int)(i % iw) + 1;
    const int* p = y + (size_t)r * W + c;
    const int l = p[-1], rt = p[1], u = p[-W], d = p[W];
    const int lap = 4 * p[0] - 2 * (l + rt + u + d) + p[-W - 1] + p[-W + 1] + p[W - 1] + p[W + 1];
    const int g = abs(rt - l) + abs(d - u);
    if (g < thr) {
      s += abs(lap);
      cnt += 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd((unsigned long long*)&out[0], (unsigned long long)s);
    atomicAdd((unsigned long long*)&out[1], (unsigned long long)cnt);
  }
}

}  // namespace

extern "C" int tf_filter_launch(const int* center, const int* preds, int* out, int K, int H, int W,
                                float h2, int bd, void* stream) {
  if (H == 0 || W == 0) return 0;
  const dim3 block(TF_TX, TF_TY), grid((W + TF_TX - 1) / TF_TX, (H + TF_TY - 1) / TF_TY);
  tf_filter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(center, preds, out, K, H, W, h2, bd);
  return launch_status();
}

// out: two zeroed int64 (the |Laplacian| sum over flat samples, their count)
extern "C" int tf_noise_launch(const int* y, long long* out, int H, int W, int thr, void* stream) {
  if (H < 3 || W < 3) return 0;
  const long long n = (long long)(H - 2) * (W - 2);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  tf_noise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(y, out, H, W, thr);
  return launch_status();
}
