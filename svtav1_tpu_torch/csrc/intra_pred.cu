// K1 intra_pred: the thirteen key-frame AV1 intra predictors from filled
// edges: DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, and the six directional
// modes D45, D135, D113, D157, D203, D67 (zero angle delta, no edge filter or
// upsampling) from edges extended by replicating their last sample.
//
// Replaces svtav1_tpu/pipeline/intra_device.py::_predict_modes with
// svtav1_tpu/ops/intra.py::dr_pred for the directional modes, which the
// decide calls for every block of a size at once (all modes of a frame's
// luma blocks; U and V, one mode per lane) and the TPL calls for its probe.
//
// Bound: bytes. Each lane reads 2n+1 edge samples and writes n*n (one mode)
// or nmodes*n*n (all modes) int32 samples; the arithmetic is a few integer
// ops per sample, so the stores are the traffic. Design: a 256-thread CTA
// holds several blocks, a quad (4 samples of a row) per thread and mode: 4
// threads per 4x4 block, 16 per 8x8, a warp per 16x16, the CTA from 32x32.
// The CTA stages its blocks' edges once with 16-byte loads; every warp (or
// each block's part of one) sums a block's whole edge itself (a warp
// reduction), so the DC costs no barrier. The modes are the outer loop, a
// compile-time constant inside it (no division, no switch per sample; the
// smooth weights and the directional (dx, dy, zone) staged once), and each
// thread writes its quad as one 16-byte store. With `mode` given the kernel
// writes only the chosen mode. The per-sample formulas are
// intra_pred_sample and intra_dr_sample (intra_pred.cuh), which K16
// (commit.cu) runs too. The reference's device branch of dr_pred multiplies
// the edges by a constant float32 matrix (a TPU workaround, exact only
// because its sums stay below 2^24); here each sample gathers its two taps
// directly and weights them (32 - shift, shift). DC with no neighbour is
// 1 << (bd - 1), as the spec predicts it; the reference keeps 128 at every
// bit depth (intra_device.py:46), a fault at 10 bits (ROADMAP queue 3).
#include "intra_pred.cuh"

namespace {

constexpr int K1_THREADS = 256;

// Threads per n x n block: a quad each up to a warp, the CTA from 32x32.
__host__ __device__ constexpr int k1_group(int n) {
  return n >= 32 ? K1_THREADS : (n * n / 4 < 32 ? n * n / 4 : 32);
}

// Mode M's quads of one block (M 7: the directional mode whose (dx, dy,
// zone) is d): thread t of the block's G threads writes quads t, t + G, ...
template <int M>
__device__ __forceinline__ void predict_quads(int* o, const int* A, const int* L, int t_l, int dc,
                                              const int* wts, const int* d, int n, int log2n,
                                              int t, int G, bool store) {
  const int nq = (n * n) >> 2, qrow = log2n - 2;
  for (int q = t; q < nq; q += G) {
    const int i = q >> qrow, j = (q & ((n >> 2) - 1)) << 2;
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if constexpr (M < 7)
        v[u] = intra_pred_sample(A, L, t_l, dc, M, wts, nullptr, n, i, j + u);
      else
        v[u] = intra_dr_sample(A, L, t_l, n, d, i, j + u);
    if (store) *reinterpret_cast<int4*>(o + (q << 2)) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void predict_mode(int m, int* o, const int* A, const int* L, int t_l,
                                             int dc, const int* wts, const int* dr, int n,
                                             int log2n, int t, int G, bool store) {
  switch (m) {
    case 0: predict_quads<0>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 1: predict_quads<1>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 2: predict_quads<2>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 3: predict_quads<3>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 4: predict_quads<4>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 5: predict_quads<5>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    case 6: predict_quads<6>(o, A, L, t_l, dc, wts, dr, n, log2n, t, G, store); return;
    default: {  // directional: the mode's (dx, dy, zone) in registers
      const int d[3] = {dr[3 * (m - 7)], dr[3 * (m - 7) + 1], dr[3 * (m - 7) + 2]};
      predict_quads<7>(o, A, L, t_l, dc, wts, d, n, log2n, t, G, store);
    }
  }
}

// Blocks [blockIdx.x * nb, + nb) with nb = K1_THREADS / k1_group(n). `vec`:
// above and left are 16-byte aligned; out always is.
__global__ void __launch_bounds__(K1_THREADS)
    intra_pred_kernel(const int* __restrict__ above, const int* __restrict__ left,
                      const int* __restrict__ tl, const uint8_t* __restrict__ have_above,
                      const uint8_t* __restrict__ have_left, const int* __restrict__ mode,
                      const int* __restrict__ weights, const int* __restrict__ dr,
                      int* __restrict__ out, int B, int n, int log2n, int nmodes, int bd,
                      bool vec) {
  __shared__ __align__(16) int sA[256], sL[256];  // nb * n <= 256 edge samples each
  __shared__ int s_w[64], s_dr[18];
  const int G = k1_group(n), nb = K1_THREADS / G;
  const int b0 = blockIdx.x * nb;
  const int cnt = min(nb, B - b0) * n;
  const int* ga = above + (size_t)b0 * n;
  const int* gl = left + (size_t)b0 * n;
  if (vec) {
    for (int k = threadIdx.x; k < cnt / 4; k += K1_THREADS) {
      reinterpret_cast<int4*>(sA)[k] = __ldg(reinterpret_cast<const int4*>(ga) + k);
      reinterpret_cast<int4*>(sL)[k] = __ldg(reinterpret_cast<const int4*>(gl) + k);
    }
  } else {
    for (int k = threadIdx.x; k < cnt; k += K1_THREADS) {
      sA[k] = __ldg(ga + k);
      sL[k] = __ldg(gl + k);
    }
  }
  if (threadIdx.x < n) s_w[threadIdx.x] = __ldg(weights + threadIdx.x);
  if (threadIdx.x < 18) s_dr[threadIdx.x] = __ldg(dr + threadIdx.x);
  __syncthreads();

  const int t = threadIdx.x % G;
  const bool valid = b0 + (int)threadIdx.x / G < B;
  const int bl = valid ? threadIdx.x / G : B - 1 - b0;  // a tail's idle threads redo the last block
  const int b = b0 + bl;
  const int* A = sA + bl * n;
  const int* L = sL + bl * n;
  // the DC: a warp, or a block's part of one (W threads), sums the whole edge
  const int W = G < 32 ? G : 32, w = threadIdx.x % W;
  int sa = 0, sl = 0;
  for (int k = w; k < n; k += W) {
    sa += A[k];
    sl += L[k];
  }
  if (W == 32) {
    sa = (int)__reduce_add_sync(0xffffffffu, (unsigned)sa);
    sl = (int)__reduce_add_sync(0xffffffffu, (unsigned)sl);
  } else {
    for (int o = W >> 1; o > 0; o >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sl += __shfl_xor_sync(0xffffffffu, sl, o);
    }
  }
  const int dc = intra_dc(sa, sl, __ldg(have_above + b) != 0, __ldg(have_left + b) != 0, n,
                          log2n, bd);
  const int t_l = __ldg(tl + b);
  const int nm = mode ? 1 : nmodes;
  int* o = out + (size_t)b * nm * n * n;
  for (int mi = 0; mi < nm; ++mi)
    predict_mode(mode ? __ldg(mode + b) : mi, o + (size_t)mi * n * n, A, L, t_l, dc, s_w, s_dr,
                 n, log2n, t, G, valid);
}

}  // namespace

extern "C" int intra_pred_launch(const int* above, const int* left, const int* tl,
                                 const uint8_t* have_above, const uint8_t* have_left,
                                 const int* mode, const int* weights, const int* dr, int* out,
                                 int B, int n, int log2n, int nmodes, int bd, void* stream) {
  if (B == 0) return 0;
  if (n < 4 || n > 64 || (1 << log2n) != n || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const bool vec = (((uintptr_t)above | (uintptr_t)left) & 15) == 0;
  const int nb = K1_THREADS / k1_group(n);
  intra_pred_kernel<<<(B + nb - 1) / nb, K1_THREADS, 0, (cudaStream_t)stream>>>(
      above, left, tl, have_above, have_left, mode, weights, dr, out, B, n, log2n, nmodes, bd,
      vec);
  return launch_status();
}
