// K1 intra_pred: the seven non-directional AV1 intra predictors (DC, V, H,
// SMOOTH, SMOOTH_V, SMOOTH_H, PAETH) from filled edges.
//
// Replaces svtav1_tpu/pipeline/intra_device.py::_predict_modes (nmodes <= 7),
// which the decide calls for every block of a size at once and the commit
// wavefront calls per wave, predicting all modes and then selecting one lane.
//
// Bound: bytes. Each lane reads 2n+1 edge samples and writes n*n (one mode)
// or 7*n*n (all modes) int32 samples; the arithmetic is a few integer ops per
// sample. Design: one block per lane; the DC sums are taken once per block in
// shared memory; consecutive threads write consecutive output samples, so the
// stores (the bulk of the traffic) are coalesced. With `mode` given the kernel
// writes only the chosen mode, instead of predicting all seven and gathering.
// DC with no neighbour is 128 whatever the bit depth, exactly like the
// reference (intra_device.py:46).
#include "common.cuh"

__global__ void intra_pred_kernel(const int* __restrict__ above, const int* __restrict__ left,
                                  const int* __restrict__ tl, const uint8_t* __restrict__ have_above,
                                  const uint8_t* __restrict__ have_left, const int* __restrict__ mode,
                                  const int* __restrict__ weights, int* __restrict__ out, int n,
                                  int log2n) {
  const int b = blockIdx.x;
  const int* A = above + (size_t)b * n;
  const int* L = left + (size_t)b * n;
  __shared__ int s_dc;
  if (threadIdx.x == 0) {
    int sa = 0, sl = 0;
    for (int i = 0; i < n; ++i) {
      sa += A[i];
      sl += L[i];
    }
    const bool ha = have_above[b] != 0, hl = have_left[b] != 0;
    int dc = 128;
    if (ha && hl) dc = (sa + sl + n) >> (log2n + 1);
    else if (ha) dc = (sa + (n >> 1)) >> log2n;
    else if (hl) dc = (sl + (n >> 1)) >> log2n;
    s_dc = dc;
  }
  __syncthreads();
  const int nn = n * n;
  const int nm = mode ? 1 : 7;
  const int total = nm * nn;
  const int t_l = tl[b];
  const int below = L[n - 1], right = A[n - 1];
  int* o = out + (size_t)b * total;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int m = mode ? mode[b] : idx / nn;
    const int pix = idx - (mode ? 0 : m * nn);
    const int i = pix >> log2n, j = pix & (n - 1);
    const int t = A[j], l = L[i];
    const int wh = weights[i], ww = weights[j];
    int v;
    switch (m) {
      case 0: v = s_dc; break;
      case 1: v = t; break;
      case 2: v = l; break;
      case 3: v = (wh * t + (256 - wh) * below + ww * l + (256 - ww) * right + 256) >> 9; break;
      case 4: v = (wh * t + (256 - wh) * below + 128) >> 8; break;
      case 5: v = (ww * l + (256 - ww) * right + 128) >> 8; break;
      default: {
        const int base = t + l - t_l;
        const int pt = abs(base - t), pl = abs(base - l), ptl = abs(base - t_l);
        v = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : t_l);
      }
    }
    o[idx] = v;
  }
}

extern "C" int intra_pred_launch(const int* above, const int* left, const int* tl,
                                 const uint8_t* have_above, const uint8_t* have_left,
                                 const int* mode, const int* weights, int* out, int B, int n,
                                 int log2n, void* stream) {
  if (B == 0) return 0;
  const int threads = n * n >= 256 ? 256 : (n * n < 32 ? 32 : n * n);
  intra_pred_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(above, left, tl, have_above,
                                                             have_left, mode, weights, out, n,
                                                             log2n);
  return launch_status();
}
