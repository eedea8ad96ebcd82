// K1 intra_pred: the thirteen key-frame AV1 intra predictors from filled
// edges: DC, V, H, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, and the six directional
// modes D45, D135, D113, D157, D203, D67 (zero angle delta, no edge filter or
// upsampling) from edges extended by replicating their last sample.
//
// Replaces svtav1_tpu/pipeline/intra_device.py::_predict_modes with
// svtav1_tpu/ops/intra.py::dr_pred for the directional modes, which the
// decide calls for every block of a size at once and the commit wavefront
// calls per wave, predicting all modes and then selecting one lane.
//
// Bound: bytes. Each lane reads 2n+1 edge samples and writes n*n (one mode)
// or nmodes*n*n (all modes) int32 samples; the arithmetic is a few integer
// ops per sample. Design: one block per lane; the DC sums are taken once per
// block in shared memory; consecutive threads write consecutive output
// samples, so the stores (the bulk of the traffic) are coalesced. With `mode`
// given the kernel writes only the chosen mode, instead of predicting all of
// them and gathering. The reference's device branch of dr_pred multiplies the
// edges by a constant float32 matrix (a TPU workaround, exact only because
// its sums stay below 2^24); here each sample gathers its two taps directly
// and weights them (32 - shift, shift). DC with no neighbour is 128 whatever
// the bit depth, exactly like the reference (intra_device.py:46).
#include "common.cuh"

namespace {

// Extended edge sample k in [-1, 2n-1]: -1 is the top-left sample, indices
// past the edge repeat its last sample (intra_device.py:80-81).
__device__ __forceinline__ int ext(const int* E, int tl, int k, int n) {
  return k < 0 ? tl : E[min(k, n - 1)];
}

// One directional sample at (i, j); dr = (dx, dy, zone) of the mode
// (ops/intra.py dr_tables: zone 1 above only, zone 3 left only, zone 2 both).
__device__ __forceinline__ int dr_sample(const int* A, const int* L, int tl, int n, const int* dr,
                                         int i, int j) {
  const int dx = dr[0], dy = dr[1], zone = dr[2];
  int v;
  if (zone == 1) {
    const int x = (i + 1) * dx, base = (x >> 6) + j, sh = (x & 0x3F) >> 1;
    v = ext(A, tl, base, n) * (32 - sh) + ext(A, tl, base + 1, n) * sh;
  } else if (zone == 3) {
    const int y = (j + 1) * dy, base = (y >> 6) + i, sh = (y & 0x3F) >> 1;
    v = ext(L, tl, base, n) * (32 - sh) + ext(L, tl, base + 1, n) * sh;
  } else {
    const int x = -(i + 1) * dx, base = (x >> 6) + j;
    if (base >= -1) {
      const int sh = (x & 0x3F) >> 1;
      v = ext(A, tl, base, n) * (32 - sh) + ext(A, tl, base + 1, n) * sh;
    } else {
      const int y = (i << 6) - (j + 1) * dy, b2 = y >> 6, sh = (y & 0x3F) >> 1;
      v = ext(L, tl, b2, n) * (32 - sh) + ext(L, tl, b2 + 1, n) * sh;
    }
  }
  return (v + 16) >> 5;
}

__global__ void intra_pred_kernel(const int* __restrict__ above, const int* __restrict__ left,
                                  const int* __restrict__ tl, const uint8_t* __restrict__ have_above,
                                  const uint8_t* __restrict__ have_left, const int* __restrict__ mode,
                                  const int* __restrict__ weights, const int* __restrict__ dr,
                                  int* __restrict__ out, int n, int log2n, int nmodes) {
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
  const int nm = mode ? 1 : nmodes;
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
      case 6: {
        const int base = t + l - t_l;
        const int pt = abs(base - t), pl = abs(base - l), ptl = abs(base - t_l);
        v = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : t_l);
        break;
      }
      default: v = dr_sample(A, L, t_l, n, dr + 3 * (m - 7), i, j);
    }
    o[idx] = v;
  }
}

}  // namespace

extern "C" int intra_pred_launch(const int* above, const int* left, const int* tl,
                                 const uint8_t* have_above, const uint8_t* have_left,
                                 const int* mode, const int* weights, const int* dr, int* out,
                                 int B, int n, int log2n, int nmodes, void* stream) {
  if (B == 0) return 0;
  const int threads = n * n >= 256 ? 256 : (n * n < 32 ? 32 : n * n);
  intra_pred_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(above, left, tl, have_above,
                                                             have_left, mode, weights, dr, out, n,
                                                             log2n, nmodes);
  return launch_status();
}
