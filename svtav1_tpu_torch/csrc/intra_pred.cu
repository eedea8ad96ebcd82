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
// and weights them (32 - shift, shift). DC with no neighbour is
// 1 << (bd - 1), as the spec predicts it; the reference keeps 128 at every
// bit depth (intra_device.py:46), a fault at 10 bits (ROADMAP queue 3).
// The block body is intra_pred_block (intra_pred.cuh), which K16
// (commit.cu) runs for the commit's intra blocks.
#include "intra_pred.cuh"

namespace {

__global__ void intra_pred_kernel(const int* __restrict__ above, const int* __restrict__ left,
                                  const int* __restrict__ tl, const uint8_t* __restrict__ have_above,
                                  const uint8_t* __restrict__ have_left, const int* __restrict__ mode,
                                  const int* __restrict__ weights, const int* __restrict__ dr,
                                  int* __restrict__ out, int n, int log2n, int nmodes, int bd) {
  const int b = blockIdx.x;
  const int nm = mode ? 1 : nmodes;
  intra_pred_block(above + (size_t)b * n, left + (size_t)b * n, tl[b], have_above[b] != 0,
                   have_left[b] != 0, mode ? mode[b] : -1, weights, dr,
                   out + (size_t)b * nm * n * n, n, log2n, nmodes, bd);
}

}  // namespace

extern "C" int intra_pred_launch(const int* above, const int* left, const int* tl,
                                 const uint8_t* have_above, const uint8_t* have_left,
                                 const int* mode, const int* weights, const int* dr, int* out,
                                 int B, int n, int log2n, int nmodes, int bd, void* stream) {
  if (B == 0) return 0;
  const int threads = n * n >= 256 ? 256 : (n * n < 32 ? 32 : n * n);
  intra_pred_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(above, left, tl, have_above,
                                                             have_left, mode, weights, dr, out, n,
                                                             log2n, nmodes, bd);
  return launch_status();
}
