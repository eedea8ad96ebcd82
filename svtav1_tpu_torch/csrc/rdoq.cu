// K5 rdoq: two-pass rate-distortion optimized quantization of transform
// blocks (TX_CLASS_2D, DCT scan) from the same CDF cost LUTs as K3.
//   pass 1: the gain of zeroing each coefficient (distortion delta against
//     its own frozen-context bits), suffix sums in reverse scan order over
//     the positions before the original eob, and the argmin over every new
//     eob (0 = skip) of the truncated block's score;
//   pass 2: with contexts refreshed from the truncated levels, each level
//     drops by one where that lowers distortion + lambda * bits (the eob
//     position prices its base symbol from the base_eob table and may not
//     drop to zero).
// Signs are kept where a level survives.
//
// Replaces svtav1_tpu/codec/rate_jax.py::make_rdoq_fn -> fn (:300-403), which
// the commit runs between quant and dequant on luma and chroma
// (device_commit.py:308-336). The reference looks its tables up with one-hot
// matrix products (_pick2, a TPU workaround); here they are indexed directly.
//
// Bound: bytes. Per block it reads 2*h*w int32 (levels, coefficients) and
// writes h*w; per coefficient the work is two context sums over five
// neighbours and a few table lookups. Design: one CTA per txb, one warp
// below 16x16 and eight from 16x16 up, running the block body rdoq_tile
// (rdoq.cuh), which K16 (commit.cu) runs with one warp for the commit's
// intra blocks; the magnitudes and the per-scan-position gains live in
// shared memory; the float32 arithmetic follows the reference's order of
// operations with explicitly rounded intrinsics (no contraction into fused
// multiply-adds), so the result is bit-identical to the plain PyTorch
// version. The suffix sums run in float64 in the plain version's order,
// over the positions before the original eob only, in warp 0, one lane's
// segment of gains at a time from registers; eob0 and the argmin (first
// index wins) are warp reductions, then across the warps.
#include "rdoq.cuh"

namespace {

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    rdoq_kernel(const int* __restrict__ levels, const int* __restrict__ coeff,
                const float* __restrict__ flut, const int* __restrict__ ilut,
                const int* __restrict__ scan, int* __restrict__ out, int h, int w, int log2w,
                int ls, int dq_dc, int dq_ac, float lam, float dscale, float skip_delta) {
  extern __shared__ __align__(16) int smem[];
  const int n = h * w;
  const size_t at = (size_t)blockIdx.x * n;
  rdoq_tile<WARPS>(levels + at, coeff + at, flut, ilut, scan, out + at, h, w, log2w, ls, dq_dc,
                   dq_ac, lam, dscale, skip_delta, smem, (float*)(smem + n));
}

}  // namespace

extern "C" int rdoq_launch(const int* levels, const int* coeff, const float* flut, const int* ilut,
                           const int* scan, int* out, int B, int h, int w, int log2w, int ls,
                           int dq_dc, int dq_ac, float lam, float dscale, float skip_delta,
                           void* stream) {
  if (B == 0) return 0;
  const int n = h * w;
  // the magnitudes (n ints), then the gains (max(n + 1, 32) floats; n is a
  // multiple of 16, so they start 16-byte aligned)
  const size_t shm = (size_t)n * sizeof(int) + (size_t)(n + 32) * sizeof(float);
  const auto s = (cudaStream_t)stream;
  if (n >= 256)
    rdoq_kernel<8><<<B, 256, shm, s>>>(levels, coeff, flut, ilut, scan, out, h, w, log2w, ls,
                                       dq_dc, dq_ac, lam, dscale, skip_delta);
  else
    rdoq_kernel<1><<<B, 32, shm, s>>>(levels, coeff, flut, ilut, scan, out, h, w, log2w, ls,
                                      dq_dc, dq_ac, lam, dscale, skip_delta);
  return launch_status();
}
