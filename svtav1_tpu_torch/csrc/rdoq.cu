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
// neighbours and a few table lookups. Design: one CTA per txb; the magnitudes
// and the per-scan-position gains live in shared memory; the float32
// arithmetic follows the reference's order of operations with explicitly
// rounded intrinsics (no contraction into fused multiply-adds), so the
// result is bit-identical to the plain PyTorch version. The suffix sums run
// in float64 in one thread, in the plain version's order, over the positions
// before the original eob only; the argmin is a first-index-wins reduction.
// The block body is rdoq_block (rdoq.cuh), which K16 (commit.cu) runs for
// the commit's intra blocks.
#include "rdoq.cuh"

namespace {

__global__ void rdoq_kernel(const int* __restrict__ levels, const int* __restrict__ coeff,
                            const float* __restrict__ flut, const int* __restrict__ ilut,
                            const int* __restrict__ scan, int* __restrict__ out, int h, int w,
                            int log2w, int ls, int dq_dc, int dq_ac, float lam, float dscale,
                            float skip_delta) {
  extern __shared__ int smem[];
  const int n = h * w;
  const size_t at = (size_t)blockIdx.x * n;
  rdoq_block(levels + at, coeff + at, flut, ilut, scan, out + at, h, w, log2w, ls, dq_dc, dq_ac,
             lam, dscale, skip_delta, smem, (float*)(smem + n));
}

}  // namespace

extern "C" int rdoq_launch(const int* levels, const int* coeff, const float* flut, const int* ilut,
                           const int* scan, int* out, int B, int h, int w, int log2w, int ls,
                           int dq_dc, int dq_ac, float lam, float dscale, float skip_delta,
                           void* stream) {
  if (B == 0) return 0;
  const int n = h * w;
  const int threads = n >= 256 ? 256 : 32;
  const size_t shm = (size_t)n * sizeof(int) + (size_t)(n + 1) * sizeof(float);
  rdoq_kernel<<<B, threads, shm, (cudaStream_t)stream>>>(levels, coeff, flut, ilut, scan, out, h,
                                                         w, log2w, ls, dq_dc, dq_ac, lam, dscale,
                                                         skip_delta);
  return launch_status();
}
