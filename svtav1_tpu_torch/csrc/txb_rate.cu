// K3 txb_rate: exact coefficient bits of a transform block from the CDF cost
// LUTs of one txb configuration: eob position and eob token, base-level
// contexts from the padded neighbour magnitudes, base_eob, br rounds,
// Golomb remainders, signs and the skip flag. Output float32 bits per block.
//
// Replaces svtav1_tpu/codec/rate_jax.py::make_txb_bits_fn -> fn (:127-191).
// The reference looks the tables up with one-hot matrix products because a
// TPU gathers slowly from tiny tables; here the float LUTs sit in shared
// memory and are indexed directly.
//
// Bound: bytes. Per block it reads h*w int32 levels and writes one float; the
// work per coefficient is a handful of neighbour loads from shared memory and
// two table lookups. Design: one block per txb; the tables (float costs, and
// the int maps: base_eob context, scan index, context offsets, br groups)
// and |levels| are staged in shared memory once, so the 5-neighbour context
// sums and every lookup are shared-memory reads; bits are summed per thread,
// then across the block. The float32 sum runs in another order than the
// reference's, so results agree to float32 rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int F_BASE = 0, F_BASE_EOB = 168, F_BR = 180, F_SKIP = 453, F_DCS = 455, F_EOB = 457;

__device__ __forceinline__ int pmag(const int* a, int r, int c, int h, int w, int log2w) {
  return (r < h && c < w) ? min(a[(r << log2w) + c], 127) : 0;
}

__global__ void txb_rate_kernel(const int* __restrict__ levels, const float* __restrict__ flut,
                                const int* __restrict__ ilut, float* __restrict__ out, int h,
                                int w, int log2w, int tx_class, int nflut) {
  extern __shared__ float smem[];
  const int n = h * w;
  float* fl = smem;
  int* absl = (int*)(smem + nflut);
  int* il = absl + n;
  __shared__ int s_eob, s_nnz;
  __shared__ float s_part[32];
  const int* L = levels + (size_t)blockIdx.x * n;
  const int* ectx = il;
  const int* iscan = il + n;
  const int* nz_off = il + 2 * n;
  const int* br_grp = il + 3 * n;
  if (threadIdx.x == 0) {
    s_eob = 0;
    s_nnz = 0;
  }
  for (int i = threadIdx.x; i < nflut; i += blockDim.x) fl[i] = flut[i];
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) il[i] = ilut[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) absl[i] = abs(L[i]);
  __syncthreads();
  int my_eob = 0, my_nnz = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (absl[i]) {
      my_eob = max(my_eob, iscan[i] + 1);
      ++my_nnz;
    }
  }
  if (my_nnz) {
    atomicMax(&s_eob, my_eob);
    atomicAdd(&s_nnz, my_nnz);
  }
  __syncthreads();
  const int eob = s_eob;
  float bits = 0.f;
  for (int pos = threadIdx.x; pos < n; pos += blockDim.x) {
    const int a = absl[pos];
    const int isc = iscan[pos];
    const int r = pos >> log2w, c = pos & (w - 1);
    if (eob > 0 && isc <= eob - 1) {
      int mag = min(pmag(absl, r, c + 1, h, w, log2w), 3) + min(pmag(absl, r + 1, c, h, w, log2w), 3);
      if (tx_class == 0) {
        mag += min(pmag(absl, r + 1, c + 1, h, w, log2w), 3) +
               min(pmag(absl, r, c + 2, h, w, log2w), 3) + min(pmag(absl, r + 2, c, h, w, log2w), 3);
      } else if (tx_class == 2) {
        mag += min(pmag(absl, r + 2, c, h, w, log2w), 3) + min(pmag(absl, r + 3, c, h, w, log2w), 3) +
               min(pmag(absl, r + 4, c, h, w, log2w), 3);
      } else {
        mag += min(pmag(absl, r, c + 2, h, w, log2w), 3) + min(pmag(absl, r, c + 3, h, w, log2w), 3) +
               min(pmag(absl, r, c + 4, h, w, log2w), 3);
      }
      int bctx = min((mag + 1) >> 1, 4) + nz_off[pos];
      if (tx_class == 0 && pos == 0) bctx = 0;
      const int sym = min(a, 3);
      if (isc < eob - 1) bits += fl[F_BASE + bctx * 4 + sym];
      else bits += fl[F_BASE_EOB + ectx[eob - 1] * 3 + max(sym - 1, 0)];
    }
    if (a > 2) {
      int magb = pmag(absl, r, c + 1, h, w, log2w) + pmag(absl, r + 1, c, h, w, log2w);
      if (tx_class == 0) magb += pmag(absl, r + 1, c + 1, h, w, log2w);
      else if (tx_class == 2) magb += pmag(absl, r + 2, c, h, w, log2w);
      else magb += pmag(absl, r, c + 2, h, w, log2w);
      const int brctx = min((magb + 1) >> 1, 6) + (pos == 0 ? 0 : br_grp[pos]);
      bits += fl[F_BR + brctx * 13 + min(a - 3, 12)];
    }
    if (a > 14) bits += 2.f * (float)(31 - __clz(a - 14) + 1) - 1.f;
  }
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
  const int warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) s_part[warp] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < nwarps; ++i) tot += s_part[i];
    if (eob == 0) {
      out[blockIdx.x] = fl[F_SKIP + 1];
    } else {
      tot += fl[F_EOB + eob];
      const int dc = L[0];
      const float nnz = (float)s_nnz;
      tot += dc != 0 ? fl[F_DCS + (dc < 0 ? 1 : 0)] + (nnz - 1.f) : nnz;
      out[blockIdx.x] = tot + fl[F_SKIP];
    }
  }
}

}  // namespace

extern "C" int txb_rate_launch(const int* levels, const float* flut, const int* ilut, float* out,
                               int B, int h, int w, int log2w, int tx_class, void* stream) {
  if (B == 0) return 0;
  const int n = h * w;
  const int nflut = F_EOB + n + 1;
  const int threads = n >= 256 ? 256 : 32;
  const size_t shm = (size_t)nflut * sizeof(float) + 5 * (size_t)n * sizeof(int);
  txb_rate_kernel<<<B, threads, shm, (cudaStream_t)stream>>>(levels, flut, ilut, out, h, w, log2w,
                                                            tx_class, nflut);
  return launch_status();
}
