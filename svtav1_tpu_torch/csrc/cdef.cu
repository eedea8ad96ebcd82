// K6 cdef_dir and K7 cdef_filter: CDEF (AV1 spec 7.15) on whole frames.
//
// K6 gives, per 8x8 luma cell, the normative direction (the first of the
// eight with the largest cost) and the variance (best cost minus the cost of
// the orthogonal direction, >> 10). Replaces
// svtav1_tpu/filters/cdef_jax.py::find_dir_j (:26-65), which keeps each cost
// as a split (hi, lo) int32 pair because a TPU has no int64; here the costs
// are int64. Bound: bytes (64 int32 samples read per cell, two written; the
// 8 x 15 partial sums are some 1,000 integer operations per cell). Design:
// one thread per cell, the cell's samples in registers.
//
// K7 filters one plane with a direction per cell (8x8 luma, 4x4 chroma,
// co-located with the luma cells), a primary strength per frame that is
// adjusted per cell by the luma variance when `var` is given, a secondary
// strength and a damping; cells outside the non-skip mask keep their input.
// Several strength candidates run in one launch (grid.y = candidate x
// frame), and instead of (or beside) the filtered plane the kernel can give
// the int64 SSE of the masked filtered samples against a source plane, per
// candidate and frame: the frame-level strength search. Replaces
// cdef_jax.py::_tap_stack_j (:129-163), _filter_from_taps_j (:166-191) and
// _adjust_strength_j (:68-72) as cdef_frames_j (:203-284) chains them. The
// reference shifts the whole padded plane for all eight directions and
// selects per pixel (a TPU workaround for dynamic gathers); here each sample
// reads its twelve taps directly. Samples outside the plane are
// CDEF_VERY_LARGE, which never wins the max. Bound: bytes (each candidate
// reads the plane, writes it or reduces it; 12 taps per sample come from the
// L1 cache). Design: one thread per sample, consecutive threads on
// consecutive samples of a row; the SSE is reduced per block in shared
// memory and added with one 64-bit atomic per block.
#include "common.cuh"

namespace {

constexpr int CDEF_VERY_LARGE = 0x7F7F;

// Cdef_Directions (spec 7.15.3): (dy, dx) per direction and tap k = 0, 1.
__constant__ int c_dirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
__constant__ int c_pri_taps[2][2] = {{4, 2}, {3, 3}};
__constant__ int c_sec_taps[2] = {2, 1};
// find_dir cost weights per direction and partial-sum bin (filters/cdef.py
// _cost_weights)
__constant__ int c_cw[8][15] = {
    {840, 420, 280, 210, 168, 140, 120, 105, 120, 140, 168, 210, 280, 420, 840},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {105, 105, 105, 105, 105, 105, 105, 105, 0, 0, 0, 0, 0, 0, 0},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {840, 420, 280, 210, 168, 140, 120, 105, 120, 140, 168, 210, 280, 420, 840},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0},
    {105, 105, 105, 105, 105, 105, 105, 105, 0, 0, 0, 0, 0, 0, 0},
    {420, 210, 140, 105, 105, 105, 105, 105, 140, 210, 420, 0, 0, 0, 0}};

__device__ __forceinline__ int msb(int v) { return v > 0 ? 31 - __clz(v) : 0; }

// Partial-sum bin of sample (i, j) for direction d (filters/cdef.py
// _partial_matrices).
__device__ __forceinline__ int bin(int d, int i, int j) {
  switch (d) {
    case 0: return i + j;
    case 1: return i + (j >> 1);
    case 2: return i;
    case 3: return 3 + i - (j >> 1);
    case 4: return 7 + i - j;
    case 5: return 3 - (i >> 1) + j;
    case 6: return j;
    default: return (i >> 1) + j;
  }
}

__global__ void cdef_dir_kernel(const int* __restrict__ plane, int* __restrict__ dirs,
                                int* __restrict__ var, int F, int H, int W, int coeff_shift) {
  const int R = H >> 3, C = W >> 3;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= F * R * C) return;
  const int f = cell / (R * C), rc = cell - f * R * C;
  const int r = rc / C, c = rc - r * C;
  const int* P = plane + ((size_t)f * H + r * 8) * W + c * 8;
  int x[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[i * 8 + j] = (P[(size_t)i * W + j] >> coeff_shift) - 128;
  long long cost[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    int part[15];
#pragma unroll
    for (int k = 0; k < 15; ++k) part[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[bin(d, i, j)] += x[i * 8 + j];
    long long s = 0;
#pragma unroll
    for (int k = 0; k < 15; ++k) s += (long long)part[k] * part[k] * c_cw[d][k];
    cost[d] = s;
  }
  int best = 0;
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost[d] > cost[best]) best = d;
  dirs[cell] = best;
  var[cell] = (int)((cost[best] - cost[(best + 4) & 7]) >> 10);
}

__device__ __forceinline__ int constrain(int diff, int s, int damping) {
  if (s <= 0) return 0;
  const int shift = max(0, damping - msb(s));
  const int ad = abs(diff);
  const int mag = min(ad, max(0, s - (ad >> shift)));
  return diff < 0 ? -mag : mag;
}

__global__ void cdef_filter_kernel(const int* __restrict__ plane, const int* __restrict__ dirs,
                                   const int* __restrict__ var, const int* __restrict__ pri,
                                   const int* __restrict__ sec, const uint8_t* __restrict__ mask,
                                   const int* __restrict__ src, unsigned long long* __restrict__ sse,
                                   int* __restrict__ out, int F, int H, int W, int log2m,
                                   int damping, int coeff_shift) {
  __shared__ unsigned long long s_part[32];
  const int kf = blockIdx.y;  // candidate * F + frame
  const int f = kf % F;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long e = 0;
  if (p < H * W) {
    const int y = p / W, x = p - y * W;
    const int C = W >> log2m;
    const int ci = (size_t)f * (H >> log2m) * C + (y >> log2m) * C + (x >> log2m);
    const int* P = plane + (size_t)f * H * W;
    const int x0 = P[p];
    int v = x0;
    if (mask[ci]) {
      const int d = dirs[ci];
      int ps = pri[kf];
      if (var) {  // luma: adjust_strength by the cell's variance
        const int vv = var[ci];
        const int i = (vv >> 6) > 0 ? min(msb(vv >> 6), 12) : 0;
        ps = vv != 0 ? (ps * (4 + i) + 8) >> 4 : 0;
      }
      const int ss = sec[kf];
      const int ts = (ps >> coeff_shift) & 1;
      int sum = 0, mx = x0, mn = x0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {  // primary, then the two secondary directions
          const int dd = t == 0 ? d : (t == 1 ? (d + 2) & 7 : (d - 2) & 7);
          const int dy = c_dirs[dd][k][0], dx = c_dirs[dd][k][1];
#pragma unroll
          for (int sg = 1; sg >= -1; sg -= 2) {
            const int yy = y + sg * dy, xx = x + sg * dx;
            const int tv = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? P[yy * W + xx]
                                                                     : CDEF_VERY_LARGE;
            if (t == 0) sum += c_pri_taps[ts][k] * constrain(tv - x0, ps, damping);
            else sum += c_sec_taps[k] * constrain(tv - x0, ss, damping);
            if (tv != CDEF_VERY_LARGE) mx = max(mx, tv);
            mn = min(mn, tv);
          }
        }
      }
      v = clampi(x0 + ((8 + sum - (sum < 0)) >> 4), mn, mx);
      if (src) {
        const long long df = v - src[(size_t)f * H * W + p];
        e = (unsigned long long)(df * df);
      }
    }
    if (out) out[(size_t)kf * H * W + p] = v;
  }
  if (sse) {
    for (int o = 16; o > 0; o >>= 1) e += __shfl_down_sync(0xffffffffu, e, o);
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = e;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long tot = 0;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i) tot += s_part[i];
      if (tot) atomicAdd(sse + kf, tot);
    }
  }
}

}  // namespace

extern "C" int cdef_dir_launch(const int* plane, int* dirs, int* var, int F, int H, int W,
                               int coeff_shift, void* stream) {
  const int cells = F * (H >> 3) * (W >> 3);
  if (cells == 0) return 0;
  cdef_dir_kernel<<<(cells + 127) / 128, 128, 0, (cudaStream_t)stream>>>(plane, dirs, var, F, H,
                                                                       W, coeff_shift);
  return launch_status();
}

extern "C" int cdef_filter_launch(const int* plane, const int* dirs, const int* var,
                                  const int* pri, const int* sec, const uint8_t* mask,
                                  const int* src, unsigned long long* sse, int* out, int K, int F,
                                  int H, int W, int log2m, int damping, int coeff_shift,
                                  void* stream) {
  if (K * F * H * W == 0) return 0;
  const dim3 grid((H * W + 255) / 256, K * F);
  cdef_filter_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      plane, dirs, var, pri, sec, mask, src, sse, out, F, H, W, log2m, damping, coeff_shift);
  return launch_status();
}
