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
// two table lookups. Design: a persistent grid (the CTAs that fit on the card
// at once, never more than the work needs) whose CTAs stage the tables (the
// float costs, and the int maps: base_eob context, scan index, context
// offsets, br groups) in shared memory once, then loop over transform blocks
// with one warp per block (or the whole CTA: `W`). A warp stages its
// block's |levels| in a zero-padded shared tile of its own with 16-byte loads
// (issued a block ahead; the neighbour contexts read min(|level|, 127) from
// it without bounds checks), takes the eob and the nonzero count with warp
// reductions, walks the scan only up to the eob (the positions past it are
// zero and cost nothing), sums the bits by shuffle, and lane 0 writes the
// epilogue (skip, eob, DC sign, nonzero count): no CTA barrier per block. The float32 sum runs in another order than the reference's, so
// results agree to float32 rounding, not bit for bit.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int F_BASE = 0, F_BASE_EOB = 168, F_BR = 180, F_SKIP = 453, F_DCS = 455, F_EOB = 457;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// A tile word packs a coefficient's min(|level|, 3) (bits 0-3), min(|level|,
// 127) (bits 4-12) and min(|level|, 2^19 - 1) (bits 13-31), so one sum of
// five neighbour words gives both context sums: at most 5 * 3 = 15 and
// 3 * 127 = 381, no carry crosses a field. A |level| that saturates the top
// field is read again from the levels. Tiles have row stride w + 4 and 4
// zero rows and columns past the block: no bounds checks.
__device__ __forceinline__ unsigned tile_word(int a) {
  return (unsigned)min(a, 3) | (unsigned)min(a, 127) << 4 | (unsigned)min(a, 0x7ffff) << 13;
}

// The sum over a group of GT threads: a half or a whole warp by shuffles
// (every lane of the warp takes part; each half sums its own), or the CTA
// through shared memory.
template <int GT, typename T, typename Op>
__device__ __forceinline__ T group_reduce(T v, Op op, T* part) {
#pragma unroll
  for (int o = (GT < 32 ? GT : 32) / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  if constexpr (GT > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = part[0];
#pragma unroll
    for (int i = 1; i < GT / 32; ++i) v = op(v, part[i]);
  }
  return v;
}

// GT threads per transform block: 16 (two blocks a warp, up to 8x8), 32 (a
// warp) or kThreads (the CTA); kThreads / GT blocks in flight per CTA.
template <int GT>
__global__ void __launch_bounds__(kThreads)
    txb_rate_kernel(const int* __restrict__ levels, const float* __restrict__ flut,
                    const int* __restrict__ ilut, float* __restrict__ out, int B, int h, int w,
                    int log2w, int tx_class, int nflut, bool vec) {
  constexpr int G = kThreads / GT;
  constexpr int NP = GT > 32 ? GT / 32 : 1;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_eob[NP], s_nnz[NP];
  __shared__ float s_bits[NP];
  const int n = h * w;
  const int tw = w + 4, tsize = (h + 4) * tw;
  float* fl = smem;
  int* ectx = (int*)(smem + ((nflut + 3) & ~3));  // 16-byte aligned
  int* iscan = ectx + n;
  // per scan index: tile offset (bits 0-10), nz_off (11-16), br group (17-20;
  // 0 at position 0), position (21-30), bit 31: the 2-D class's DC (context 0)
  unsigned* meta = (unsigned*)(iscan + n);
  unsigned* tiles = meta + n;
  const int g = threadIdx.x / GT, gt = threadIdx.x % GT;
  unsigned* tile = tiles + g * tsize;  // this group's tile
  for (int i = threadIdx.x; i < nflut; i += kThreads) fl[i] = __ldg(flut + i);
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) ectx[i] = __ldg(ilut + i);
  for (int pos = threadIdx.x; pos < n; pos += kThreads) {
    const int r = pos >> log2w, c = pos & (w - 1);
    meta[__ldg(ilut + n + pos)] = (unsigned)(r * tw + c) | (unsigned)__ldg(ilut + 2 * n + pos) << 11 |
                                  (unsigned)(pos ? __ldg(ilut + 3 * n + pos) : 0) << 17 |
                                  (unsigned)pos << 21 | (tx_class == 0 && pos == 0 ? 1u << 31 : 0u);
  }
  const int npad = 4 * (tw + h);  // the padding, zeroed once: rows h.., then columns w..
  for (int i = threadIdx.x; i < G * npad; i += kThreads) {
    const int k = i % npad, kc = k - 4 * tw;
    tiles[i / npad * tsize + (kc < 0 ? h * tw + k : kc / 4 * tw + w + kc % 4)] = 0;
  }
  // the five neighbours (the first three also give the br context)
  const int o3 = tx_class == 0 ? tw + 1 : tx_class == 2 ? 2 * tw : 2;
  const int o4 = tx_class == 0 ? 2 : tx_class == 2 ? 3 * tw : 3;
  const int o5 = tx_class == 0 ? 2 * tw : tx_class == 2 ? 4 * tw : 4;
  __syncthreads();

  // the blocks of one pass are blk = base + g; every lane of a warp runs
  // every pass (the shuffles need them all), past B as an empty block. Each
  // thread's first 16 bytes of the next pass are loaded a pass ahead.
  const int stride = gridDim.x * G;
  const auto first = [&](int b) {
    return vec && b < B && gt < n / 4 ? __ldg(reinterpret_cast<const int4*>(levels + (size_t)b * n) + gt)
                                      : make_int4(0, 0, 0, 0);
  };
  int4 ahead = first(blockIdx.x * G + g);
  for (int base = blockIdx.x * G; base < B; base += stride) {
    const int blk = base + g;
    const bool live = blk < B;
    const int* L = levels + (size_t)(live ? blk : 0) * n;
    const int4 v0 = ahead;
    ahead = first(blk + stride);
    int my_eob = 0, my_nnz = 0;
    if (live && vec) {
      for (int q = gt; q < n / 4; q += GT) {
        const int4 v = q == gt ? v0 : __ldg(reinterpret_cast<const int4*>(L) + q);
        const int av[4] = {abs(v.x), abs(v.y), abs(v.z), abs(v.w)};
        const int p0 = 4 * q;
        *reinterpret_cast<uint4*>(tile + (p0 >> log2w) * tw + (p0 & (w - 1))) =
            make_uint4(tile_word(av[0]), tile_word(av[1]), tile_word(av[2]), tile_word(av[3]));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (av[u]) {
            my_eob = max(my_eob, iscan[p0 + u] + 1);
            ++my_nnz;
          }
        }
      }
    } else if (live) {
      for (int i = gt; i < n; i += GT) {
        const int a = abs(__ldg(L + i));
        tile[(i >> log2w) * tw + (i & (w - 1))] = tile_word(a);
        if (a) {
          my_eob = max(my_eob, iscan[i] + 1);
          ++my_nnz;
        }
      }
    }
    const int eob = group_reduce<GT>(my_eob, [](int x, int y) { return max(x, y); }, s_eob);
    const int nnz = group_reduce<GT>(my_nnz, [](int x, int y) { return x + y; }, s_nnz);
    if constexpr (GT <= 32) __syncwarp();  // the tile is written
    // positions past the eob are zero and cost nothing: walk the scan up to it
    float bits = 0.f;
    const int eob_base = eob ? F_BASE_EOB + ectx[eob - 1] * 3 : 0;
    for (int i = gt; i < eob; i += GT) {
      const unsigned m = meta[i];
      const unsigned* tp = tile + (m & 0x7ff);
      const unsigned own = tp[0];
      const unsigned s3 = tp[1] + tp[tw] + tp[o3];
      const unsigned s5 = s3 + tp[o4] + tp[o5];
      const int sym = own & 15, a127 = (own >> 4) & 511;
      const int bctx = (m >> 31) ? 0 : min((int)((s5 & 15) + 1) >> 1, 4) + (int)((m >> 11) & 63);
      bits += fl[i < eob - 1 ? F_BASE + bctx * 4 + sym : eob_base + max(sym - 1, 0)];
      if (a127 > 2) {
        const int brctx = min((int)(((s3 >> 4) & 511) + 1) >> 1, 6) + (int)((m >> 17) & 15);
        bits += fl[F_BR + brctx * 13 + min(a127 - 3, 12)];
      }
      if (a127 > 14) {
        int a = own >> 13;
        if (a == 0x7ffff) a = abs(__ldg(L + ((m >> 21) & 1023)));
        bits += 2.f * (float)(31 - __clz(a - 14) + 1) - 1.f;
      }
    }
    bits = group_reduce<GT>(bits, [](float x, float y) { return x + y; }, s_bits);
    if (gt == 0 && live) {
      if (eob == 0) {
        out[blk] = fl[F_SKIP + 1];
      } else {
        float tot = bits + fl[F_EOB + eob];
        const int dc = vec ? v0.x : __ldg(L);
        const float fnnz = (float)nnz;
        tot += dc != 0 ? fl[F_DCS + (dc < 0 ? 1 : 0)] + (fnnz - 1.f) : fnnz;
        out[blk] = tot + fl[F_SKIP];
      }
    }
    if constexpr (GT > 32) __syncthreads(); else __syncwarp();  // before the tile is rewritten
  }
}

template <int GT>
struct TxbLaunch {
  static constexpr int G = kThreads / GT;
  static size_t shm(int h, int w) {
    const int n = h * w;
    return (size_t)((F_EOB + n + 1 + 3) & ~3) * sizeof(float) +
           (3 * (size_t)n + (size_t)G * (h + 4) * (w + 4)) * sizeof(int);
  }
  // the CTAs resident on the card at once for this block size, queried once
  static int resident(int h, int w) {
    static int ctas[11] = {0};
    const int l2n = 31 - __builtin_clz(h * w);
    if (ctas[l2n] == 0) {
      int dev = 0, sms = 0, occ = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaFuncSetAttribute(txb_rate_kernel<GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           100 * 1024);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, txb_rate_kernel<GT>, kThreads,
                                                    shm(h, w));
      ctas[l2n] = sms * occ;
    }
    return ctas[l2n];
  }
  static int run(const int* levels, const float* flut, const int* ilut, float* out, int B, int h,
                 int w, int log2w, int tx_class, cudaStream_t stream) {
    const int cap = resident(h, w);
    if (cap <= 0) {
      const int err = launch_status();
      return err ? err : (int)cudaErrorInvalidValue;
    }
    const bool vec = ((uintptr_t)levels & 15) == 0;
    txb_rate_kernel<GT><<<std::min(cap, (B + G - 1) / G), kThreads, shm(h, w), stream>>>(
        levels, flut, ilut, out, B, h, w, log2w, tx_class, F_EOB + h * w + 1, vec);
    return launch_status();
  }
};

}  // namespace

// group_threads: threads per transform block, 16, 32 or 256 (the CTA).
extern "C" int txb_rate_launch_group(const int* levels, const float* flut, const int* ilut,
                                     float* out, int B, int h, int w, int log2w, int tx_class,
                                     int group_threads, void* stream) {
  if (B == 0) return 0;
  const auto s = (cudaStream_t)stream;
  switch (group_threads) {
    case 16: return TxbLaunch<16>::run(levels, flut, ilut, out, B, h, w, log2w, tx_class, s);
    case 32: return TxbLaunch<32>::run(levels, flut, ilut, out, B, h, w, log2w, tx_class, s);
    case kThreads:
      return TxbLaunch<kThreads>::run(levels, flut, ilut, out, B, h, w, log2w, tx_class, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Half a warp per block up to 8x8, a warp above; at 32x32 a CTA per block
// when the launch has fewer than 1.5 blocks per warp the card holds (a warp
// walks up to 1,024 positions alone). chip_smoke.py's group sweep times the
// three on the main path's launch sizes.
extern "C" int txb_rate_launch(const int* levels, const float* flut, const int* ilut, float* out,
                               int B, int h, int w, int log2w, int tx_class, void* stream) {
  const int n = h * w;
  const int threads = n <= 64 ? 16
                      : n >= 1024 && 2 * B < 3 * TxbLaunch<32>::resident(h, w) * (kThreads / 32)
                          ? kThreads
                          : 32;
  return txb_rate_launch_group(levels, flut, ilut, out, B, h, w, log2w, tx_class, threads, stream);
}
