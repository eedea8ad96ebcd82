// Shared helpers of the port's CUDA kernels (plain C interface, ctypes-bound).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Return code of every *_launch entry point: 0, or the cudaError_t of the
// launch (a refused launch never runs, so the wrapper must see this).
static inline int launch_status() { return (int)cudaGetLastError(); }

// Before a launch with `bytes` of dynamic shared memory: the kernel's limit
// raised where that is above the 48 KB default. 0, or the cudaError_t.
template <typename Kernel>
static inline int allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// int32 arithmetic that wraps like the JAX reference's int32 ops (XLA wraps;
// signed overflow is undefined in C++, so multiply-add through uint32).
__device__ __forceinline__ int wrap_mad2(int a, int wa, int b, int wb, int rnd) {
  return (int)((unsigned)a * (unsigned)wa + (unsigned)b * (unsigned)wb + (unsigned)rnd);
}

// Flags between the CTAs of one launch (K12, K16): loads and stores at gpu scope.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until *flag == want: relaxed polls (an acquire load at gpu scope
// also invalidates the SM's L1, which every spinning warp would do on every
// poll), then one acquire. A flag that is not set within 2^24 polls (some
// seconds; K16's commit and K12's table take milliseconds) is a fault of the
// caller or of the kernel: trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void wait_flag(const int* flag, int want) {
  for (int i = 0; ld_relaxed(flag) != want; ++i)
    if (i == 1 << 24) __trap();
  ld_acquire(flag);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int round_shift(int x, int bit) {
  return bit == 0 ? x : (int)((unsigned)x + (1u << (bit - 1))) >> bit;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// round_shift_array's shift: > 0 rounds right, < 0 shifts left
__device__ __forceinline__ int apply_shift(int x, int bit) {
  if (bit > 0) return round_shift(x, bit);
  if (bit < 0) return (int)((unsigned)x << (-bit));
  return x;
}

// K2's dead-zone quantizer, levels clipped to +-32767 (K2 and K16)
__device__ __forceinline__ int quant_level(int x, int dq, int ls) {
  const int absc = (int)((unsigned)abs(x) << ls);
  const int lv = floordiv((int)((unsigned)absc + (unsigned)(dq >> 1)), dq);
  return clampi(x > 0 ? lv : (x < 0 ? -lv : 0), -32767, 32767);
}

// dequantized level; |d| <= dqmax = 2^(bd+7) - 1, within the bd + 8 clamp
__device__ __forceinline__ int dequant_level(int lv, int dq, int ls, int dqmax) {
  const int d = min((abs(lv) * dq) >> ls, dqmax);
  return lv > 0 ? d : (lv < 0 ? -d : 0);
}
