// Shared helpers of the port's CUDA kernels (plain C interface, ctypes-bound).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Return code of every *_launch entry point: 0, or the cudaError_t of the
// launch (a refused launch never runs, so the wrapper must see this).
static inline int launch_status() { return (int)cudaGetLastError(); }

// int32 arithmetic that wraps like the JAX reference's int32 ops (XLA wraps;
// signed overflow is undefined in C++, so multiply-add through uint32).
__device__ __forceinline__ int wrap_mad2(int a, int wa, int b, int wb, int rnd) {
  return (int)((unsigned)a * (unsigned)wa + (unsigned)b * (unsigned)wb + (unsigned)rnd);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int round_shift(int x, int bit) {
  return bit == 0 ? x : (int)((unsigned)x + (1u << (bit - 1))) >> bit;
}
