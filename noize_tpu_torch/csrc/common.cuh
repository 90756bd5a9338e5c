// Shared helpers for the port's kernels.
//
// Arithmetic is written with the IEEE round-to-nearest intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn): the compiler
// never contracts them into FMAs, so every operation rounds on its own,
// in the order the JAX reference writes it (the library is also built
// with -fmad=false).
#pragma once

#include <cuda_runtime.h>

namespace noize {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float divf(float a, float b) { return __fdiv_rn(a, b); }

// max(x, 0) / min(x, 0) as selects: for non-NaN inputs these equal
// jnp.maximum / jnp.minimum and torch.clamp up to the sign of a zero.
__device__ __forceinline__ float relu(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float fmax2(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float fmin2(float a, float b) { return b < a ? b : a; }

inline dim3 grid2d(int cols, int rows, dim3 block) {
  return dim3((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
}

}  // namespace noize
