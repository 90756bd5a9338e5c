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

// A 4-byte asynchronous copy from device to shared memory (cp.async); the
// destination is zero-filled where !valid.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// Waits for every cp.async the thread issued (a barrier must follow before
// other threads read what they wrote).
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Walks the items (line, chunk) of a block's work with one division: item
// it is line it % n, chunk it / n, and a thread's items are blockDim.x
// apart, so neighbouring threads take neighbouring lines.
struct Items {
  int line, chunk, step_line, step_chunk, n;
  __device__ __forceinline__ explicit Items(int lines)
      : line(threadIdx.x % lines), chunk(threadIdx.x / lines),
        step_line(blockDim.x % lines), step_chunk(blockDim.x / lines), n(lines) {}
  __device__ __forceinline__ void next() {
    line += step_line;
    chunk += step_chunk;
    if (line >= n) {
      line -= n;
      ++chunk;
    }
  }
};

}  // namespace noize
