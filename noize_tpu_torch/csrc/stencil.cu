// K1 — iterated separable stencil chain (the Gauss-5 x17 blur).
//
// Replaces: noize_tpu/ops/pallas/stencil.py:fused_separable_chain_rows
// (entry gauss_chain).  Computes `iterations` x (X pass, flipped Z pass) of
// an edge-clamped correlation, i.e. kernels.separable_series iterated.
//
// Bound: device memory.  Each pass reads and writes the map once and does
// k multiply-adds per cell (k = 5 on the flagship), far below the card's
// compute; at 2048^2 a pass moves 32 MB.
//
// Design: one thread per output cell, one launch per pass, ping-pong
// between the output and one scratch map (2 * iterations launches).  The
// clamped index reads reproduce the TPU kernel's per-iteration edge
// re-clamp (`_fixup`) for free, and each cell sums tap 0 first, in the
// order kernels.conv_x / conv_z do, so the result is bit-equal to the plain
// version.  Neighbouring threads read neighbouring addresses; the k-fold
// reuse is left to L1/L2.  The tap loop is unrolled to the maximum width
// so every tap index is a compile-time constant and the taps stay in the
// kernel's parameter space (a runtime index put them in local memory).
// Keeping several iterations on chip (the TPU kernel's halo trick) is
// later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 25;

struct Taps {
  float t[kMaxTaps];
};

// out[z, x] = sum_i taps[i] * a[z, clamp(x - off + i)]
__global__ void conv_x_kernel(const float* __restrict__ a, float* __restrict__ out,
                              int rows, int cols, Taps taps, int k) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || z >= rows) return;
  const int off = (k - 1) / 2;
  const float* row = a + (size_t)z * cols;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < k) {
      const int xi = noize::clampi(x - off + i, 0, cols - 1);
      acc = noize::add(acc, noize::mul(taps.t[i], row[xi]));
    }
  }
  out[(size_t)z * cols + x] = acc;
}

// out[z, x] = sum_i taps[i] * a[clamp(z + off - i), x]   (flipped Z pass,
// KernelOperators.cs:58-65 / kernels.conv_z)
__global__ void conv_z_kernel(const float* __restrict__ a, float* __restrict__ out,
                              int rows, int cols, Taps taps, int k) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || z >= rows) return;
  const int off = (k - 1) / 2;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < k) {
      const int zi = noize::clampi(z + off - i, 0, rows - 1);
      acc = noize::add(acc, noize::mul(taps.t[i], a[(size_t)zi * cols + x]));
    }
  }
  out[(size_t)z * cols + x] = acc;
}

}  // namespace

extern "C" int noize_separable_chain(const float* x, float* out, float* tmp,
                                     int rows, int cols, const float* taps_host,
                                     int k, int iterations, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxTaps || k % 2 == 0 || rows < 1 || cols < 1 || iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int i = 0; i < kMaxTaps; ++i) taps.t[i] = i < k ? taps_host[i] : 0.0f;
  if (iterations == 0) {
    cudaMemcpyAsync(out, x, sizeof(float) * (size_t)rows * cols,
                    cudaMemcpyDeviceToDevice, stream);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(32, 8);
  const dim3 grid = noize::grid2d(cols, rows, block);
  const float* src = x;
  for (int it = 0; it < iterations; ++it) {
    conv_x_kernel<<<grid, block, 0, stream>>>(src, tmp, rows, cols, taps, k);
    conv_z_kernel<<<grid, block, 0, stream>>>(tmp, out, rows, cols, taps, k);
    src = out;
  }
  return static_cast<int>(cudaGetLastError());
}
