// K10 — the fBm heightmap (every noise basis), all octaves of a cell in one
// launch.
//
// Not a TPU kernel's port: the reference's fBm (noize_tpu/ops/fractal.py:106-155
// with noize_tpu/ops/noise.py's bases) is plain JAX, which XLA fused into
// loops on the TPU.  The port's plain version (ops/fractal.fractal_window_plain)
// runs each octave as ~170 separate PyTorch elementwise passes over the whole
// map, some 2,200 launches for 13 Simplex octaves.
//
// Bound: operations.  A Simplex octave is ~170 float32 operations a cell (the
// counts a basis are ops/cuda/fractal.OPS_PER_OCTAVE, taken from the functions
// below); the output, 4 bytes a cell, is written once and nothing is read.
//
// Design: one thread a cell, through every octave in registers; the octave
// table (f, a), the norm and the origins come from the host (the same float32
// recurrence as the plain version) in one by-value struct.  A template over
// the basis gives one instantiation a basis, so the octave loop carries no
// branch on it.  The cells of a stack of T tiles ([T, rows, cols], one origin
// a tile) are one launch; offsets are 64-bit.
//
// Bit-equality with the plain version on the card: every multiply and add is
// an explicit __f*_rn in the plain version's order (the library is also built
// with -fmad=false); every constant is the float32 rounding of the Python
// literal the plain version multiplies by (noise.cuh names each, and
// tests/test_torch_fractal_kernel.py checks them); floorf, fabsf and fmodf
// are exact; cellular's roots are __fsqrt_rn, as ops/f32.sqrt; the clamps,
// minima and maxima are selects (no NaN reaches them from finite inputs); and
// sinf and cosf are the functions torch.sin and torch.cos call on the card
// (test_k10_sin_cos_match_torch).
#include <cuda_runtime.h>

#include "common.cuh"
#include "noise.cuh"

constexpr int kMaxOctaves = 32;  // _cuda.MAX_OCTAVES

// One call's constants, passed by value (outside the unnamed namespace: the C
// entry's parameter needs external linkage).
struct NoizeFractal {
  int basis;                 // index in ops/fractal.NOISE_TYPES
  int octaves;               // 0 .. kMaxOctaves
  long long tiles;           // T (1 for a single tile)
  int rows, cols, row0, col0;
  float inv_size;            // f32(1) / f32(noise_size)
  float x0, z0;              // the origin when no origin array is given
  float acc;                 // the norm: sum of G^i, i < octaves
  float f[kMaxOctaves], a[kMaxOctaves];
};

namespace {

using noize::add;
using noize::mul;

constexpr int kBases = 8;
constexpr int kThreads = 256;  // threads a block, one cell a thread, every basis

template <int B>
__global__ void __launch_bounds__(kThreads)
fractal(float* __restrict__ out, const float* __restrict__ origins,
        const __grid_constant__ NoizeFractal p) {
  const long long plane = static_cast<long long>(p.rows) * p.cols;
  const long long total = plane * p.tiles;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long tile = e / plane;
    const long long rem = e - tile * plane;
    const int r = static_cast<int>(rem / p.cols);
    const int c = static_cast<int>(rem - static_cast<long long>(r) * p.cols);
    float xpos = p.x0, zpos = p.z0;
    if (origins != nullptr) {
      xpos = origins[2 * tile];
      zpos = origins[2 * tile + 1];
    }
    // (col + xpos) * inv_size, (row + zpos) * inv_size; the grid coordinates
    // are exact float32 integers, as torch.arange's
    const float xi = mul(add(static_cast<float>(p.col0 + c), xpos), p.inv_size);
    const float zi = mul(add(static_cast<float>(p.row0 + r), zpos), p.inv_size);
    out[e] = noize::noise::fbm<B>(xi, zi, p.f, p.a, p.octaves, p.acc);
  }
}

template <int B>
cudaError_t launch(float* out, const float* origins, const NoizeFractal& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.rows) * p.cols * p.tiles;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < (1 << 30) ? blocks : (1 << 30));
  fractal<B><<<grid, kThreads, 0, stream>>>(out, origins, p);
  return cudaGetLastError();
}

__global__ void sin_cos(const float* x, float* sin_out, float* cos_out, long long n) {
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; k < n;
       k += static_cast<long long>(gridDim.x) * blockDim.x) {
    sin_out[k] = sinf(x[k]);
    cos_out[k] = cosf(x[k]);
  }
}

}  // namespace

// out: f32[tiles, rows, cols] device memory, contiguous.  origins: f32[tiles,
// 2] (xpos, zpos) device memory, or null for one tile at (p.x0, p.z0).
extern "C" int noize_fractal(float* out, const float* origins, NoizeFractal p,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (p.basis < 0 || p.basis >= kBases || p.octaves < 0 || p.octaves > kMaxOctaves ||
      p.tiles < 0 || p.rows < 0 || p.cols < 0 || (origins == nullptr && p.tiles > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(p.rows) * p.cols * p.tiles == 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaError_t err = cudaSuccess;
  switch (p.basis) {
    case 0: err = launch<0>(out, origins, p, stream); break;
    case 1: err = launch<1>(out, origins, p, stream); break;
    case 2: err = launch<2>(out, origins, p, stream); break;
    case 3: err = launch<3>(out, origins, p, stream); break;
    case 4: err = launch<4>(out, origins, p, stream); break;
    case 5: err = launch<5>(out, origins, p, stream); break;
    case 6: err = launch<6>(out, origins, p, stream); break;
    default: err = launch<7>(out, origins, p, stream); break;
  }
  return static_cast<int>(err);
}

// x, sin_out, cos_out: f32[n] device memory (sinf and cosf as K10 compiles
// them, for the card test against torch.sin and torch.cos).
extern "C" int noize_sin_cos(const float* x, float* sin_out, float* cos_out, long long n,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + 255) / 256;
  sin_cos<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(x, sin_out,
                                                                               cos_out, n);
  return static_cast<int>(cudaGetLastError());
}
