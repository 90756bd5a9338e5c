// K1 — iterated separable stencil chain (the Gauss-5 x17 blur, and every
// KernelFilterStage filter: Gauss, Smooth3, Sobel, Prewitt).
//
// Replaces: noize_tpu/ops/pallas/stencil.py:fused_separable_chain_rows
// (entry gauss_chain) and fused_separable_chain.  Computes `iterations` x
// (X pass with taps tx, flipped Z pass with taps tz) of an edge-clamped
// correlation, each pass's sum multiplied by `factor` after the sum, i.e.
// kernels.separable_series(a, tx, tz, factor) iterated.  The two tap lists
// share one length K (the wrapper centres a shorter list in zeros).
//
// Bound: the float32 issue rate.  A pass does k multiplies and k adds a
// cell (k = 5 on the flagship), each its own instruction (-fmad=false), so
// at 2048^2 the 34 passes count 1.43e9 operations (0.043 ms at 33.5e12 a
// second) against 8 bytes a cell in and out (0.010 ms): chip_smoke.py
// computes both.  The design this replaces ran one launch a pass, each
// moving the whole map through device memory, with a tap loop unrolled to
// 25 under a runtime guard.
//
// Design: temporal blocking, as the TPU kernels keep a block for several
// iterations.  The wrapper's plan (ops/cuda/stencil.chain_plan) splits the
// iterations into launches of m; each block loads its output tile with an
// off*m halo on both axes into shared memory (cp.async, all in flight at
// once) and runs the m iterations there, ping-ponging between two window
// buffers.  Pass j along an axis
// leaves exact the cells at least j*off from the window's edge on that
// axis; after the m-th Z pass that is the tile, which goes straight to
// device memory.  Each pass reads clamped to the range exact before it,
// which on a window that holds the grid's edge is the reference's
// per-iteration edge clamp (the TPU kernel's `_fixup`), and elsewhere never
// binds for a cell that is computed.  The tap count is a template
// parameter (every odd k in 1..25); a thread loads kSeg + k - 1 values
// along its row (X pass) or column (Z pass) into registers and computes
// kSeg outputs from them, summing tap 0 first as kernels.conv_x / conv_z
// do, so the result is bit-equal to the plain version.  Window rows have
// an odd pitch, so a warp walking 32 rows in the X pass hits 32 banks.
// Launches ping-pong between `out` and `tmp`, the last writing `out`.
//
// A stack of `batch` maps (parallel/tiled's [T, R, C] tiles) runs in the
// same launches as one map: the map index is blockIdx.z, every pointer is
// offset to its map, and every clamp above is on the map's own rows and
// columns, so no block reads another map's cells.  `tmp` is a stack too.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::Items;

constexpr int kMaxTaps = 25;
constexpr int kSeg = 8;  // outputs a thread computes from one register window

struct Taps {
  float x[kMaxTaps];  // X-pass taps
  float z[kMaxTaps];  // Z-pass taps (applied flipped)
  float factor;       // each pass's sum times this (skipped at 1, which is exact)
};

// First and last window index (0-based, of a window of `len` cells that
// starts at grid index `base`) still exact after j passes of half-width off.
__device__ __forceinline__ int lo_after(int base, int j, int off) {
  return max(0, base + j * off) - base;
}
__device__ __forceinline__ int hi_after(int base, int len, int n, int j, int off) {
  return min(n - 1, base + len - 1 - j * off) - base;
}

// v[q] = line[clamp(start + q, lo, hi) * stride] for the kSeg + K - 1 values
// a chunk reads; the clamp only where the chunk reaches past [lo, hi].
template <int K>
__device__ __forceinline__ void load_window(const float* line, int stride, int start, int lo,
                                            int hi, float (&v)[kSeg + K - 1]) {
  if (start >= lo && start + kSeg + K - 2 <= hi) {
#pragma unroll
    for (int q = 0; q < kSeg + K - 1; ++q) v[q] = line[(start + q) * stride];
  } else {
#pragma unroll
    for (int q = 0; q < kSeg + K - 1; ++q) {
      v[q] = line[noize::clampi(start + q, lo, hi) * stride];
    }
  }
}

// conv_x on window rows [zlo, zhi], columns [xlo, xhi]; reads clamp to
// columns [rlo, rhi].  out[z, x] = sum_i t[i] * a[z, x - off + i].
template <int K>
__device__ __forceinline__ void pass_x(const float* src, int p, float* dst, long long doff,
                                       int dpitch, int zlo, int zhi, int xlo, int xhi,
                                       int rlo, int rhi, const float (&t)[K], float factor) {
  constexpr int off = (K - 1) / 2;
  const int nr = zhi - zlo + 1;
  const int chunks = (xhi - xlo + kSeg) / kSeg;
  for (Items it(nr); it.chunk < chunks; it.next()) {
    const int r = zlo + it.line;
    const int xs = xlo + it.chunk * kSeg;
    float v[kSeg + K - 1];
    load_window<K>(src + r * p, 1, xs - off, rlo, rhi, v);
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = noize::add(acc, noize::mul(t[i], v[s + i]));
      if (factor != 1.0f) acc = noize::mul(acc, factor);
      if (xs + s <= xhi) dst[doff + (long long)r * dpitch + xs + s] = acc;
    }
  }
}

// conv_z (flipped taps, KernelOperators.cs:58-65) on window rows
// [zlo, zhi], columns [xlo, xhi]; reads clamp to rows [rlo, rhi].
// out[z, x] = sum_i t[i] * a[z + off - i, x].
template <int K>
__device__ __forceinline__ void pass_z(const float* src, int p, float* dst, long long doff,
                                       int dpitch, int zlo, int zhi, int xlo, int xhi,
                                       int rlo, int rhi, const float (&t)[K], float factor) {
  constexpr int off = (K - 1) / 2;
  const int nc = xhi - xlo + 1;
  const int chunks = (zhi - zlo + kSeg) / kSeg;
  for (Items it(nc); it.chunk < chunks; it.next()) {
    const int c = xlo + it.line;
    const int zs = zlo + it.chunk * kSeg;
    float v[kSeg + K - 1];
    load_window<K>(src + c, p, zs - off, rlo, rhi, v);
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = noize::add(acc, noize::mul(t[i], v[s + 2 * off - i]));
      if (factor != 1.0f) acc = noize::mul(acc, factor);
      if (zs + s <= zhi) dst[doff + (long long)(zs + s) * dpitch + c] = acc;
    }
  }
}

// m iterations on one tz x tx output tile; the window is the tile with an
// off*m halo, two buffers of rz rows at pitch p in dynamic shared memory.
template <int K>
__global__ void chain_tile(const float* __restrict__ in, float* __restrict__ out, int rows,
                           int cols, Taps taps, int m, int tz, int tx) {
  constexpr int off = (K - 1) / 2;
  extern __shared__ float window[];
  in += (size_t)blockIdx.z * rows * cols;  // this block's map of the stack
  out += (size_t)blockIdx.z * rows * cols;
  float t[K], u[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    t[i] = taps.x[i];
    u[i] = taps.z[i];
  }
  const float factor = taps.factor;
  const int h = off * m;
  const int rz = tz + 2 * h, rx = tx + 2 * h, p = rx | 1;
  const int z0 = blockIdx.y * tz - h, x0 = blockIdx.x * tx - h;
  float* a = window;
  float* b = window + rz * p;

  // the window's cells on the grid; the others are never read
  const int zl = lo_after(z0, 0, off), zh = hi_after(z0, rz, rows, 0, off);
  const int xl = lo_after(x0, 0, off), xh = hi_after(x0, rx, cols, 0, off);
  const int nx = xh - xl + 1;
  for (int i = threadIdx.x; i < (zh - zl + 1) * nx; i += blockDim.x) {
    const int r = zl + i / nx, c = xl + i % nx;
    noize::copy_async(a + r * p + c, in + (size_t)(z0 + r) * cols + (x0 + c), true);
  }
  noize::copy_async_wait();
  __syncthreads();

  for (int j = 1; j <= m; ++j) {
    const int zlp = lo_after(z0, j - 1, off), zhp = hi_after(z0, rz, rows, j - 1, off);
    const int xlp = lo_after(x0, j - 1, off), xhp = hi_after(x0, rx, cols, j - 1, off);
    const int zlj = lo_after(z0, j, off), zhj = hi_after(z0, rz, rows, j, off);
    const int xlj = lo_after(x0, j, off), xhj = hi_after(x0, rx, cols, j, off);
    pass_x<K>(a, p, b, 0, p, zlp, zhp, xlj, xhj, xlp, xhp, t, factor);
    __syncthreads();
    if (j < m) {
      pass_z<K>(b, p, a, 0, p, zlj, zhj, xlj, xhj, zlp, zhp, u, factor);
      __syncthreads();
    } else {  // the tile itself: straight to device memory
      pass_z<K>(b, p, out, (long long)z0 * cols + x0, cols, zlj, zhj, xlj, xhj, zlp, zhp, u,
                factor);
    }
  }
}

template <int K>
size_t window_bytes(int m, int tz, int tx) {
  const int h = (K - 1) / 2 * m;
  return 2 * sizeof(float) * (size_t)(tz + 2 * h) * ((tx + 2 * h) | 1);
}

// Lets chain_tile<K> take up to the device's opt-in shared memory; set
// once per device.
template <int K>
cudaError_t configure(int* optin) {
  static bool done[64] = {};
  static int limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) {
    *optin = limit[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_tile<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  if (err == cudaSuccess && dev < 64) {
    done[dev] = true;
    limit[dev] = *optin;
  }
  return err;
}

template <int K>
int run_chain(const float* x, float* out, float* tmp, int rows, int cols, int batch,
              const Taps& taps, const int* per_launch, int launches, int tz, int tx,
              int threads, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err = configure<K>(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cols + tx - 1) / tx, (rows + tz - 1) / tz, batch);
  const float* src = x;
  for (int i = 0; i < launches; ++i) {
    const int m = per_launch[i];
    const size_t bytes = window_bytes<K>(m, tz, tx);
    if (m < 1 || bytes > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : tmp;
    chain_tile<K><<<grid, threads, bytes, stream>>>(src, dst, rows, cols, taps, m, tz, tx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x, out, tmp: `batch` rows x cols maps each, one after another;
// taps_x_host, taps_z_host (host float[k]): the X- and Z-pass taps;
// per_launch (host int[launches]): iterations of each launch, in order;
// no launch copies x.  tmp: a second stack, read only when launches > 1.
extern "C" int noize_separable_chain(const float* x, float* out, float* tmp, int rows, int cols,
                                     int batch, const float* taps_x_host,
                                     const float* taps_z_host, int k, float factor,
                                     const int* per_launch, int launches, int tile_z, int tile_x,
                                     int threads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxTaps || k % 2 == 0 || rows < 1 || cols < 1 || batch < 1 ||
      batch > 65535 || launches < 0 || tile_z < 1 || tile_x < 1 || threads < 32 ||
      threads > 1024 || threads % 32 || (launches > 1 && tmp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (launches == 0) {
    cudaMemcpyAsync(out, x, sizeof(float) * (size_t)batch * rows * cols,
                    cudaMemcpyDeviceToDevice, stream);
    return static_cast<int>(cudaGetLastError());
  }
  Taps taps;
  for (int i = 0; i < kMaxTaps; ++i) {
    taps.x[i] = i < k ? taps_x_host[i] : 0.0f;
    taps.z[i] = i < k ? taps_z_host[i] : 0.0f;
  }
  taps.factor = factor;
  switch (k) {
#define NOIZE_CHAIN_CASE(K)                                                                  \
  case K:                                                                                    \
    return run_chain<K>(x, out, tmp, rows, cols, batch, taps, per_launch, launches, tile_z, \
                        tile_x, threads, stream);
    NOIZE_CHAIN_CASE(1) NOIZE_CHAIN_CASE(3) NOIZE_CHAIN_CASE(5) NOIZE_CHAIN_CASE(7)
    NOIZE_CHAIN_CASE(9) NOIZE_CHAIN_CASE(11) NOIZE_CHAIN_CASE(13) NOIZE_CHAIN_CASE(15)
    NOIZE_CHAIN_CASE(17) NOIZE_CHAIN_CASE(19) NOIZE_CHAIN_CASE(21) NOIZE_CHAIN_CASE(23)
    NOIZE_CHAIN_CASE(25)
#undef NOIZE_CHAIN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
