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

#include <cstdint>

#include "common.cuh"

constexpr int kShortMaxTaps = 17;  // K1@short: off <= 8
constexpr int kRssMaxTaps = 9;     // K1@rss

// One K1@short or K1@rss call's constants (the wrapper's NoizeSeries,
// made once a chain; outside the anonymous namespace, since the C entry
// takes it): the X and Z taps of the series (K1@rss: of the H
// series) and, for K1@rss, of the V series; each pass's factor (K1@short).
struct NoizeSeries {
  float hx[kShortMaxTaps], hz[kShortMaxTaps], vx[kShortMaxTaps], vz[kShortMaxTaps];
  float factor;
  int k, iterations, tile_z, tile_x, threads, strip, rss;
};

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

// ---------------------------------------------------------------------------
// K1@short and K1@rss: short chains on small resident tiles.
//
// A chain whose total halo off*m is small (every KernelFilterStage call of
// the BasicDemo presets: one iteration of a 3-tap filter, Gauss3_S1 x3,
// Gauss9_S1 x2; the wrapper's plan routes by off*m) needs none of
// chain_tile's temporal blocking, and chain_tile's 128^2 tile with two
// window buffers (136-167 KB at these chains) holds one block an SM that
// loads, waits, then computes.  K1@short takes a small tile (the wrapper's
// short_plan: 32 x 256 at one iteration, 64 x 64 at more) with its off*m
// halo in one window buffer, two when m > 1 (35-51 KB), so 4-6 blocks
// share an SM and one block's loads overlap another's arithmetic.  The
// window loads with 16-byte cp.async where the grid's rows start on
// 16-byte boundaries (cols % 4 == 0), cell by cell at the ragged ends;
// cells off the grid are never loaded nor read.
//
// The last (at m = 1 the only) iteration is one pass over the window with
// no intermediate buffer: each thread walks a column strip down its rows,
// computes the X pass of each row it needs from the window, keeps the last
// K of them in a register ring and sums the flipped Z pass from the ring
// into device memory (a warp stores 32 neighbouring cells).  At m > 1 the
// iterations before it run as chain_tile's do (pass_x, pass_z through the
// second buffer; a thread computes kSeg outputs from one register window,
// independent sums that hide the adds' latency, which a column walk's one
// chain a row does not).  The arithmetic is chain_tile's: each sum from 0
// with tap 0 first, the factor after the sum (skipped at 1), reads clamped
// to the cells exact after the previous iteration (lo_after / hi_after:
// the reference's per-iteration edge clamp where the window holds the
// grid's edge), so the result is bit-equal to the plain version.
//
// K1@rss is the same pass with two series (Sobel3_2D's or edge_2d's H and
// V taps) read from one window, two rings, and sqrt(h*h + v*v) stored as
// __fsqrt_rn(__fadd_rn(__fmul_rn(h, h), __fmul_rn(v, v))): a correctly
// rounded float32 root, which the plain version's float64 root rounded to
// float32 equals bit for bit (double rounding through binary64 is
// innocuous for binary32).  One launch replaces two K1 calls and the plain
// version's six elementwise operations.
//
// Bound: bytes, 8 a cell (each cell read once and written once; 0.010 ms
// at 2048^2); the 4K multiplies and adds a cell (8K for K1@rss) are far
// below the float32 issue rate at these K.

// A K1@short window of halo h starts `lead` floats past a 16-byte boundary
// (its first column, blockIdx.x * tx - h with tx % 4 == 0, is -h mod 4 past
// a multiple of 4 on the grid), at a row pitch of whole 16-byte units.
__host__ __device__ __forceinline__ int short_lead(int h) { return (4 - (h & 3)) & 3; }
__host__ __device__ __forceinline__ int short_pitch(int h, int tx) {
  return (short_lead(h) + tx + 2 * h + 3) & ~3;
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Starts and waits for the copies of the window's cells on the grid
// (window rows [zl, zh], columns [xl, xh]) into a: a[r * p + c] is window
// cell (r, c), and a - lead lies on a 16-byte boundary, so the 4-cell unit
// u of a row, window columns 4u - lead .. 4u - lead + 3, is one 16-byte
// copy where all four cells are on the grid and `vec`.
__device__ __forceinline__ void load_short_window(const float* in, int cols, int z0, int x0,
                                                  float* a, int p, int lead, int zl, int zh,
                                                  int xl, int xh, bool vec) {
  const int units = p >> 2;
  const int n = (zh - zl + 1) * units;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = zl + i / units;
    const int c = ((i % units) << 2) - lead;
    const long long g = (long long)(z0 + r) * cols + x0 + c;
    if (vec && c >= xl && c + 3 <= xh) {
      copy16(a + r * p + c, in + g);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c + q >= xl && c + q <= xh) noize::copy_async(a + r * p + c + q, in + g + q, true);
      }
    }
  }
  noize::copy_async_wait();
}

template <int K>
struct Coef {
  float hx[K], hz[K], vx[K], vz[K];
  float factor;
};

// One row's X pass at the clamped columns ci: sum_i t[i] * row[ci[i]], tap
// 0 first, times the factor unless it is 1.
template <int K>
__device__ __forceinline__ float x_sum(const float* row, const int (&ci)[K], const float (&t)[K],
                                       float factor) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) acc = noize::add(acc, noize::mul(t[i], row[ci[i]]));
  return factor != 1.0f ? noize::mul(acc, factor) : acc;
}

// The flipped Z pass from a ring of X-pass rows (ring[K - 1] the newest,
// row z + off): sum_i u[i] * X[z + off - i].
template <int K>
__device__ __forceinline__ float z_sum(const float (&ring)[K], const float (&u)[K], float factor) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) acc = noize::add(acc, noize::mul(u[i], ring[K - 1 - i]));
  return factor != 1.0f ? noize::mul(acc, factor) : acc;
}

template <int K>
__device__ __forceinline__ void push(float (&ring)[K], float v) {
#pragma unroll
  for (int i = 0; i + 1 < K; ++i) ring[i] = ring[i + 1];
  ring[K - 1] = v;
}

// One iteration on window rows [zlo, zhi], columns [xlo, xhi], reading src
// (pitch p) clamped to rows [rlo, rhi] and columns [clo, chi]; writes
// dst[doff + r * dpitch + c].  Work items are (column, strip of `strip`
// rows), neighbouring threads on neighbouring columns: a warp's shared
// loads and its stores each touch 32 neighbouring cells.
template <int K, bool kRss>
__device__ __forceinline__ void short_pass(const float* src, int p, float* dst, long long doff,
                                           int dpitch, int zlo, int zhi, int xlo, int xhi,
                                           int rlo, int rhi, int clo, int chi,
                                           const Coef<K>& co, int strip) {
  constexpr int off = (K - 1) / 2;
  const int nc = xhi - xlo + 1;
  const int strips = (zhi - zlo + strip) / strip;
  const float f = kRss ? 1.0f : co.factor;
  for (Items it(nc); it.chunk < strips; it.next()) {
    const int c = xlo + it.line;
    const int r0 = zlo + it.chunk * strip;
    const int r1 = min(zhi, r0 + strip - 1);
    int ci[K];
#pragma unroll
    for (int i = 0; i < K; ++i) ci[i] = noize::clampi(c - off + i, clo, chi);
    float hr[K], vr[K];
#pragma unroll
    for (int i = 0; i + 1 < K; ++i) {  // rows r0 - off .. r0 + off - 1
      const float* row = src + noize::clampi(r0 - off + i, rlo, rhi) * p;
      hr[i + 1] = x_sum<K>(row, ci, co.hx, f);
      if (kRss) vr[i + 1] = x_sum<K>(row, ci, co.vx, 1.0f);
    }
    for (int r = r0; r <= r1; ++r) {
      const float* row = src + noize::clampi(r + off, rlo, rhi) * p;
      push<K>(hr, x_sum<K>(row, ci, co.hx, f));
      float v = z_sum<K>(hr, co.hz, f);
      if (kRss) {
        push<K>(vr, x_sum<K>(row, ci, co.vx, 1.0f));
        const float w = z_sum<K>(vr, co.vz, 1.0f);
        v = __fsqrt_rn(noize::add(noize::mul(v, v), noize::mul(w, w)));
      }
      dst[doff + (long long)r * dpitch + c] = v;
    }
  }
}

// m iterations (K1@rss: m = 1) on one tz x tx output tile; the window is
// the tile with an off*m halo in dynamic shared memory: one buffer of
// tz + 2h rows at pitch short_pitch(h, tx) when m = 1, two at an odd pitch
// (chain_tile's) when m > 1.
template <int K, bool kRss>
__global__ void short_tile(const float* __restrict__ in, float* __restrict__ out, int rows,
                           int cols, NoizeSeries s, int vec) {
  constexpr int off = (K - 1) / 2;
  extern __shared__ float4 short_window[];
  in += (size_t)blockIdx.z * rows * cols;
  out += (size_t)blockIdx.z * rows * cols;
  Coef<K> co;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    co.hx[i] = s.hx[i];
    co.hz[i] = s.hz[i];
    co.vx[i] = s.vx[i];
    co.vz[i] = s.vz[i];
  }
  co.factor = s.factor;
  const int m = s.iterations, tz = s.tile_z, tx = s.tile_x, h = off * m;
  const int rz = tz + 2 * h, rx = tx + 2 * h;
  const int z0 = blockIdx.y * tz - h, x0 = blockIdx.x * tx - h;
  const int zl = lo_after(z0, 0, off), zh = hi_after(z0, rz, rows, 0, off);
  const int xl = lo_after(x0, 0, off), xh = hi_after(x0, rx, cols, 0, off);
  float* a = reinterpret_cast<float*>(short_window);
  int p;
  if (m == 1) {
    const int lead = short_lead(h);
    p = short_pitch(h, tx);
    a += lead;
    load_short_window(in, cols, z0, x0, a, p, lead, zl, zh, xl, xh, vec != 0);
  } else {  // chain_tile's window: an odd pitch for pass_x's warps down 32 rows
    p = rx | 1;
    const int nx = xh - xl + 1;
    for (int i = threadIdx.x; i < (zh - zl + 1) * nx; i += blockDim.x) {
      const int r = zl + i / nx, c = xl + i % nx;
      noize::copy_async(a + r * p + c, in + (size_t)(z0 + r) * cols + (x0 + c), true);
    }
    noize::copy_async_wait();
  }
  __syncthreads();
  float* b = a + rz * p;
  for (int j = 1; j < m; ++j) {  // the iterations before the last, as chain_tile runs them
    const int zlp = lo_after(z0, j - 1, off), zhp = hi_after(z0, rz, rows, j - 1, off);
    const int xlp = lo_after(x0, j - 1, off), xhp = hi_after(x0, rx, cols, j - 1, off);
    const int zlj = lo_after(z0, j, off), zhj = hi_after(z0, rz, rows, j, off);
    const int xlj = lo_after(x0, j, off), xhj = hi_after(x0, rx, cols, j, off);
    pass_x<K>(a, p, b, 0, p, zlp, zhp, xlj, xhj, xlp, xhp, co.hx, co.factor);
    __syncthreads();
    pass_z<K>(b, p, a, 0, p, zlj, zhj, xlj, xhj, zlp, zhp, co.hz, co.factor);
    __syncthreads();
  }
  // the last iteration, one pass straight to device memory: the tile itself
  const int zlp = lo_after(z0, m - 1, off), zhp = hi_after(z0, rz, rows, m - 1, off);
  const int xlp = lo_after(x0, m - 1, off), xhp = hi_after(x0, rx, cols, m - 1, off);
  short_pass<K, kRss>(a, p, out, (long long)z0 * cols + x0, cols, lo_after(z0, m, off),
                      hi_after(z0, rz, rows, m, off), lo_after(x0, m, off),
                      hi_after(x0, rx, cols, m, off), zlp, zhp, xlp, xhp, co, s.strip);
}

size_t short_bytes(int k, int m, int tz, int tx) {
  const int h = (k - 1) / 2 * m;
  if (m == 1) return sizeof(float) * (size_t)(tz + 2 * h) * short_pitch(h, tx);
  return 2 * sizeof(float) * (size_t)(tz + 2 * h) * ((tx + 2 * h) | 1);
}

// Lets short_tile<K, kRss> take `bytes` of dynamic shared memory past the
// default 48 KB (up to the device's opt-in limit), once per device.
template <int K, bool kRss>
cudaError_t allow_short(size_t bytes) {
  static int allowed[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (size_t)allowed[dev] >= bytes) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(short_tile<K, kRss>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < 64) allowed[dev] = optin;
  return err;
}

template <int K, bool kRss>
int run_short(const float* x, float* out, int rows, int cols, int batch, const NoizeSeries& s,
              bool vec, cudaStream_t stream) {
  const size_t bytes = short_bytes(K, s.iterations, s.tile_z, s.tile_x);
  cudaError_t err = allow_short<K, kRss>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cols + s.tile_x - 1) / s.tile_x, (rows + s.tile_z - 1) / s.tile_z, batch);
  short_tile<K, kRss><<<grid, s.threads, bytes, stream>>>(x, out, rows, cols, s, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Makes `device` current for a call and the caller's device current again
// after it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// K1@short (s->rss == 0) or K1@rss (s->rss == 1) on `batch` rows x cols
// maps x, one after another, into out: one launch.  s (host) holds the
// call's constants and stays the caller's; device is x's CUDA device.
extern "C" int noize_series_chain(const float* x, float* out, int rows, int cols, int batch,
                                  const NoizeSeries* s, int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int k = s->k;
  if (k < 1 || k % 2 == 0 || k > (s->rss ? kRssMaxTaps : kShortMaxTaps) || rows < 1 ||
      cols < 1 || batch < 1 || batch > 65535 || s->iterations < 1 ||
      (s->rss && s->iterations != 1) || s->tile_z < 1 || s->tile_x < 4 || s->tile_x % 4 ||
      (rows + s->tile_z - 1) / s->tile_z > 65535 || s->strip < 1 || s->threads < 32 ||
      s->threads > 1024 || s->threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (s->rss) {
    switch (k) {
#define NOIZE_RSS_CASE(K) \
  case K:                 \
    return run_short<K, true>(x, out, rows, cols, batch, *s, vec, stream);
      NOIZE_RSS_CASE(1) NOIZE_RSS_CASE(3) NOIZE_RSS_CASE(5) NOIZE_RSS_CASE(7) NOIZE_RSS_CASE(9)
#undef NOIZE_RSS_CASE
    }
  }
  switch (k) {
#define NOIZE_SHORT_CASE(K) \
  case K:                   \
    return run_short<K, false>(x, out, rows, cols, batch, *s, vec, stream);
    NOIZE_SHORT_CASE(1) NOIZE_SHORT_CASE(3) NOIZE_SHORT_CASE(5) NOIZE_SHORT_CASE(7)
    NOIZE_SHORT_CASE(9) NOIZE_SHORT_CASE(11) NOIZE_SHORT_CASE(13) NOIZE_SHORT_CASE(15)
    NOIZE_SHORT_CASE(17)
#undef NOIZE_SHORT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
