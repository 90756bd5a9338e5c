// K11 — the sediment write-back: the light/heavy split, KERNEL5's
// clamped-scatter dispersal, the pile tent and the [0, 1] breaker in one
// launch.
//
// Not a TPU kernel's port: the reference's write-back
// (noize_tpu/erosion/sediment.py, write_sediment_map) is plain JAX, which XLA
// fused on the TPU.  The port's plain version (erosion/sediment.py,
// write_sediment_map_plain) runs each axis of a clamped-scatter stamp as a pad,
// a multiply and an add a tap and three updates a fold: some 370 PyTorch
// launches a cycle with a pile of radius 15, each a whole-map pass, and each a
// trip through the host.
//
// Bound: operations with the tent, bytes without.  A cell reads its height and
// its sediment and writes its height once, 12 bytes (0.015 ms at 2048^2).  The
// work a cell, counted from the lines below: each part of the split 2 (a
// compare, a select), each axis of a k-tap stamp k multiplies and k - 1 adds,
// the tent's add to the dispersal, the height's add and the breaker 3; each
// fold adds 2 on an edge cell.  That is 24 a cell without the tent and 149
// with the tent of radius 15 (0.019 ms at 2048^2 at 33.5e12 a second:
// -fmad=false halves the card's fused rate); erosion/sediment_cuda.cost
// counts it.
//
// Design: a block computes a kTileRows x kTileCols tile of the new height.  It
// loads the tile's sediment window, the tile and a halo of the widest stamp's
// reach a side (zero beyond the grid, as the plain version pads), into shared
// memory once; runs the first axis (dim 0) of the dispersal, and of the tent
// when it runs, for the tile's rows over every column of the window into
// shared memory, each value rounded to f32 as the plain version's first pass
// stores it (zero for columns beyond the grid); then runs the second axis
// (dim 1) a cell a thread, adds the tent to the dispersal, the sum to the
// height, and applies the breaker.  A stamp's fold reads only sources within
// its reach of the edge cell, which the window holds.  Ragged tiles are masked.
//
// Bit-equality with the plain version on the card (erosion/sediment.py,
// _disperse_axis): each cell's taps are added in tap order over the
// zero-padded source, the sum starting from the first product, the padding's
// products evaluated; the folds come after the tap sum, j = 0 .. off - 1, the
// low edge's and the high edge's each in its own order; the tent's sum is
// added to the dispersal's, then to the height.  The weights of products and
// folds are the plain version's own float32 values (sediment.axis_weights),
// passed by value.  Every operation is an explicit __f*_rn (the library is
// also built with -fmad=false).
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kMaxTaps = 63;  // radius 31: erosion/sediment_cuda.MAX_RADIUS
constexpr int kMaxFolds = (kMaxTaps - 1) / 2;

// One call's constants, passed by value (outside the unnamed namespace: the C
// entry's parameter needs external linkage).  wd/wt: the dispersal's and the
// tent's product weights in product order (taps[k - 1 - i]); fd/ft: their
// fold weights (cumsum(taps)[off - 1 - j]).  kt == 0: no tent.
struct NoizeSediment {
  float thresh;  // PILE_THRESHOLD / HEIGHT as float32
  int kd, kt;
  float wd[kMaxTaps], fd[kMaxFolds];
  float wt[kMaxTaps], ft[kMaxFolds];
};

namespace {

using noize::add;
using noize::mul;

constexpr int kTileRows = 32, kTileCols = 64;
constexpr int kThreads = 256;

// One cell of _disperse_axis along one axis: the k taps over the zero-padded
// source (src(x): the source at window position x along the axis; the cell
// sits at window position at, at grid position g of n), then the edge folds:
// source j at the low edge, source n - 1 - j at the high edge.
template <typename Src>
__device__ __forceinline__ float disperse(Src src, int at, int g, int n, const float* w,
                                          const float* f, int k) {
  const int off = (k - 1) / 2;
  float s = mul(src(at - off), w[0]);
  for (int i = 1; i < k; ++i) s = add(s, mul(src(at - off + i), w[i]));
  if (g == 0) {
    for (int j = 0; j < off; ++j) s = add(s, mul(src(at + j), f[j]));
  }
  if (g == n - 1) {
    for (int j = 0; j < off; ++j) s = add(s, mul(src(at - j), f[j]));
  }
  return s;
}

template <bool kTent>
__host__ __device__ __forceinline__ int halo_of(const NoizeSediment& p) {
  const int offd = (p.kd - 1) / 2, offt = kTent ? (p.kt - 1) / 2 : 0;
  return offd > offt ? offd : offt;
}

template <bool kTent>
__host__ __device__ __forceinline__ size_t smem_floats(int halo) {
  const size_t wcols = kTileCols + 2 * halo;
  return (kTileRows + 2 * halo) * wcols + (kTent ? 2 : 1) * kTileRows * wcols;
}

template <bool kTent>
__global__ void __launch_bounds__(kThreads)
sediment_tile(const float* __restrict__ height, const float* __restrict__ sed,
              float* __restrict__ out, int rows, int cols,
              const __grid_constant__ NoizeSediment p) {
  extern __shared__ float smem[];
  const int halo = halo_of<kTent>(p);
  const int wrows = kTileRows + 2 * halo, wcols = kTileCols + 2 * halo;
  float* win = smem;                    // wrows x wcols: the sediment window
  float* disp0 = win + wrows * wcols;   // kTileRows x wcols: the dispersal after dim 0
  float* tent0 = disp0 + kTileRows * wcols;  // kTileRows x wcols: the tent after dim 0
  const int r0 = blockIdx.y * kTileRows, c0 = blockIdx.x * kTileCols;
  const float thresh = p.thresh;

  for (int i = threadIdx.x; i < wrows * wcols; i += kThreads) {
    const int wr = i / wcols, wc = i - wr * wcols;
    const int gr = r0 - halo + wr, gc = c0 - halo + wc;
    const bool in = gr >= 0 && gr < rows && gc >= 0 && gc < cols;
    win[i] = in ? sed[static_cast<size_t>(gr) * cols + gc] : 0.0f;
  }
  __syncthreads();

  // dim 0 over the window's columns: window row tr + halo is grid row r0 + tr
  for (int i = threadIdx.x; i < kTileRows * wcols; i += kThreads) {
    const int tr = i / wcols, wc = i - tr * wcols;
    const int gr = r0 + tr, gc = c0 - halo + wc;
    float d = 0.0f, t = 0.0f;
    if (gr < rows && gc >= 0 && gc < cols) {
      const float* column = win + wc;
      d = disperse([&](int x) { const float s = column[x * wcols]; return s <= thresh ? s : 0.0f; },
                   tr + halo, gr, rows, p.wd, p.fd, p.kd);
      if (kTent) {
        t = disperse([&](int x) { const float s = column[x * wcols]; return s > thresh ? s : 0.0f; },
                     tr + halo, gr, rows, p.wt, p.ft, p.kt);
      }
    }
    disp0[i] = d;
    if (kTent) tent0[i] = t;
  }
  __syncthreads();

  // dim 1 a cell a thread, then the height and the breaker
  for (int i = threadIdx.x; i < kTileRows * kTileCols; i += kThreads) {
    const int tr = i / kTileCols, tc = i - tr * kTileCols;
    const int gr = r0 + tr, gc = c0 + tc;
    if (gr >= rows || gc >= cols) continue;
    const float* drow = disp0 + tr * wcols;
    float delta = disperse([&](int x) { return drow[x]; }, tc + halo, gc, cols, p.wd, p.fd, p.kd);
    if (kTent) {
      const float* trow = tent0 + tr * wcols;
      delta = add(delta, disperse([&](int x) { return trow[x]; }, tc + halo, gc, cols, p.wt,
                                  p.ft, p.kt));
    }
    const size_t g = static_cast<size_t>(gr) * cols + gc;
    const float h = height[g];
    const float nh = add(h, delta);
    out[g] = (nh >= 0.0f && nh <= 1.0f) ? nh : h;
  }
}

template <bool kTent>
cudaError_t launch(const float* height, const float* sed, float* out, int rows, int cols,
                   const NoizeSediment& p, cudaStream_t stream) {
  const size_t smem = smem_floats<kTent>(halo_of<kTent>(p)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sediment_tile<kTent>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((cols + kTileCols - 1) / kTileCols, (rows + kTileRows - 1) / kTileRows);
  sediment_tile<kTent><<<grid, kThreads, smem, stream>>>(height, sed, out, rows, cols, p);
  return cudaGetLastError();
}

bool odd_taps(int k) { return k >= 1 && k <= kMaxTaps && k % 2 == 1; }

}  // namespace

// height, sed, out: f32[rows, cols] device memory, contiguous; out is written
// whole and may not alias height or sed.  p.kt == 0 runs no tent.
extern "C" int noize_sediment(const float* height, const float* sed, float* out, int rows,
                              int cols, NoizeSediment p, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || cols < 1 || rows > 65535 * kTileRows || !odd_taps(p.kd) ||
      (p.kt != 0 && !odd_taps(p.kt))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = p.kt ? launch<true>(height, sed, out, rows, cols, p, stream)
                               : launch<false>(height, sed, out, rows, cols, p, stream);
  return static_cast<int>(err);
}
