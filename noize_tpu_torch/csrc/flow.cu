// K2 — the whole flow map (virtual-pipes relaxation -> |velocity|).
//
// Replaces: noize_tpu/ops/pallas/flow_pl.py:_fused_flow_call (entry
// flow_map_fused).  Computes WATER_INIT fill, `iterations` x (flow step,
// water step), the velocity field and the static normalise with its
// `norm_max - norm_min < 1e-12` guard (ops/flow.py:59-126).
//
// Bound: device memory.  Each iteration touches six maps (height, water,
// four flows) with a handful of flops per cell; at 2048^2 an iteration
// moves ~130 MB.
//
// Design: one thread per cell.  Per iteration two launches: the flow step
// (reads water/height at the 4 clamped neighbours, rewrites the cell's own
// four flows in place) and the water step (reads the new flows at the
// neighbours, rewrites the cell's own water in place).  Each launch reads
// only what the other one writes, so in-place updates are race-free.  A
// last launch computes velocity + normalise.  Clamped neighbour reads are
// the reference's edge-replicated shifts, so no border re-clamp pass is
// needed.  Every op rounds on its own, in the reference's order.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kTimestep = 0.2f;    // ops/flow.py TIMESTEP
constexpr float kWaterInit = 1e-4f;  // ops/flow.py WATER_INIT

using noize::add;
using noize::clampi;
using noize::divf;
using noize::mul;
using noize::sub;

__global__ void flow_init(float* water, float* fw, float* fe, float* fs, float* fn, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  water[i] = kWaterInit;
  fw[i] = 0.0f;
  fe[i] = 0.0f;
  fs[i] = 0.0f;
  fn[i] = 0.0f;
}

// compute_flow_step (flow.py:59-76); W = x-1, E = x+1, S = z-1, N = z+1.
__global__ void flow_step(const float* __restrict__ h, const float* __restrict__ water,
                          float* fw, float* fe, float* fs, float* fn, int res) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const size_t iw = (size_t)z * res + clampi(x - 1, 0, res - 1);
  const size_t ie = (size_t)z * res + clampi(x + 1, 0, res - 1);
  const size_t is = (size_t)clampi(z - 1, 0, res - 1) * res + x;
  const size_t in = (size_t)clampi(z + 1, 0, res - 1) * res + x;
  const float total = add(h[i], water[i]);
  const float vw = noize::relu(add(fw[i], sub(total, add(h[iw], water[iw]))));
  const float ve = noize::relu(add(fe[i], sub(total, add(h[ie], water[ie]))));
  const float vs = noize::relu(add(fs[i], sub(total, add(h[is], water[is]))));
  const float vn = noize::relu(add(fn[i], sub(total, add(h[in], water[in]))));
  const float s = add(add(add(vw, ve), vs), vn);
  float k = 0.0f;
  if (s > 0.0f) {
    k = noize::fmin2(noize::fmax2(divf(water[i], mul(s, kTimestep)), 0.0f), 1.0f);
  }
  fw[i] = mul(vw, k);
  fe[i] = mul(ve, k);
  fs[i] = mul(vs, k);
  fn[i] = mul(vn, k);
}

// update_water_step (flow.py:79-88)
__global__ void water_step(float* water, const float* __restrict__ fw,
                           const float* __restrict__ fe, const float* __restrict__ fs,
                           const float* __restrict__ fn, int res) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const size_t iw = (size_t)z * res + clampi(x - 1, 0, res - 1);
  const size_t ie = (size_t)z * res + clampi(x + 1, 0, res - 1);
  const size_t is = (size_t)clampi(z - 1, 0, res - 1) * res + x;
  const size_t in = (size_t)clampi(z + 1, 0, res - 1) * res + x;
  const float flow_out = add(add(add(fw[i], fe[i]), fs[i]), fn[i]);
  const float flow_in = add(add(add(fe[iw], fw[ie]), fn[is]), fs[in]);
  water[i] = noize::relu(add(water[i], mul(sub(flow_in, flow_out), kTimestep)));
}

// velocity_field (flow.py:91-100) + the static normalise (flow.py:124-126)
__global__ void velocity(float* __restrict__ out, const float* __restrict__ fw,
                         const float* __restrict__ fe, const float* __restrict__ fs,
                         const float* __restrict__ fn, int res, float norm_min, float rng) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const size_t iw = (size_t)z * res + clampi(x - 1, 0, res - 1);
  const size_t ie = (size_t)z * res + clampi(x + 1, 0, res - 1);
  const size_t is = (size_t)clampi(z - 1, 0, res - 1) * res + x;
  const size_t in = (size_t)clampi(z + 1, 0, res - 1) * res + x;
  const float dl = sub(fe[iw], fw[i]);
  const float dr = sub(fe[i], fw[ie]);
  const float dt = sub(fs[in], fn[i]);
  const float db = sub(fs[i], fn[is]);
  const float vx = mul(add(dl, dr), 0.5f);
  const float vy = mul(add(dt, db), 0.5f);
  float v = __fsqrt_rn(add(mul(vx, vx), mul(vy, vy)));
  if (rng < 1e-12f) v = 0.0f;
  out[i] = divf(sub(v, norm_min), rng);
}

}  // namespace

extern "C" int noize_flow_map(const float* height, float* out, float* water, float* fw,
                              float* fe, float* fs, float* fn, int res, int iterations,
                              float norm_min, float rng, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (res < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n = res * res;
  flow_init<<<(n + 255) / 256, 256, 0, stream>>>(water, fw, fe, fs, fn, n);
  const dim3 block(32, 8);
  const dim3 grid = noize::grid2d(res, res, block);
  for (int it = 0; it < iterations; ++it) {
    flow_step<<<grid, block, 0, stream>>>(height, water, fw, fe, fs, fn, res);
    water_step<<<grid, block, 0, stream>>>(water, fw, fe, fs, fn, res);
  }
  velocity<<<grid, block, 0, stream>>>(out, fw, fe, fs, fn, res, norm_min, rng);
  return static_cast<int>(cudaGetLastError());
}
