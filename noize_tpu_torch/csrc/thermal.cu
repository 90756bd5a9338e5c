// K3 — thermal (talus) erosion: 4 * iterations checkerboard phases.
//
// Replaces: noize_tpu/ops/pallas/thermal_pl.py:_fused_thermal_call (entry
// thermal_erosion_fused).  Each phase anchors 2x2 blocks at one (x, z)
// parity and runs the sequential 6-pair rectify chain inside each block
// (ops/thermal.py:36-177, _PAIRS and _PHASE_OFFSETS order).
//
// Bound: device memory.  A phase reads and writes each covered cell once
// with ~30 flops per block; at 2048^2 a phase moves 32 MB.
//
// Design: one thread per 2x2 anchor of the strided form (thermal._phase),
// updating its block in place.  The blocks of one phase are disjoint, so
// nothing races; phases are separate launches in _PHASE_OFFSETS order.
// Coverage follows thermal_phase_masked: anchors x in [x0, res-2],
// z in [z0, zmax] with zmax = res-2 when z0 == 2, else res-3.
// max_diff is computed once by the wrapper (float32 tan, as the reference
// does) and passed in.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::add;
using noize::mul;
using noize::sub;

// _rectify_pair (thermal.py:39-45)
__device__ __forceinline__ void rectify(float& v1, float& v2, float max_diff, float inc) {
  const float diff = fabsf(sub(v1, v2));
  const float excess = mul(noize::relu(sub(diff, max_diff)), inc);
  const float delta = v1 > v2 ? -excess : excess;
  const float n1 = add(v1, delta);
  const float n2 = sub(v2, delta);
  v1 = n1;
  v2 = n2;
}

__global__ void thermal_phase(float* d, int res, int x0, int z0, int zmax,
                              float max_diff, float inc) {
  const int ax = x0 + 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int az = z0 + 2 * (blockIdx.y * blockDim.y + threadIdx.y);
  if (ax >= res - 1 || az > zmax) return;
  float* r0 = d + (size_t)az * res + ax;
  float* r1 = r0 + res;
  // float4 order: x = (ax, az), y = (ax+1, az), z = (ax, az+1), w = (ax+1, az+1)
  float v0 = r0[0], v1 = r0[1], v2 = r1[0], v3 = r1[1];
  rectify(v0, v1, max_diff, inc);
  rectify(v0, v2, max_diff, inc);
  rectify(v0, v3, max_diff, inc);
  rectify(v1, v2, max_diff, inc);
  rectify(v1, v3, max_diff, inc);
  rectify(v2, v3, max_diff, inc);
  r0[0] = v0;
  r0[1] = v1;
  r1[0] = v2;
  r1[1] = v3;
}

}  // namespace

extern "C" int noize_thermal_erosion(const float* in, float* data, int res, int iterations,
                                     float max_diff, float increment, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (res < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemcpyAsync(data, in, sizeof(float) * (size_t)res * res, cudaMemcpyDeviceToDevice,
                  stream);
  // _PHASE_OFFSETS (thermal.py:74), as (x0, z0)
  const int offsets[4][2] = {{1, 2}, {2, 2}, {1, 1}, {2, 1}};
  const dim3 block(32, 8);
  const dim3 grid = noize::grid2d((res + 1) / 2, (res + 1) / 2, block);
  for (int it = 0; it < iterations; ++it) {
    for (int p = 0; p < 4; ++p) {
      const int x0 = offsets[p][0];
      const int z0 = offsets[p][1];
      const int zmax = z0 == 2 ? res - 2 : res - 3;
      thermal_phase<<<grid, block, 0, stream>>>(data, res, x0, z0, zmax, max_diff, increment);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
