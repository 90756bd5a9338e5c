// K12 — the deposit's pool and track adds and the track/flow decay in one
// launch.
//
// Not a TPU kernel's port: the reference's deposit (noize_tpu/erosion/sim.py,
// the pool and track adds) and its decay (noize_tpu/erosion/world.py,
// update_flow_from_track) are plain JAX, which XLA fused on the TPU.  The
// port's plain version (erosion/world.py, deposit_and_decay_plain) runs them
// as some 19 PyTorch launches, each a pass over the whole map, and the
// graphs then copied the new flow and track into their static state.
//
// Bound: bytes.  A cell reads pool, its accumulator, track, its accumulator
// and flow, and writes pool, flow and track (zero) once: 32 bytes (0.040 ms at
// 2048^2 at 3.35e12 B/s); 24 without the accumulators.  The work a cell,
// counted from the lines below: the two adds and their multiplies 4, the two
// compares 2, the flow 1 to 6 (the saturating branch: 3 multiplies, 2 adds
// and a divide), the evaporation's subtract and clamp 2: at most 14 (0.002 ms
// at 33.5e12 a second).  erosion/decay_cuda.cost counts it.
//
// Design: a thread handles four cells as float4 loads and stores in a
// grid-stride loop when every map is 16-byte aligned, a cell at a time
// otherwise and for the n % 4 cells of the tail (1025^2 maps).  The outputs
// may be the inputs of the same map (flow and track written in place into the
// graphs' static state, pool into its own map): each thread reads its cells
// before it writes them, and no other thread touches them.
//
// Bit-equality with the plain version (erosion/world.py): the adds are
// pool + pool_acc * pm and track + track_acc * tm; has_pool = pool' > minpool,
// has_track = track' > 0; the flow is keep_pool * flow where has_pool, else
// keep * flow + (gain * track') / (50 * track' + 1) where has_track, else
// keep * flow (the plain version's selects pick the same value); the pool is
// clamp_min(pool' - evap, 0), a NaN kept as PyTorch's clamp keeps it; the
// track is written as +0.  The scalars are the plain expressions' Python
// scalars rounded to float32 (erosion/decay_cuda._constants), passed by
// value.  Without accumulators (no spawn) the adds are skipped: x + 0 * m
// would turn -0.0 into +0.0.  Every operation is an explicit __f*_rn (the
// library is also built with -fmad=false).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

// One call's scalars, passed by value (outside the unnamed namespace: the C
// entry's parameter needs external linkage).
struct NoizeDecay {
  float pm, tm;      // POOL_PLACEMENT_MULTIPLIER, TRACK_PLACEMENT_MULTIPLIER
  float minpool;     // MINFLOWPOOL
  float keep_pool;   // 1 - 0.1 * FLOW_LOSS_RATE
  float keep;        // 1 - FLOW_LOSS_RATE
  float gain;        // FLOW_LOSS_RATE * 50
  float evap;        // SURFACE_EVAPORATION_RATE / HEIGHT
};

namespace {

using noize::add;
using noize::divf;
using noize::mul;
using noize::sub;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Cell {
  float pool, flow;
};

template <bool kSpawn>
__device__ __forceinline__ Cell decay(float pool, float pool_acc, float track, float track_acc,
                                      float flow, const NoizeDecay& p) {
  if (kSpawn) {
    pool = add(pool, mul(pool_acc, p.pm));
    track = add(track, mul(track_acc, p.tm));
  }
  float nf;
  if (pool > p.minpool) {
    nf = mul(flow, p.keep_pool);
  } else if (track > 0.0f) {
    nf = add(mul(flow, p.keep), divf(mul(track, p.gain), add(mul(track, 50.0f), 1.0f)));
  } else {
    nf = mul(flow, p.keep);
  }
  const float np = sub(pool, p.evap);
  return {isnan(np) ? np : fmaxf(np, 0.0f), nf};
}

template <bool kSpawn, bool kVec>
__global__ void __launch_bounds__(kThreads)
decay_cells(const float* pool, const float* pool_acc, const float* track, const float* track_acc,
            const float* flow, float* pool_out, float* flow_out, float* track_out, long long n,
            const NoizeDecay p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long head = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long v = i; v < n4; v += stride) {
      const float4 po = reinterpret_cast<const float4*>(pool)[v];
      const float4 tr = reinterpret_cast<const float4*>(track)[v];
      const float4 fl = reinterpret_cast<const float4*>(flow)[v];
      float4 pa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ta = pa;
      if (kSpawn) {
        pa = reinterpret_cast<const float4*>(pool_acc)[v];
        ta = reinterpret_cast<const float4*>(track_acc)[v];
      }
      const Cell a = decay<kSpawn>(po.x, pa.x, tr.x, ta.x, fl.x, p);
      const Cell b = decay<kSpawn>(po.y, pa.y, tr.y, ta.y, fl.y, p);
      const Cell c = decay<kSpawn>(po.z, pa.z, tr.z, ta.z, fl.z, p);
      const Cell d = decay<kSpawn>(po.w, pa.w, tr.w, ta.w, fl.w, p);
      reinterpret_cast<float4*>(pool_out)[v] = make_float4(a.pool, b.pool, c.pool, d.pool);
      reinterpret_cast<float4*>(flow_out)[v] = make_float4(a.flow, b.flow, c.flow, d.flow);
      reinterpret_cast<float4*>(track_out)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    head = n4 * 4;
  }
  for (long long k = head + i; k < n; k += stride) {
    const Cell a = decay<kSpawn>(pool[k], kSpawn ? pool_acc[k] : 0.0f, track[k],
                                 kSpawn ? track_acc[k] : 0.0f, flow[k], p);
    pool_out[k] = a.pool;
    flow_out[k] = a.flow;
    track_out[k] = 0.0f;
  }
}

template <bool kSpawn, bool kVec>
cudaError_t launch(const float* pool, const float* pool_acc, const float* track,
                   const float* track_acc, const float* flow, float* pool_out, float* flow_out,
                   float* track_out, long long n, const NoizeDecay& p, cudaStream_t stream) {
  const long long items = kVec ? (n + 3) / 4 : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  decay_cells<kSpawn, kVec><<<blocks, kThreads, 0, stream>>>(
      pool, pool_acc, track, track_acc, flow, pool_out, flow_out, track_out, n, p);
  return cudaGetLastError();
}

bool aligned(const void* ptr) { return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// pool, track, flow, pool_out, flow_out, track_out: f32[n] device memory;
// pool_acc and track_acc f32[n], or both null (no spawn: the adds skipped).
// An output may be the input of its own map, and no other.
extern "C" int noize_decay(const float* pool, const float* pool_acc, const float* track,
                           const float* track_acc, const float* flow, float* pool_out,
                           float* flow_out, float* track_out, long long n, NoizeDecay p,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool spawn = pool_acc != nullptr;
  if (n < 1 || spawn != (track_acc != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = aligned(pool) && aligned(track) && aligned(flow) && aligned(pool_out) &&
                   aligned(flow_out) && aligned(track_out) &&
                   (!spawn || (aligned(pool_acc) && aligned(track_acc)));
  cudaError_t err;
  if (spawn) {
    err = vec ? launch<true, true>(pool, pool_acc, track, track_acc, flow, pool_out, flow_out,
                                   track_out, n, p, stream)
              : launch<true, false>(pool, pool_acc, track, track_acc, flow, pool_out, flow_out,
                                    track_out, n, p, stream);
  } else {
    err = vec ? launch<false, true>(pool, pool_acc, track, track_acc, flow, pool_out, flow_out,
                                    track_out, n, p, stream)
              : launch<false, false>(pool, pool_acc, track, track_acc, flow, pool_out, flow_out,
                                     track_out, n, p, stream);
  }
  return static_cast<int>(err);
}
