// K9 — the in-order event scatter: each cell's events added to it one by
// one, in event order, for up to four maps at once.
//
// Not a TPU kernel's port: the reference scatter-adds the descent's events
// with XLA scatters (noize_tpu/erosion/particles.py:445, descend_all; the
// sharded descent, noize_tpu/parallel/sharded_erosion.py:235) and the
// vegetation stamps the same way (noize_tpu/erosion/vegetation.py:94).  The
// plain version is particles.scatter_events on the CPU, whose index_put_
// (accumulate=True) adds each value to its cell in order, in pieces of
// 32767.  CUDA's index_put_ sums a cell's run of 32 or more in a warp's
// lanes instead, so its sums depend on how the events are split over calls
// and on zeros inside a run (ROADMAP.md §3); this kernel gives the CPU's
// bits whatever the chunking.
//
// Bound: bytes (each event's cell and deltas read once, each touched cell
// read and written once), a few microseconds at the descent's 104,000
// events; what costs is the order: a cell's events are one dependent chain
// of adds.
//
// Design: a key pass writes each event's cell as an int32 sort key (the
// sentinel kSkip for an event whose deltas are all zero, where the caller
// says its accumulators hold no -0.0: adding ±0.0 then changes no bit, so
// the dead particles' events drop out of every run); one stable sort of the
// keys (torch.sort, shared by every map) gives the permutation; then one
// thread a run of equal keys (the thread at the run's first position) adds
// the run's events to the cell in permutation order, which is event order,
// four at a time so that their loads overlap.  A cell outside [0, size)
// traps, as index_put_'s device assert does.
#include <climits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::add;

constexpr int kThreads = 256;
constexpr int kMaxMaps = 4;
constexpr int kSkip = INT_MAX;
constexpr int kBatch = 4;

struct Maps {
  int k;
  const float* d[kMaxMaps];
  float* acc[kMaxMaps];
};

__global__ void __launch_bounds__(kThreads)
scatter_keys(const long long* __restrict__ cells, Maps m, long long n, long long size,
             int skip_zeros, int* __restrict__ keys) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long c = cells[e];
    if (c < 0 || c >= size) __trap();
    bool zero = skip_zeros != 0;
#pragma unroll
    for (int k = 0; k < kMaxMaps; ++k) {
      if (k < m.k) zero = zero && m.d[k][e] == 0.0f;  // NaN is kept
    }
    keys[e] = zero ? kSkip : static_cast<int>(c);
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_runs(const int* __restrict__ keys, const long long* __restrict__ perm, long long n,
             Maps m) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int c = keys[j];
  if (c == kSkip || (j > 0 && keys[j - 1] == c)) return;  // not a run's first event
  float a[kMaxMaps];
#pragma unroll
  for (int k = 0; k < kMaxMaps; ++k) a[k] = k < m.k ? m.acc[k][c] : 0.0f;
  for (long long t = j; t < n; t += kBatch) {
    // the next kBatch positions, all loads issued before the first add
    int kb[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) kb[b] = t + b < n ? keys[t + b] : ~c;
    int len = 0;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) len += len == b && kb[b] == c;
    long long e[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) e[b] = b < len ? perm[t + b] : 0;
    float v[kMaxMaps][kBatch];
#pragma unroll
    for (int k = 0; k < kMaxMaps; ++k) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[k][b] = k < m.k && b < len ? m.d[k][e[b]] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kMaxMaps; ++k) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k < m.k && b < len) a[k] = add(a[k], v[k][b]);
      }
    }
    if (len < kBatch) break;
  }
#pragma unroll
  for (int k = 0; k < kMaxMaps; ++k) {
    if (k < m.k) m.acc[k][c] = a[k];
  }
}

Maps make_maps(int k, const float* const* deltas, float* const* acc) {
  Maps m;
  m.k = k;
  for (int i = 0; i < kMaxMaps; ++i) {
    m.d[i] = i < k ? deltas[i] : nullptr;
    m.acc[i] = i < k ? acc[i] : nullptr;
  }
  return m;
}

int grid_of(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535 ? blocks : 65535);
}

}  // namespace

// cells: i64[n] device memory; deltas: host array of k device pointers
// (f32[n] each), k in [1, 4]; keys: i32[n] device memory, written.
// skip_zeros: the accumulators hold no -0.0, so all-zero events may drop.
extern "C" int noize_scatter_keys(const long long* cells, const float* const* deltas, int k,
                                  long long n, long long size, int skip_zeros, int* keys,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxMaps || n < 0 || size < 1 || size >= kSkip) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  float* none[kMaxMaps] = {nullptr, nullptr, nullptr, nullptr};
  scatter_keys<<<grid_of(n), kThreads, 0, stream>>>(cells, make_maps(k, deltas, none), n, size,
                                                    skip_zeros, keys);
  return static_cast<int>(cudaGetLastError());
}

// keys: the sorted i32 keys, perm: i64 positions of the events in that
// order (a stable sort), deltas / acc: host arrays of k device pointers
// (f32[n] deltas, f32[size] accumulators, added to in place).
extern "C" int noize_scatter_runs(const int* keys, const long long* perm, long long n,
                                  const float* const* deltas, float* const* acc, int k,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxMaps || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  scatter_runs<<<static_cast<int>(blocks), kThreads, 0, stream>>>(keys, perm, n,
                                                                 make_maps(k, deltas, acc));
  return static_cast<int>(cudaGetLastError());
}
