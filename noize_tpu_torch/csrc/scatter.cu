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
// events.  What costs is latency: a cell's events are one dependent chain
// of adds, and every step of a sort is a round trip to L2; on a host-bound
// step the launches count too (a library sort is a handful of kernels, a
// 64-bit permutation over all 32 key bits, then a gather through it).
//
// Design: one cooperative launch, a persistent grid whose phases are
// separated by grid barriers (no host sync, no library call), a stable LSD
// radix sort of the event cells followed by the run pass:
//   - the key is the event's cell, or kSkip for an event whose deltas are
//     all zero where the caller says its accumulators hold no -0.0 (adding
//     ±0.0 to a sum that started at +0.0 changes no bit, so the dead
//     particles' events drop out); a cell outside [0, size) traps, as
//     index_put_'s device assert does;
//   - only the bits that size needs are sorted, ceil(log2 size), in
//     `passes` passes of `digit_bits` bits (the wrapper's plan: at most 11
//     bits a pass, two passes at 2048^2; at most 8 past 128 tiles, where
//     the scan across tiles and each tile's work on its 2,049 buckets cost
//     more than a third pass on 257); skipped events are a bucket of
//     their own after every digit, so the first pass moves them past the m
//     live events and later passes sort only those;
//   - an event moves as one 16-byte record, its key and three deltas (a
//     fourth map's deltas beside it), so no pass gathers through a
//     permutation and the run pass reads a run's values in a row;
//   - a pass: (H) each tile of kTileEvents events counts its digits in
//     shared memory (the first pass reads the cells and deltas here and
//     writes the keys); (S) a warp a digit scans the tiles' counts with
//     shuffles, giving each tile its offset and each digit its total; (R)
//     each tile ranks its events stably in shared memory — a warp takes 256
//     consecutive events 32 at a time, __match_any_sync groups the lanes
//     of one digit and a per-warp count gives each its rank, the warps'
//     counts of a digit (one 16-byte row) are then scanned — and stores
//     each record at digit base + tile offset + warp offset + rank;
//   - the run pass: one thread a run of equal cells (the thread at the
//     run's first position) adds the run's events to the cell in sorted
//     order, which is event order, eight records loaded at once.  The grid
//     has a thread an event where it can be resident: a warp's runs go in
//     lockstep, so a thread walking two runs would chain them.  Past the
//     resident grid (two blocks an SM: the descent's 104,000 events already
//     take a thread two positions) a thread walks several; a second launch
//     of a thread an event was measured no faster at 524,288 events and
//     slower at 104,000 (PERF.md), so the runs stay in this launch.
// A call is one kernel (three grid barriers a pass), plus the wrapper's
// fill when it adds into fresh zeros.  Scratch written in the launch is
// read through L2 (__ldcg), never a stale L1 line.  scripts/k9_shapes.py
// times a call at its callers' shapes.
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using noize::add;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileEvents = 2048;                   // events a tile ranks
constexpr int kWarpEvents = kTileEvents / kWarps;   // 256 a warp
constexpr int kRounds = kWarpEvents / 32;           // 8 of 32 a warp
constexpr int kPerThread = kTileEvents / kThreads;  // 8 a thread when counting
constexpr int kMaxDigitBits = 11;
constexpr int kMaxBuckets = (1 << kMaxDigitBits) + 1;  // + the skipped events' bucket
constexpr int kMaxPasses = 3;
constexpr int kMaxMaps = 4;
constexpr unsigned kSkip = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBatch = 8;
static_assert(kWarpEvents < 65536, "a warp's digit counts are 16-bit");
static_assert(kWarps == 8, "a digit's warp counts are one 16-byte row");

struct Maps {
  int k;
  const float* d[kMaxMaps];
  float* acc[kMaxMaps];
};

// The sort: n events on `size` cells, `passes` passes of `digit_bits`
// bits; scratch carved from one int32 buffer (noize_scatter_in_order).
struct Sort {
  long long n, size;
  int skip_zeros, passes, digit_bits;
  unsigned* keys;   // n: the first pass's keys, in event order
  uint4* rec[2];    // n each: (key, deltas 0-2 as bits) in a pass's order
  float* rec3[2];   // n each: delta 3 in a pass's order (four maps only)
  unsigned* hist;   // tiles x buckets, tile-major: counts, then offsets
  unsigned* totals; // buckets: each digit's events in the pass
};

struct Shared {
  union {
    unsigned hist[kMaxBuckets];  // (H) the tile's digit counts
    struct {
      // (R) each digit's count in each warp, then the warps' offsets: a
      // digit's kWarps counts are one 16-byte row
      __align__(16) unsigned short warp[kMaxBuckets][kWarps];
      unsigned base[kMaxBuckets];  // (R) digit base + tile offset
    } rank;
  };
  unsigned scan[kWarps];
};

__device__ __forceinline__ int digit_of(unsigned key, int shift, int bits) {
  return key == kSkip ? (1 << bits) : static_cast<int>((key >> shift) & ((1u << bits) - 1u));
}

// out[i] = sum of in[j < i] for i < count (count <= kMaxBuckets), by the
// whole block, a thread kScanPer neighbouring values held in registers; in
// is scratch another block wrote (read through L2).
constexpr int kScanPer = (kMaxBuckets + kThreads - 1) / kThreads;

__device__ void exclusive_scan(const unsigned* in, unsigned* out, int count, Shared& sh) {
  const int b = threadIdx.x * kScanPer;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned v[kScanPer];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    v[i] = b + i < count ? __ldcg(in + b + i) : 0u;
    sum += v[i];
  }
  unsigned inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned x = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) sh.scan[warp] = inc;
  __syncthreads();
  unsigned run = inc - sum;
  for (int w = 0; w < warp; ++w) run += sh.scan[w];
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) {
    if (b + i < count) out[b + i] = run;
    run += v[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
scatter_sort(const long long* __restrict__ cells, Maps m, Sort s) {
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bits = s.digit_bits, buckets = (1 << bits) + 1;
  long long count = s.n;  // events the pass sorts: all, then the m live ones
  int src = 0;            // the record buffer the pass reads after the first

  for (int pass = 0; pass < s.passes; ++pass) {
    const int shift = pass * bits;
    const int tiles = static_cast<int>((count + kTileEvents - 1) / kTileEvents);
    const uint4* rec_in = s.rec[src];

    // (H) each tile's digit counts; the first pass makes the keys.  A
    // thread's kPerThread events are loaded before any is counted.
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int i = tid; i < buckets; i += kThreads) sh.hist[i] = 0;
      const long long lo = (long long)t * kTileEvents + tid;
      unsigned key[kPerThread];
      if (pass == 0) {
        long long c[kPerThread];
        float d[kMaxMaps][kPerThread];
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          const long long e = lo + r * kThreads;
          const bool in = e < count;
          c[r] = in ? cells[e] : 0;
#pragma unroll
          for (int k = 0; k < kMaxMaps; ++k) {
            d[k][r] = k >= m.k ? 0.0f : (in && s.skip_zeros ? m.d[k][e] : 1.0f);
          }
        }
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          const long long e = lo + r * kThreads;
          if (c[r] < 0 || c[r] >= s.size) __trap();
          bool zero = s.skip_zeros != 0;
#pragma unroll
          for (int k = 0; k < kMaxMaps; ++k) zero = zero & (d[k][r] == 0.0f);  // NaN is kept
          key[r] = zero ? kSkip : static_cast<unsigned>(c[r]);
          if (e < count) s.keys[e] = key[r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) {
          const long long e = lo + r * kThreads;
          key[r] = e < count ? __ldcg(&rec_in[e].x) : 0u;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        if (lo + r * kThreads < count) atomicAdd(&sh.hist[digit_of(key[r], shift, bits)], 1u);
      }
      __syncthreads();
      for (int i = tid; i < buckets; i += kThreads) s.hist[(size_t)t * buckets + i] = sh.hist[i];
      __syncthreads();
    }
    grid.sync();

    // (S) per digit, the tiles' exclusive offsets and the digit's total:
    // a warp a digit, a lane a tile, 32 tiles a shuffle scan
    for (int d = blockIdx.x * kWarps + warp; d < buckets; d += gridDim.x * kWarps) {
      unsigned carry = 0;
      for (int t0 = 0; t0 < tiles; t0 += 32) {
        const int t = t0 + lane;
        unsigned* at = s.hist + (size_t)t * buckets + d;
        const unsigned v = t < tiles ? __ldcg(at) : 0u;
        unsigned inc = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned x = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += x;
        }
        if (t < tiles) *at = carry + inc - v;
        carry += __shfl_sync(kFull, inc, 31);
      }
      if (lane == 0) s.totals[d] = carry;
    }
    grid.sync();

    // (R) rank each tile's events stably and scatter them, each as one
    // 16-byte record of its key and deltas (the fourth map's apart), so that
    // no pass gathers and the run pass reads each run's values in a row
    const int dst = src ^ 1;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long lo = (long long)t * kTileEvents + warp * kWarpEvents + lane;
      uint4 rec[kRounds];  // key, deltas 0-2
      float rec3[kRounds];  // delta 3
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const long long e = lo + r * 32;
        const bool in = e < count;
        if (pass == 0) {
          rec[r].x = in ? __ldcg(s.keys + e) : kSkip;
          rec[r].y = in ? __float_as_uint(m.d[0][e]) : 0u;
          rec[r].z = in && m.k > 1 ? __float_as_uint(m.d[1][e]) : 0u;
          rec[r].w = in && m.k > 2 ? __float_as_uint(m.d[2][e]) : 0u;
          rec3[r] = in && m.k > 3 ? m.d[3][e] : 0.0f;
        } else {
          rec[r] = in ? __ldcg(rec_in + e) : make_uint4(kSkip, 0u, 0u, 0u);
          rec3[r] = in && m.k > 3 ? __ldcg(s.rec3[src] + e) : 0.0f;
        }
      }
      uint4* rows = reinterpret_cast<uint4*>(&sh.rank.warp[0][0]);
      for (int i = tid; i < buckets; i += kThreads) rows[i] = make_uint4(0, 0, 0, 0);
      exclusive_scan(s.totals, sh.rank.base, buckets, sh);  // digit bases (syncs)
      for (int i = tid; i < buckets; i += kThreads) {
        sh.rank.base[i] += __ldcg(s.hist + (size_t)t * buckets + i);
      }
      __syncthreads();
      const unsigned lt = (1u << lane) - 1u;
      unsigned short rank[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const bool valid = lo + r * 32 < count;
        const int d = valid ? digit_of(rec[r].x, shift, bits) : -1;
        const unsigned peers = __match_any_sync(kFull, d);
        const unsigned before = __popc(peers & lt);
        const unsigned short c = valid ? sh.rank.warp[d][warp] : 0;
        __syncwarp();
        if (valid && before == 0) {
          sh.rank.warp[d][warp] = static_cast<unsigned short>(c + __popc(peers));
        }
        __syncwarp();
        rank[r] = static_cast<unsigned short>(c + before);
      }
      __syncthreads();
      // the warps' counts of each digit, scanned in warp order
      for (int d = tid; d < buckets; d += kThreads) {
        union {
          uint4 row;
          unsigned short c[kWarps];
        } u;
        u.row = rows[d];
        unsigned short run = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const unsigned short c = u.c[w];
          u.c[w] = run;
          run = static_cast<unsigned short>(run + c);
        }
        rows[d] = u.row;
      }
      __syncthreads();
      // each event's place; skipped events (past m) and the ragged tile's
      // empty slots have none
      unsigned to[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int d = digit_of(rec[r].x, shift, bits);
        to[r] = lo + r * 32 < count && rec[r].x != kSkip
                    ? sh.rank.base[d] + sh.rank.warp[d][warp] + rank[r] : kSkip;
      }
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        if (to[r] == kSkip) continue;
        s.rec[dst][to[r]] = rec[r];
        if (m.k > 3) s.rec3[dst][to[r]] = rec3[r];
      }
      __syncthreads();
    }
    grid.sync();
    if (pass == 0) count -= __ldcg(s.totals + (1 << bits));  // the m live events
    src = dst;
  }

  // the run pass: the thread at a run's first position adds its events,
  // kBatch records loaded at once
  const uint4* recs = s.rec[src];
  const float* recs3 = s.rec3[src];
  const unsigned* keys = reinterpret_cast<const unsigned*>(recs);  // a record's first word
  for (long long j = blockIdx.x * (long long)kThreads + tid; j < count;
       j += (long long)gridDim.x * kThreads) {
    const unsigned c = __ldcg(keys + 4 * j);
    if (j > 0 && __ldcg(keys + 4 * (j - 1)) == c) continue;  // not a run's first event
    float a[kMaxMaps];
#pragma unroll
    for (int k = 0; k < kMaxMaps; ++k) a[k] = k < m.k ? m.acc[k][c] : 0.0f;
    for (long long t = j; t < count; t += kBatch) {
      unsigned kb[kBatch];
      float v[kMaxMaps][kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool in = t + b < count;
        const uint4 r = in ? __ldcg(recs + t + b) : make_uint4(~c, 0u, 0u, 0u);
        kb[b] = r.x;
        v[0][b] = __uint_as_float(r.y);
        v[1][b] = __uint_as_float(r.z);
        v[2][b] = __uint_as_float(r.w);
        v[3][b] = in && m.k > 3 ? __ldcg(recs3 + t + b) : 0.0f;
      }
      int len = 0;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) len += len == b && kb[b] == c;
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
}

// Resident blocks of scatter_sort an SM can hold, per device (the
// cooperative launch's limit), found once.
int blocks_per_sm(int dev) {
  static int cached[64] = {};
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_sort, kThreads, 0) !=
      cudaSuccess) {
    return -1;
  }
  if (dev >= 0 && dev < 64) cached[dev] = per_sm;
  return per_sm;
}

}  // namespace

// cells: i64[n] device memory; deltas / acc: host arrays of k device
// pointers (f32[n] deltas, f32[size] accumulators, added to in place), k in
// [1, 4]; skip_zeros: the accumulators hold no -0.0, so all-zero events may
// drop; passes x digit_bits: the key bits sorted, enough for size - 1;
// scratch: 32-bit words, 16-byte aligned, (9 + 2 (k == 4)) n + (tiles + 1)
// x (2^digit_bits + 1) of them (two buffers of 16-byte records, the first
// pass's keys, two of the fourth deltas, the tiles' digit counts, the
// digits' totals; tiles of kTileEvents; erosion/scatter_cuda.scratch_words).
extern "C" int noize_scatter_in_order(const long long* cells, const float* const* deltas,
                                      float* const* acc, int k, long long n, long long size,
                                      int skip_zeros, int passes, int digit_bits,
                                      int* scratch, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxMaps || n < 0 || n >= INT_MAX || size < 1 || size >= INT_MAX ||
      passes < 1 || passes > kMaxPasses || digit_bits < 1 || digit_bits > kMaxDigitBits ||
      ((size - 1) >> (passes * digit_bits)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  Maps m;
  m.k = k;
  for (int i = 0; i < kMaxMaps; ++i) {
    m.d[i] = i < k ? deltas[i] : nullptr;
    m.acc[i] = i < k ? acc[i] : nullptr;
  }
  Sort s;
  s.n = n;
  s.size = size;
  s.skip_zeros = skip_zeros;
  s.passes = passes;
  s.digit_bits = digit_bits;
  unsigned* w = reinterpret_cast<unsigned*>(scratch);  // 16-byte aligned
  s.rec[0] = reinterpret_cast<uint4*>(w);
  s.rec[1] = reinterpret_cast<uint4*>(w + 4 * n);
  s.keys = w + 8 * n;
  s.rec3[0] = reinterpret_cast<float*>(w + 9 * n);
  s.rec3[1] = reinterpret_cast<float*>(w + 10 * n);
  s.hist = w + (k == kMaxMaps ? 11 : 9) * n;
  s.totals = s.hist + (size_t)((n + kTileEvents - 1) / kTileEvents) * ((1 << digit_bits) + 1);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = blocks_per_sm(dev);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a thread an event for the run pass (a warp's runs go in lockstep, so
  // a thread that walked two would put the two on one chain), up to what
  // can be resident
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < (long long)per_sm * sms ? want : per_sm * sms);
  void* args[] = {&cells, &m, &s};
  err = cudaLaunchCooperativeKernel((void*)scatter_sort, grid, kThreads, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
