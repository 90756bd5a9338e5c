// K6 — the exact PileSolver: every selected pile's Manhattan-ring sweeps
// and commit, in one launch.
//
// Not a TPU kernel's port: the reference (noize_tpu/erosion/sediment.py,
// _solve_pile, _handle_pile and exact_pile_deposit) runs its solver as one
// XLA program, a while_loop of scans over the visits.  The plain version is
// erosion/sediment.exact_pile_deposit_plain.
//
// Bound: the visits are one serial chain.  Each reads the amount the ones
// before it placed and the pile cell's value, which the visits of the
// pile cell raise; the piles overlap and a pile reads what the piles before
// it committed.  The roofline bound (the height read and written once,
// 8 bytes a cell) is far below what a chain of dependent scalar operations
// takes: a sweep at radius 15 is 3,200 visits of about 8 operations.  As
// torch operations the same chain is some 25,000 launches and a host sync a
// sweep.
//
// Design: one block.  For each pile in the caller's order (ascending cell
// index; volumes <= 0 are skipped here, so the caller needs no host sync)
// the block loads the pile's S slot values (clamped reads, as the
// reference gathers them) and validity into shared memory, thread 0 runs
// the sweeps over the static slot tables (round rnd visits the first
// ends[rnd - 1] slots, in slot order), then commits the modified in-grid
// slots in slot order, so the last write to a cell wins.  A barrier after
// the commit makes the pile's writes visible to the next pile's loads.
// Every float op is a __f*_rn in the reference's order:
// remaining = amount - deposited, level = vals[0] + inc * rnd,
// diff = min(inc, remaining), vals[k] + diff, deposited + diff, then
// amount - deposited for the next sweep.  A sweep that places nothing
// leaves the state as it was, so the loop stops there.
//
// The table entry (noize_pile_table) runs the same visit loop on a pile
// table that every rank of the sharded EXACT_PILES solve holds
// (parallel/sharded_erosion._sharded_write_sediment_exact, after
// noize_tpu/parallel/sharded_erosion.py:289-410): K piles of S slots each,
// their cached values gathered from the ranks that own the cells, and the
// grid cell each slot reads (cid, clamped).  The map is not there, so a
// pile reads what the piles before it committed from the table: after pile
// j, every slot of a later pile that reads a cell pile j committed takes
// the committed value.  A pile commits a cell once: of the modified,
// in-grid slots on one cell the last one in slot order (the highest
// occurrence rank, sediment._pile_tables' dup_higher) is the effective
// write.  A hash table of the pile's written cells (cid -> last slot;
// linear probing, at most half full, in global memory the caller gives)
// finds both: the effective slot of each written cell, and which cells of
// the later piles' slots were written.  The overlay is S lookups a later
// pile, spread over the block; the visits stay on thread 0.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::add;
using noize::mul;
using noize::sub;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
exact_piles(float* __restrict__ height, const float* __restrict__ vols,
            const long long* __restrict__ idxs, int piles, int rows, int cols,
            const int* __restrict__ off_r, const int* __restrict__ off_c,
            const int* __restrict__ ends, int radius, int slots, float inc) {
  extern __shared__ float vals[];
  unsigned char* flags = reinterpret_cast<unsigned char*>(vals + slots);  // 1 valid, 2 modified
  for (int p = 0; p < piles; ++p) {
    const float vol = vols[p];
    if (!(vol > 0.0f)) continue;
    const long long idx = idxs[p];
    const int r0 = static_cast<int>(idx / cols), c0 = static_cast<int>(idx % cols);
    for (int k = threadIdx.x; k < slots; k += blockDim.x) {
      const int r = r0 + off_r[k], c = c0 + off_c[k];
      const bool valid = r >= 0 && c >= 0 && r < rows && c < cols;
      vals[k] = height[(size_t)noize::clampi(r, 0, rows - 1) * cols +
                       noize::clampi(c, 0, cols - 1)];
      flags[k] = valid ? 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float left = vol;
      while (left > 0.0f) {
        float deposited = 0.0f;
        for (int rnd = 1; rnd <= radius; ++rnd) {
          const float rf = static_cast<float>(rnd);
          const int end = ends[rnd - 1];
          for (int k = 0; k < end; ++k) {
            const float remaining = sub(left, deposited);
            const float level = add(vals[0], mul(inc, rf));
            const bool ok = (flags[k] & 1) && vals[k] < level && remaining > 0.0f;
            const float diff = ok ? noize::fmin2(inc, remaining) : 0.0f;
            vals[k] = add(vals[k], diff);
            if (ok) flags[k] |= 2;
            deposited = add(deposited, diff);
          }
        }
        if (deposited == 0.0f) break;
        left = sub(left, deposited);
      }
      for (int k = 0; k < slots; ++k) {
        if (flags[k] == 3) height[(size_t)(r0 + off_r[k]) * cols + (c0 + off_c[k])] = vals[k];
      }
    }
    __syncthreads();
  }
}

constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ unsigned slot_hash(unsigned long long key, int cap) {
  return static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >> 32) & (cap - 1);
}

// cell -> the last slot that wrote it
__device__ void hash_insert(unsigned long long* keys, int* last, int cap,
                            unsigned long long key, int k) {
  for (unsigned h = slot_hash(key, cap);; h = (h + 1) & (cap - 1)) {
    const unsigned long long prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicMax(&last[h], k);
      return;
    }
  }
}

__device__ int hash_find(const unsigned long long* keys, const int* last, int cap,
                         unsigned long long key) {
  for (unsigned h = slot_hash(key, cap);; h = (h + 1) & (cap - 1)) {
    const unsigned long long k = keys[h];
    if (k == key) return last[h];
    if (k == kEmpty) return -1;
  }
}

__global__ void __launch_bounds__(kThreads)
pile_table(const unsigned char* __restrict__ valid, const float* __restrict__ vols,
           const long long* __restrict__ cid, float* __restrict__ work,
           float* __restrict__ com_vals, unsigned char* __restrict__ com_eff,
           unsigned long long* __restrict__ keys, int* __restrict__ last, int cap, int piles,
           const int* __restrict__ ends, int radius, int slots, float inc) {
  extern __shared__ float vals[];
  unsigned char* flags = reinterpret_cast<unsigned char*>(vals + slots);  // 1 valid, 2 modified
  __shared__ int wrote;
  for (int p = 0; p < piles; ++p) {
    const size_t row = (size_t)p * slots;
    for (int k = threadIdx.x; k < slots; k += blockDim.x) {
      vals[k] = work[row + k];
      flags[k] = valid[row + k] ? 1 : 0;
    }
    if (threadIdx.x == 0) wrote = 0;
    __syncthreads();
    const float vol = vols[p];
    if (threadIdx.x == 0 && vol > 0.0f) {
      float left = vol;
      while (left > 0.0f) {
        float deposited = 0.0f;
        for (int rnd = 1; rnd <= radius; ++rnd) {
          const float rf = static_cast<float>(rnd);
          const int end = ends[rnd - 1];
          for (int k = 0; k < end; ++k) {
            const float remaining = sub(left, deposited);
            const float level = add(vals[0], mul(inc, rf));
            const bool ok = (flags[k] & 1) && vals[k] < level && remaining > 0.0f;
            const float diff = ok ? noize::fmin2(inc, remaining) : 0.0f;
            vals[k] = add(vals[k], diff);
            if (ok) flags[k] |= 2;
            deposited = add(deposited, diff);
          }
        }
        if (deposited == 0.0f) break;
        left = sub(left, deposited);
      }
    }
    __syncthreads();
    // the pile's written cells, each with its last writing slot
    for (int k = threadIdx.x; k < slots; k += blockDim.x) {
      com_vals[row + k] = vals[k];
      if (flags[k] == 3) {
        hash_insert(keys, last, cap, static_cast<unsigned long long>(cid[row + k]), k);
        wrote = 1;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < slots; k += blockDim.x) {
      com_eff[row + k] =
          flags[k] == 3 &&
          hash_find(keys, last, cap, static_cast<unsigned long long>(cid[row + k])) == k;
    }
    if (wrote) {
      // later piles read what this one committed
      const size_t later = (size_t)(p + 1) * slots, end = (size_t)piles * slots;
      for (size_t i = later + threadIdx.x; i < end; i += blockDim.x) {
        const int k = hash_find(keys, last, cap, static_cast<unsigned long long>(cid[i]));
        if (k >= 0) work[i] = vals[k];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < cap; i += blockDim.x) {
        keys[i] = kEmpty;
        last[i] = -1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The table solve: valid (u8[piles x slots]), vols (f32[piles]) and cid
// (i64[piles x slots], the clamped cell each slot reads); work holds the
// gathered slot values (f32[piles x slots]) and is overlaid in place;
// com_vals (f32) and com_eff (u8) receive each pile's solved values and
// effective writes.  keys (u64[cap], all ~0) and last (i32[cap], all -1):
// the hash table, cap a power of two >= 2 x slots, left as given.  ends
// (i32[radius]): the slot table.  All pointers are device memory.
extern "C" int noize_pile_table(const unsigned char* valid, const float* vols,
                                const long long* cid, float* work, float* com_vals,
                                unsigned char* com_eff, unsigned long long* keys, int* last,
                                int cap, int piles, const int* ends, int radius, int slots,
                                float increment, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = (size_t)slots * (sizeof(float) + 1);
  if (piles < 0 || radius < 1 || slots < 1 || !(increment > 0.0f) || bytes > 48 * 1024 ||
      cap < 2 * slots || (cap & (cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (piles == 0) return static_cast<int>(cudaSuccess);
  pile_table<<<1, kThreads, bytes, stream>>>(valid, vols, cid, work, com_vals, com_eff, keys,
                                             last, cap, piles, ends, radius, slots, increment);
  return static_cast<int>(cudaGetLastError());
}

// height: rows x cols, updated in place.  vols (f32[piles]) and idxs
// (i64[piles], flat cell indices): the piles in processing order.  off_r,
// off_c (i32[slots]) and ends (i32[radius]): the slot tables
// (erosion/sediment._pile_tables).  All pointers are device memory.
extern "C" int noize_exact_piles(float* height, const float* vols, const long long* idxs,
                                 int piles, int rows, int cols, const int* off_r,
                                 const int* off_c, const int* ends, int radius, int slots,
                                 float increment, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = (size_t)slots * (sizeof(float) + 1);
  if (rows < 1 || cols < 1 || piles < 0 || radius < 1 || slots < 1 || !(increment > 0.0f) ||
      bytes > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (piles == 0) return static_cast<int>(cudaSuccess);
  exact_piles<<<1, kThreads, bytes, stream>>>(height, vols, idxs, piles, rows, cols, off_r,
                                              off_c, ends, radius, slots, increment);
  return static_cast<int>(cudaGetLastError());
}
