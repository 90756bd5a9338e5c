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

}  // namespace

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
