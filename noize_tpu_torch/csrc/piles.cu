// K6 — the exact PileSolver: every selected pile's Manhattan-ring sweeps
// and commit, in one launch.
//
// Not a TPU kernel's port: the reference (noize_tpu/erosion/sediment.py,
// _solve_pile, _handle_pile and exact_pile_deposit) runs its solver as one
// XLA program, a while_loop of scans over the visits.  The plain versions
// are erosion/sediment.exact_pile_deposit_plain and solve_pile_table_plain.
//
// Bound: the roofline bound (the height read and written once, 8 bytes a
// cell) is far below what the visits take.  A sweep at radius 15 is 3,200
// visits in 15 rounds; round rnd visits the first ends[rnd - 1] slots in
// slot order, and each visit reads the amount the ones before it placed.
// What bounds a pile is its chain of rounds and, across piles, the chain
// of piles whose slots share cells: a pile reads what the piles before it
// on those cells committed.
//
// Design.  The visits of a round are independent but for the amount
// placed.  Slot 0's visit comes first and fixes the level of the round's
// other slots (level = vals[0] + inc * rnd); after it a slot's test
// (valid, vals[k] < level) reads only its own cache.  While the volume
// lasts every deposit is a whole increment, so after n deposits a sweep
// has placed deps[n] (deps[0] = 0, deps[n] = deps[n - 1] + inc, one
// rounded add at a time; the wrapper builds the table once an increment
// and radius).  left - deps[n] does not grow with n, so the deposits that
// are whole are the first nstar, nstar the first n with
// left - deps[n] < inc: one search a sweep (first_short, 32 probes a step
// over the table).  A round is then a ranking: one warp tests 32 slots a
// step in slot order, a ballot ranks the successes, those ranked below
// nstar add inc in parallel.  From rank nstar on (the tail) the successes
// run one at a time, as the reference writes them.  Once the amount left
// is <= 0 no later visit of the sweep deposits, so the sweep ends there:
// the amount placed, and so left - placed, is what the full walk gives.
// Every float op is a __f*_rn in the reference's order (built with
// -fmad=false): remaining = left - placed, level = vals[0] + inc * rnd,
// diff = min(inc, remaining), vals[k] + diff, placed + diff, then
// left - placed for the next sweep.  A sweep that places nothing leaves
// the state as it was, so the loop stops there.
//
// The map entry (noize_exact_piles) runs a persistent grid, launched
// cooperatively so that every block is resident: one warp a block, one
// pile at a time, piles p = blockIdx.x, + gridDim.x, ...  A pile waits
// for each earlier pile of positive volume whose centre lies within twice
// the slots' reach (|off_r| + |off_c| at most; the cells two piles read
// can meet only then), then loads its slots, solves, commits and
// publishes its done flag (a fence, then a release store; readers spin
// on an acquire load and read the height through L2).  Piles that do not
// overlap run at once.  The commit keeps the last modified in-grid slot
// on a cell (later[k] chains the slots on one cell), so a pile writes each
// cell once and its lanes store in parallel.  The flags are reset at the
// start, before one grid barrier.
//
// The table entry (noize_pile_table) runs the same visit routine on a pile
// table that every rank of the sharded EXACT_PILES solve holds
// (parallel/sharded_erosion._sharded_write_sediment_exact, after
// noize_tpu/parallel/sharded_erosion.py:289-410): K piles of S slots each,
// their cached values gathered from the ranks that own the cells, and the
// grid cell each slot reads (cid, clamped).  The map is not there, so a
// pile reads what the piles before it committed from the table: after pile
// j, every slot of a later pile that reads a cell pile j committed takes
// the committed value.  The table carries no grid geometry, so its piles
// run in order in one block.  A pile commits a cell once: of the modified,
// in-grid slots on one cell the last one in slot order (the highest
// occurrence rank, sediment._pile_tables' dup_higher) is the effective
// write.  A hash table of the pile's written cells (cid -> last slot;
// linear probing, at most half full, in global memory the caller gives)
// finds both: the effective slot of each written cell, and which cells of
// the later piles' slots were written.  The overlay is S lookups a later
// pile, spread over the block; the visits run on its first warp.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using noize::add;
using noize::mul;
using noize::sub;

constexpr int kTableThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;

// The first n in [0, visits] with left - deps[n] < inc, visits + 1 if none
// (the predicate holds from some n on); the whole warp, 32 probes a step.
__device__ int first_short(const float* __restrict__ deps, int visits, float left, float inc) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = visits + 1;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int n = lo + lane * step;
    const unsigned hit = __ballot_sync(kWarp, n < hi && sub(left, __ldg(deps + n)) < inc);
    if (hit) {
      const int t = __ffs(hit) - 1;
      hi = lo + t * step;
      if (t > 0) lo = hi - step + 1;
    } else {
      lo += min(31, (hi - 1 - lo) / step) * step + 1;
    }
  }
  return lo;
}

// One pile's sweeps on its slot cache, by one whole warp: vals and flags
// (bit 0 in grid, bit 1 modified) in shared memory.  Lane l keeps slots
// k = l mod 32, so no lane reads a slot another writes; vals[0] stays in
// a register through the sweeps.  Ends with a warp barrier.
__device__ void solve_pile(float* vals, unsigned char* flags, const int* __restrict__ ends,
                           int radius, const float* __restrict__ deps, int visits, float inc,
                           float vol) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool valid0 = flags[0] & 1;
  float v0 = vals[0];
  float left = vol;
  while (left > 0.0f) {
    // the sweep's first nstar deposits are whole: placed = deps[count]; then
    // the tail, one deposit at a time: placed = dep
    const int nstar = first_short(deps, visits, left, inc);
    int count = 0;
    float dep = 0.0f;
    auto take = [&]() -> float {
      if (count < nstar) {
        if (++count == nstar) dep = deps[nstar];
        return inc;
      }
      const float diff = noize::fmin2(inc, sub(left, dep));
      dep = add(dep, diff);
      return diff;
    };
    auto spent = [&]() { return count >= nstar && !(sub(left, dep) > 0.0f); };
    for (int rnd = 1; rnd <= radius && !spent(); ++rnd) {
      const float step = mul(inc, static_cast<float>(rnd));
      if (valid0 && v0 < add(v0, step)) {
        v0 = add(v0, take());
        if (lane == 0) flags[0] |= 2;
      }
      const float level = add(v0, step);
      const int end = ends[rnd - 1];
      for (int base = 0; base < end && !spent(); base += 32) {
        const int k = base + lane;
        const bool in = k > 0 && k < end;
        const float v = in ? vals[k] : 0.0f;
        const bool ok = in && (flags[k] & 1) && v < level;
        const unsigned hits = __ballot_sync(kWarp, ok);
        if (!hits) continue;
        const int rank = __popc(hits & below);
        const int whole = min(__popc(hits), max(nstar - count, 0));
        if (ok && rank < whole) {
          vals[k] = add(v, inc);
          flags[k] |= 2;
        }
        if (whole > 0 && (count += whole) == nstar) dep = deps[nstar];
        for (unsigned rest = __ballot_sync(kWarp, ok && rank >= whole); rest && !spent();
             rest &= rest - 1) {
          const float diff = take();
          if (lane == __ffs(rest) - 1) {
            vals[k] = add(v, diff);
            flags[k] |= 2;
          }
        }
      }
    }
    const float placed = count < nstar ? deps[count] : dep;
    if (placed == 0.0f) break;
    left = sub(left, placed);
  }
  if (lane == 0) vals[0] = v0;
  __syncwarp();
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(32)
exact_piles(float* height, const float* __restrict__ vols, const long long* __restrict__ idxs,
            int piles, int rows, int cols, const int* __restrict__ off_r,
            const int* __restrict__ off_c, const int* __restrict__ later,
            const int* __restrict__ ends, int radius, int slots, const float* __restrict__ deps,
            int visits, float inc, int reach, unsigned* done) {
  extern __shared__ float vals[];
  unsigned char* flags = reinterpret_cast<unsigned char*>(vals + slots);
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int p = blockIdx.x; p < piles; p += gridDim.x) done[p] = 0;
  }
  cg::this_grid().sync();
  for (int p = blockIdx.x; p < piles; p += gridDim.x) {
    const float vol = vols[p];
    if (vol > 0.0f) {
      const long long idx = idxs[p];
      const int r0 = static_cast<int>(idx / cols), c0 = static_cast<int>(idx % cols);
      // wait for the earlier piles whose slots may share a cell with ours
      for (int i = lane; i < p; i += 32) {
        const long long j = idxs[i];
        if (vols[i] > 0.0f && llabs(j / cols - r0) + llabs(j % cols - c0) <= 2LL * reach) {
          while (load_acquire(done + i) == 0) __nanosleep(32);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int k = lane; k < slots; k += 32) {
        const int r = r0 + off_r[k], c = c0 + off_c[k];
        vals[k] = __ldcg(height + (size_t)noize::clampi(r, 0, rows - 1) * cols +
                         noize::clampi(c, 0, cols - 1));
        flags[k] = r >= 0 && c >= 0 && r < rows && c < cols ? 1 : 0;
      }
      __syncwarp();
      solve_pile(vals, flags, ends, radius, deps, visits, inc, vol);
      // the last modified slot on each cell writes it
#pragma unroll 4
      for (int k = lane; k < slots; k += 32) {
        bool last = flags[k] == 3;
        for (int j = later[k]; j >= 0 && last; j = later[j]) last = !(flags[j] & 2);
        if (last) height[(size_t)(r0 + off_r[k]) * cols + (c0 + off_c[k])] = vals[k];
      }
      __threadfence();
    }
    __syncthreads();
    if (lane == 0) store_release(done + p, 1u);
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

__global__ void __launch_bounds__(kTableThreads)
pile_table(const unsigned char* __restrict__ valid, const float* __restrict__ vols,
           const long long* __restrict__ cid, float* __restrict__ work,
           float* __restrict__ com_vals, unsigned char* __restrict__ com_eff,
           unsigned long long* __restrict__ keys, int* __restrict__ last, int cap, int piles,
           const int* __restrict__ ends, int radius, int slots, const float* __restrict__ deps,
           int visits, float inc) {
  extern __shared__ float vals[];
  unsigned char* flags = reinterpret_cast<unsigned char*>(vals + slots);  // 1 valid, 2 modified
  __shared__ int wrote;
  for (int p = 0; p < piles; ++p) {
    const size_t row = (size_t)p * slots;
    const float vol = vols[p];
    for (int k = threadIdx.x; k < slots; k += blockDim.x) {
      // a sweep visits every slot, adding 0 where it deposits nothing:
      // -0.0 becomes +0.0
      vals[k] = vol > 0.0f ? add(work[row + k], 0.0f) : work[row + k];
      flags[k] = valid[row + k] ? 1 : 0;
    }
    if (threadIdx.x == 0) wrote = 0;
    __syncthreads();
    if (threadIdx.x < 32 && vol > 0.0f) solve_pile(vals, flags, ends, radius, deps, visits, inc, vol);
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

bool bad_tables(int radius, int slots, int visits, float increment, size_t bytes) {
  return radius < 1 || slots < 1 || visits < slots || !(increment > 0.0f) || bytes > 48 * 1024;
}

}  // namespace

// The table solve: valid (u8[piles x slots]), vols (f32[piles]) and cid
// (i64[piles x slots], the clamped cell each slot reads); work holds the
// gathered slot values (f32[piles x slots]) and is overlaid in place;
// com_vals (f32) and com_eff (u8) receive each pile's solved values and
// effective writes.  keys (u64[cap], all ~0) and last (i32[cap], all -1):
// the hash table, cap a power of two >= 2 x slots, left as given.  ends
// (i32[radius]): the slot table; deps (f32[visits + 1]): whole increments
// summed, visits the visits of one sweep.  All pointers are device memory.
extern "C" int noize_pile_table(const unsigned char* valid, const float* vols,
                                const long long* cid, float* work, float* com_vals,
                                unsigned char* com_eff, unsigned long long* keys, int* last,
                                int cap, int piles, const int* ends, int radius, int slots,
                                const float* deps, int visits, float increment,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = (size_t)slots * (sizeof(float) + 1);
  if (piles < 0 || bad_tables(radius, slots, visits, increment, bytes) || cap < 2 * slots ||
      (cap & (cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (piles == 0) return static_cast<int>(cudaSuccess);
  pile_table<<<1, kTableThreads, bytes, stream>>>(valid, vols, cid, work, com_vals, com_eff,
                                                  keys, last, cap, piles, ends, radius, slots,
                                                  deps, visits, increment);
  return static_cast<int>(cudaGetLastError());
}

// height: rows x cols, updated in place.  vols (f32[piles]) and idxs
// (i64[piles], flat cell indices): the piles in processing order.  off_r,
// off_c, later (i32[slots]: the next slot on the same cell, or -1) and
// ends (i32[radius]): the slot tables (erosion/sediment._pile_tables);
// deps (f32[visits + 1]) as for the table entry; reach: the largest
// |off_r| + |off_c|.  done (u32[piles]): scratch.  All pointers are device
// memory.
extern "C" int noize_exact_piles(float* height, const float* vols, const long long* idxs,
                                 int piles, int rows, int cols, const int* off_r,
                                 const int* off_c, const int* later, const int* ends,
                                 int radius, int slots, const float* deps, int visits,
                                 float increment, int reach, unsigned* done,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = (size_t)slots * (sizeof(float) + 1);
  if (rows < 1 || cols < 1 || piles < 0 || reach < 1 ||
      bad_tables(radius, slots, visits, increment, bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (piles == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exact_piles, 32, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = piles < per_sm * sms ? piles : per_sm * sms;
  void* args[] = {&height, &vols,   &idxs,   &piles, &rows, &cols,   &off_r,     &off_c, &later,
                  &ends,   &radius, &slots, &deps,  &visits, &increment, &reach, &done};
  err = cudaLaunchCooperativeKernel((void*)exact_piles, grid, 32, args, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
