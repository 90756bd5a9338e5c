// K4 and K5 — pool automata: WATER_STEPS x 4 phases of standing-water
// spread with drain detection.
//
// K4 (noize_pool_automata, even grids) replaces
// noize_tpu/erosion/pool_pallas.py:_mega_call (entry
// pool_automata_pallas_mega, used at >= 2048^2) and _fused_pair_call (entry
// pool_automata_pallas_pair_fused, used below); the entries of
// _phase_pair_call and _fused_quad_call run on it too.  All compute
// erosion/pool.py:pool_automata's (pool, drains) on the half-row pair
// layout.
//
// K5 (noize_pool_automata_full, any grid, odd included) replaces
// pool_pallas.py:_phase_call (entry pool_automata_pallas): the full-grid
// masked phases of pool.py:_pool_automata_fullgrid / _spread_phase, which
// the reference runs at odd sizes (Unity's 2^n + 1 heightmaps).  It shares
// K4's core launch and differs in the add order of the apply launch:
// _spread_phase scatters direction by direction (up, right, down, left),
// each as the neighbour's transfer then the cell's own border self-return,
// where _phase_pair.scatter adds an active cell's border returns as
// right, left, vertical.
//
// Bound: the least time for a call is set by the float32 rate — about 98
// operations per active cell (a quarter of the cells) and 5 adds per cell
// each phase, 40 phases at WATER_STEPS = 10, against 16 bytes a cell in
// and out (chip_smoke.py counts both).  What limits this design is memory
// traffic and launches: every phase re-reads height and pool from device
// memory and writes and reads nine scratch planes, in 80 launches a call.
//
// Design: each phase is two launches.
//   (a) core: one thread per active lattice cell (rows z = 2j + zoff,
//       columns x = 2k + ((xoff + j) & 1)) reads the phase-start snapshot
//       and runs pool._phase_core: the ascending (key, direction) rank, the
//       4 sequential sub-steps, and the per-direction transfers and drains,
//       written to compact half^2 scratch planes, half = ceil(res / 2),
//       at (j, k) = (z >> 1, x >> 1).
//   (b) apply: one thread per cell adds the incoming transfers to its own
//       water (or, for an active cell, to its post-sub-step water) in the
//       exact add order of pool._phase_pair.scatter (K4) or
//       pool._spread_phase (K5), and its drain contributions onto the
//       drain map, so every f32 sum matches.
// Phases run in _PHASE_ORDER; drains accumulate across phases in that
// order.  Transfers from inactive cells are exactly +0 in the reference and
// adding +0 to non-negative water changes nothing, so apply skips them.
//
// The wetness gate (pool.MIN_WATER) never syncs the host: the init launch
// copies the pool, zeroes the drains and raises a device flag if any cell
// holds >= MIN_WATER; every later launch returns at once when the flag is
// 0.  A grid below the gate is a bit-exact fixed point of the automata.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kMinWater = 1e-3f;  // erosion/pool.py MIN_WATER

using noize::add;
using noize::mul;
using noize::sub;

__global__ void pool_init(const float* __restrict__ pool_in, float* __restrict__ pool,
                          float* __restrict__ drains, int* flag, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p = pool_in[i];
  pool[i] = p;
  drains[i] = 0.0f;
  if (p >= kMinWater) *flag = 1;
}

// half = ceil(res / 2): lattice rows and columns of a phase.
__host__ __device__ __forceinline__ int half_of(int res) { return (res + 1) >> 1; }

// Scratch layout: plane 0 = post-sub-step water of each active cell,
// planes 1..4 = transfers toward up/right/down/left, planes 5..8 = drains
// toward up/right/down/left; each plane is half^2, row j, column k.  On an
// odd grid the last lattice row or column of a phase may fall off the
// grid; those threads return.
__global__ void pool_core(const float* __restrict__ h, const float* __restrict__ pool,
                          const int* __restrict__ flag, float* __restrict__ scratch,
                          int res, int xoff, int zoff, int drain_particles) {
  if (*flag == 0) return;
  const int half = half_of(res);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (k >= half || j >= half) return;
  const int z = 2 * j + zoff;
  const int x = 2 * k + ((xoff + j) & 1);
  if (z >= res || x >= res) return;
  const size_t i = (size_t)z * res + x;
  // neighbour order up (z+1), right (x+1), down (z-1), left (x-1); a
  // neighbour off the grid aliases the cell itself (SafeIdx)
  const size_t nidx[4] = {
      (size_t)noize::clampi(z + 1, 0, res - 1) * res + x,
      (size_t)z * res + noize::clampi(x + 1, 0, res - 1),
      (size_t)noize::clampi(z - 1, 0, res - 1) * res + x,
      (size_t)z * res + noize::clampi(x - 1, 0, res - 1),
  };
  const float hl = h[i];
  float nh[4], nw[4], key[4];
  bool elig[4];
  for (int d = 0; d < 4; ++d) {
    nh[d] = h[nidx[d]];
    nw[d] = pool[nidx[d]];
    key[d] = add(nh[d], nw[d]);
    elig[d] = (nw[d] <= 0.0f) && (hl >= nh[d]);
  }
  // rank_d: the sub-step at which direction d is visited (ascending key,
  // ties in direction order) — pool._phase_core's pairwise form
  const float a01 = key[0] <= key[1] ? 1.0f : 0.0f;
  const float a02 = key[0] <= key[2] ? 1.0f : 0.0f;
  const float a03 = key[0] <= key[3] ? 1.0f : 0.0f;
  const float a12 = key[1] <= key[2] ? 1.0f : 0.0f;
  const float a13 = key[1] <= key[3] ? 1.0f : 0.0f;
  const float a23 = key[2] <= key[3] ? 1.0f : 0.0f;
  const float rank[4] = {
      sub(sub(sub(3.0f, a01), a02), a03),
      sub(sub(add(2.0f, a01), a12), a13),
      sub(add(add(1.0f, a02), a12), a23),
      add(add(a03, a13), a23),
  };
  float h_water = pool[i];
  float t_height = add(hl, h_water);
  float moved[4];
  bool drain_s[4];
  for (int e = 0; e < 4; ++e) {
    const float fe = static_cast<float>(e);
    const bool h0 = rank[0] == fe, h1 = rank[1] == fe, h2 = rank[2] == fe;
    const float key_e = h0 ? key[0] : (h1 ? key[1] : (h2 ? key[2] : key[3]));
    const float bw_e = h0 ? nw[0] : (h1 ? nw[1] : (h2 ? nw[2] : nw[3]));
    const bool elig_e = (h0 && elig[0]) || (h1 && elig[1]) || (h2 && elig[2]) ||
                        (rank[3] == fe && elig[3]);
    const float diff_v = sub(t_height, key_e);
    const bool can = h_water >= kMinWater;
    const float clipv = noize::fmin2(noize::fmax2(mul(0.25f, diff_v), mul(-0.25f, bw_e)),
                                     mul(0.25f, h_water));
    const float m = can ? (elig_e ? h_water : clipv) : 0.0f;
    h_water = sub(h_water, m);
    t_height = add(hl, h_water);
    moved[e] = m;
    drain_s[e] = elig_e;
  }
  float deltas[4], drain_out[4];
  for (int d = 0; d < 4; ++d) {
    // demux: route the sub-step volumes back to directions
    deltas[d] = rank[d] == 0.0f ? moved[0]
              : (rank[d] == 1.0f ? moved[1] : (rank[d] == 2.0f ? moved[2] : moved[3]));
    drain_out[d] = 0.0f;
  }
  if (drain_particles) {
    float drain_amt = drain_s[0] ? moved[0] : 0.0f;
    for (int e = 1; e < 4; ++e) drain_amt = add(drain_amt, drain_s[e] ? moved[e] : 0.0f);
    const float drain_e = drain_s[0] ? 0.0f
                        : (drain_s[1] ? 1.0f : (drain_s[2] ? 2.0f : (drain_s[3] ? 3.0f : -1.0f)));
    for (int d = 0; d < 4; ++d) {
      drain_out[d] = rank[d] == drain_e ? drain_amt : 0.0f;
      deltas[d] = sub(deltas[d], drain_out[d]);
    }
  }
  const size_t plane = (size_t)half * half;
  const size_t o = (size_t)j * half + k;
  scratch[o] = h_water;
  for (int d = 0; d < 4; ++d) {
    scratch[(1 + d) * plane + o] = deltas[d];
    scratch[(5 + d) * plane + o] = drain_out[d];
  }
}

// Reads plane `p` (1..8) of the active cell at global (z, x) if it is on
// this phase's lattice, else +0 (an inactive cell moves nothing).
__device__ __forceinline__ float from_cell(const float* scratch, int p, int z, int x,
                                           int res, int xoff, int zoff) {
  if (z < 0 || z >= res || x < 0 || x >= res) return 0.0f;
  if ((z & 1) != zoff) return 0.0f;
  const int j = (z - zoff) >> 1;
  if ((x & 1) != ((xoff + j) & 1)) return 0.0f;
  const int half = half_of(res);
  return scratch[(size_t)p * half * half + (size_t)j * half + (x >> 1)];
}

__global__ void pool_apply(float* __restrict__ pool, float* __restrict__ drains,
                           const int* __restrict__ flag, const float* __restrict__ scratch,
                           int res, int xoff, int zoff, int drain_particles) {
  if (*flag == 0) return;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const int half = half_of(res);
  // planes: 1 + d transfers, 5 + d drains; d = 0 up, 1 right, 2 down, 3 left
  float v, dv;
  if ((z & 1) == zoff) {
    const int j = (z - zoff) >> 1;
    if ((x & 1) == ((xoff + j) & 1)) {
      // active cell: own water, then the border self-returns in
      // _phase_pair.scatter order (right, left, vertical)
      const size_t o = (size_t)j * half + (x >> 1);
      const size_t plane = (size_t)half * half;
      v = scratch[o];
      dv = 0.0f;
      if (x == res - 1) {
        v = add(v, scratch[2 * plane + o]);
        dv = add(dv, scratch[6 * plane + o]);
      }
      if (x == 0) {
        v = add(v, scratch[4 * plane + o]);
        dv = add(dv, scratch[8 * plane + o]);
      }
      if (z == 0) {
        v = add(v, scratch[3 * plane + o]);
        dv = add(dv, scratch[7 * plane + o]);
      } else if (z == res - 1) {
        v = add(v, scratch[1 * plane + o]);
        dv = add(dv, scratch[5 * plane + o]);
      }
    } else {
      // inactive cell of an active row: from the left neighbour giving
      // right, then from the right neighbour giving left
      v = add(add(pool[i], from_cell(scratch, 2, z, x - 1, res, xoff, zoff)),
              from_cell(scratch, 4, z, x + 1, res, xoff, zoff));
      dv = add(add(0.0f, from_cell(scratch, 6, z, x - 1, res, xoff, zoff)),
               from_cell(scratch, 8, z, x + 1, res, xoff, zoff));
    }
  } else {
    // complement row: from the cell below giving up, then from the cell
    // above giving down
    v = add(add(pool[i], from_cell(scratch, 1, z - 1, x, res, xoff, zoff)),
            from_cell(scratch, 3, z + 1, x, res, xoff, zoff));
    dv = add(add(0.0f, from_cell(scratch, 5, z - 1, x, res, xoff, zoff)),
             from_cell(scratch, 7, z + 1, x, res, xoff, zoff));
  }
  pool[i] = v;
  if (drain_particles) drains[i] = add(drains[i], dv);
}

// K5's apply: pool._spread_phase's order.  For each direction d (up,
// right, down, left) the cell adds the transfer of the neighbour that gives
// toward it (shift_zero(delta_d, -dr, -dc)), then its own border
// self-return (where(border_d, delta_d, 0)).  Every add the reference makes
// is made, zeros included, so even the sign of a zero matches.
__global__ void pool_apply_full(float* __restrict__ pool, float* __restrict__ drains,
                                const int* __restrict__ flag, const float* __restrict__ scratch,
                                int res, int xoff, int zoff, int drain_particles) {
  if (*flag == 0) return;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const int half = half_of(res);
  const size_t plane = (size_t)half * half;
  const size_t o = (size_t)(z >> 1) * half + (x >> 1);
  const bool active = ((z & 1) == zoff) && ((x & 1) == ((xoff + (z >> 1)) & 1));
  // _DIRS (pool.py): up (+1, 0), right (0, +1), down (-1, 0), left (0, -1)
  const int dz[4] = {1, 0, -1, 0};
  const int dx[4] = {0, 1, 0, -1};
  const bool border[4] = {z == res - 1, x == res - 1, z == 0, x == 0};
  float v = active ? scratch[o] : pool[i];
  float dv = 0.0f;
  for (int d = 0; d < 4; ++d) {
    v = add(v, from_cell(scratch, 1 + d, z - dz[d], x - dx[d], res, xoff, zoff));
    v = add(v, (active && border[d]) ? scratch[(1 + d) * plane + o] : 0.0f);
    dv = add(dv, from_cell(scratch, 5 + d, z - dz[d], x - dx[d], res, xoff, zoff));
    dv = add(dv, (active && border[d]) ? scratch[(5 + d) * plane + o] : 0.0f);
  }
  pool[i] = v;
  if (drain_particles) drains[i] = add(drains[i], dv);
}

enum class Order { kPair, kFull };

// WATER_STEPS x 4 phases in _PHASE_ORDER (pool.py): (xoff, zoff) for xoff
// in (0, 1) for zoff in (0, 1); drains accumulate across phases in order.
int run_automata(const float* height, const float* pool_in, float* pool_out, float* drains,
                 int* flag, float* scratch, int res, int iterations, int drain_particles,
                 cudaStream_t stream, Order order) {
  const int n = res * res;
  cudaMemsetAsync(flag, 0, sizeof(int), stream);
  pool_init<<<(n + 255) / 256, 256, 0, stream>>>(pool_in, pool_out, drains, flag, n);
  const dim3 block(32, 8);
  const dim3 core_grid = noize::grid2d(half_of(res), half_of(res), block);
  const dim3 apply_grid = noize::grid2d(res, res, block);
  for (int it = 0; it < iterations; ++it) {
    for (int xoff = 0; xoff < 2; ++xoff) {
      for (int zoff = 0; zoff < 2; ++zoff) {
        pool_core<<<core_grid, block, 0, stream>>>(height, pool_out, flag, scratch, res, xoff,
                                                   zoff, drain_particles);
        if (order == Order::kPair) {
          pool_apply<<<apply_grid, block, 0, stream>>>(pool_out, drains, flag, scratch, res,
                                                       xoff, zoff, drain_particles);
        } else {
          pool_apply_full<<<apply_grid, block, 0, stream>>>(pool_out, drains, flag, scratch,
                                                            res, xoff, zoff, drain_particles);
        }
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: 9 * ceil(res/2)^2 floats for both entries.
extern "C" int noize_pool_automata(const float* height, const float* pool_in, float* pool_out,
                                   float* drains, int* flag, float* scratch, int res,
                                   int iterations, int drain_particles, void* stream_ptr) {
  if (res < 2 || res % 2 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_automata(height, pool_in, pool_out, drains, flag, scratch, res, iterations,
                      drain_particles, static_cast<cudaStream_t>(stream_ptr), Order::kPair);
}

extern "C" int noize_pool_automata_full(const float* height, const float* pool_in,
                                        float* pool_out, float* drains, int* flag,
                                        float* scratch, int res, int iterations,
                                        int drain_particles, void* stream_ptr) {
  if (res < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_automata(height, pool_in, pool_out, drains, flag, scratch, res, iterations,
                      drain_particles, static_cast<cudaStream_t>(stream_ptr), Order::kFull);
}
