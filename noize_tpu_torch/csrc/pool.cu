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
// the reference runs at odd sizes (Unity's 2^n + 1 heightmaps).  Its window
// entry (noize_pool_automata_window) runs the same phases on a window of a
// grid: the sharded pool's extended block, a group of water steps a call
// between halo exchanges (parallel/sharded_erosion._sharded_pool_automata,
// after noize_tpu/parallel/sharded_erosion.py:446-522, which exchanges once
// a step).  The two
// share one kernel, templated on the add order in which a phase's transfers
// land: _spread_phase scatters direction by direction (up, right, down, left),
// each as the neighbour's transfer then the cell's own border self-return,
// where _phase_pair.scatter adds an active cell's border returns as
// right, left, vertical.
//
// Bound: the least time for a call is set by the float32 rate — about 98
// operations per active cell (a quarter of the cells) and 5 adds per cell
// each phase, 40 phases at WATER_STEPS = 10, against 16 bytes a cell in
// and out (chip_smoke.py counts both).  Every op is its own instruction
// (-fmad=false), so the issue rate, not the data sheet's FMA rate, sets it.
// The design this replaces was bound by its own memory traffic instead: two
// launches a phase, nine scratch planes written and read back, about 41
// bytes a cell a phase in 81 launches a call.
//
// Design: one launch per water step, the phase chain of a tile in shared
// memory, as _mega_call kept a row window's in VMEM.  A phase moves water
// by at most one cell — an active cell reads its four neighbours, an
// inactive cell takes only from its adjacent active cells — so the pool a
// phase leaves at a cell depends on the phase-start state within 2 cells,
// and a water step (4 phases) on the state within 8.  Each block owns a
// kTile^2 output tile and loads the height, pool and drains of its window
// (the tile with an 8-cell halo; cp.async, all in flight at once) into
// shared memory.  Phase p of the launch then runs on the active lattice
// cells (rows z = 2j + zoff, columns x = 2k + ((xoff + j) & 1)) of the
// window less 2p + 1 cells a side, one thread per cell:
//   (a) core: pool._phase_core (phase_core below) on the phase-start
//       snapshot; the cell's post-sub-step water goes over its own pool cell
//       (no active cell reads another), its four transfers and its drain to
//       compact lattice planes at (z >> 1, x >> 1);
//   (b) scatter, after a barrier: the thread writes every cell that only
//       its cell gives to, in the add order of pool._phase_pair.scatter (K4)
//       or pool._spread_phase (K5) — its own cell with its border
//       self-returns, the complement cells above and below (each has one
//       neighbour on the lattice) and the inactive cell to its right, which
//       also takes the next active cell's left transfer from the planes —
//       and adds the drains of the tile's cells onto the tile's running sum
//       in phase order, so every f32 sum matches the reference's.
// The region still exact shrinks by 2 cells a phase; after 4 phases it is
// the tile, which is written back.  Global coordinates decide the grid's
// edge: the clamped neighbour, the border self-returns, the off-grid zero
// and the lattice parity; window cells beyond the grid are never read.
// Blocks read halos that other blocks write, so the pool ping-pongs
// between two buffers across launches; drains are read and written only in
// a block's own tile and stay in place.  A launch moves about 24 bytes a
// cell (the window's height and pool, 1.56x the tile; the pool out; the
// drains in and out) and issues the core's ~200 f32 ops per active cell
// plus the index arithmetic and the scatter: instruction issue, not
// memory, now bounds it, and two resident blocks an SM hide most of the
// window loads behind each other's phases.  Two water steps a launch (a
// 16-cell halo) were slower, as were other tile sides and block sizes
// (PERF.md section 6; scripts/pool_tile_sweep.py times the latter).
//
// A window: the map is rows x cols cells of a res^2 grid, its cell (0, 0)
// at the grid's (org_z, org_x), and lies in the grid.  Tiles start at the
// even grid coordinate at or before the origin, so local and global lattice
// parities agree for any origin; global coordinates still decide the grid's
// edge, and cells beyond the window (but on the grid) load as zeros, so the
// cells within 2 a phase of a window edge that is not the grid's edge are
// stale and the caller crops them.  The window's drains come in as the
// starting sum: each phase's drains add onto them in phase order, as the
// sharded pool adds each phase's cropped drain map onto its running sum.
// After step s (from 0) only the cells more than 8(s+1) from an inner edge
// are exact, so step s launches only the tiles that meet them: the stale
// ring is not computed on its way to the caller's crop, and the cells
// outside what the last step left exact are undefined.  The sharded pool
// runs all of a cycle's water steps in one call on a halo of 8 a step: one
// exchange, one init, k launches, instead of an exchange and a call a step.
//
// The wetness gate (pool.MIN_WATER) never syncs the host: the init launch
// copies the pool, copies the drains in (or zeroes them) and raises a
// device flag if any cell holds >= MIN_WATER; every later launch returns at
// once when the flag is 0.  A map below the gate is a bit-exact fixed point
// of the automata (a window's cells that are not stale depend on the
// window alone; the exact cells of a dry window stay exact after any
// number of steps, so one gate a call is exact).  A call is 1 + iterations
// kernels.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kMinWater = 1e-3f;  // erosion/pool.py MIN_WATER
constexpr int kTile = 64;           // output tile side
constexpr int kThreads = 512;       // threads per block
// tiles of even side from an even origin keep local and global lattice
// parities equal
static_assert(kTile % 2 == 0, "tile side must be even");

using noize::add;
using noize::copy_async;
using noize::copy_async_wait;
using noize::mul;
using noize::sub;

__global__ void pool_init(const float* __restrict__ pool_in, float* __restrict__ pool,
                          const float* __restrict__ drains_in, float* __restrict__ drains,
                          int* flag, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p = pool_in[i];
  pool[i] = p;
  drains[i] = drains_in != nullptr ? drains_in[i] : 0.0f;
  if (p >= kMinWater) *flag = 1;
}

// One active cell's phase (pool._phase_core): rank the 4 neighbours by
// ascending (height + pool, direction), run the 4 sequential sub-steps and
// route the moved volumes back to directions.  Neighbour order up (z+1),
// right (x+1), down (z-1), left (x-1).
struct Core {
  float water;             // the cell's water after its sub-steps
  float delta[4];          // transfer toward each direction
  float drain;             // water dropped at the drain site
  unsigned char drain_to;  // bit d: drain_out[d] = drain, else +0
};

__device__ __forceinline__ Core phase_core(float hl, float own, const float nh[4],
                                           const float nw[4], bool drain_particles) {
  float key[4];
  bool elig[4];
  for (int d = 0; d < 4; ++d) {
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
  float h_water = own;
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
  Core c;
  c.water = h_water;
  c.drain = 0.0f;
  c.drain_to = 0;
  for (int d = 0; d < 4; ++d) {
    // demux: route the sub-step volumes back to directions
    c.delta[d] = rank[d] == 0.0f ? moved[0]
               : (rank[d] == 1.0f ? moved[1] : (rank[d] == 2.0f ? moved[2] : moved[3]));
  }
  if (drain_particles) {
    float drain_amt = drain_s[0] ? moved[0] : 0.0f;
    for (int e = 1; e < 4; ++e) drain_amt = add(drain_amt, drain_s[e] ? moved[e] : 0.0f);
    const float drain_e = drain_s[0] ? 0.0f
                        : (drain_s[1] ? 1.0f : (drain_s[2] ? 2.0f : (drain_s[3] ? 3.0f : -1.0f)));
    c.drain = drain_amt;
    for (int d = 0; d < 4; ++d) {
      const bool to_d = rank[d] == drain_e;
      c.delta[d] = sub(c.delta[d], to_d ? drain_amt : 0.0f);
      c.drain_to |= static_cast<unsigned char>(to_d) << d;
    }
  }
  return c;
}

enum class Order { kPair, kFull };

// The adds an inactive cell's pool (or drain) v takes in one phase: `first`
// then `second` from its left then right neighbour (row) or from below
// then above (column).  _phase_pair.scatter adds the two; _spread_phase
// adds, for each direction up, right, down, left, the neighbour's transfer
// and the cell's +0 border term, zeros included, so even the sign of a zero
// matches.
template <Order kOrder>
__device__ __forceinline__ float take(bool row, float v, float first, float second) {
  if (kOrder == Order::kPair) return add(add(v, first), second);
  const float t[4] = {row ? 0.0f : first, row ? first : 0.0f, row ? 0.0f : second,
                      row ? second : 0.0f};
  for (int d = 0; d < 4; ++d) v = add(add(v, t[d]), 0.0f);
  return v;
}

// Where a launch's map lies on the grid: rows x cols cells from (org_z,
// org_x) of a res^2 grid; tiles start at (tz, tx), the even coordinates at
// or before the origin.
struct Map {
  int rows, cols, org_z, org_x, res, tz, tx;
  __device__ bool holds(int z, int x) const {
    return z >= org_z && z < org_z + rows && x >= org_x && x < org_x + cols;
  }
  __device__ size_t at(int z, int x) const {
    return (size_t)(z - org_z) * cols + (x - org_x);
  }
};

// Shared memory of a launch: the window (side W, origin (z0, x0) = tile
// origin - halo) holds height and pool; the compact lattice planes (side
// W / 2) hold each active cell's four transfers, its drain and the
// directions the drain went; the tile holds its running drain sum.
struct Window {
  static constexpr int kHalo = 8;  // a water step's reach
  static constexpr int kSide = kTile + 2 * kHalo;
  static constexpr int kHalf = kSide / 2;
  static constexpr int kCells = kSide * kSide;
  static constexpr int kLattice = kHalf * kHalf;
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kCells + 5 * kLattice + kTile * kTile) + kLattice;
};

// One launch: a water step (4 phases in _PHASE_ORDER) on one tile.
template <Order kOrder>
__global__ void __launch_bounds__(kThreads) pool_step(
    const float* __restrict__ height, const float* __restrict__ src, float* __restrict__ dst,
    float* __restrict__ drains, const int* __restrict__ flag, Map map, int drain_particles) {
  if (*flag == 0) return;
  constexpr int W = Window::kSide, H = Window::kHalf, R = Window::kHalo, L = Window::kLattice;
  extern __shared__ float smem[];
  float* hs = smem;                   // height, W x W
  float* ps = hs + Window::kCells;    // pool, W x W, updated in place
  float* xfer = ps + Window::kCells;  // transfers, 4 planes of H x H
  float* damt = xfer + 4 * L;         // drain, H x H
  float* dsum = damt + L;             // the tile's drains, kTile x kTile
  unsigned char* dto = reinterpret_cast<unsigned char*>(dsum + kTile * kTile);
  const int res = map.res;
  const int z0 = map.tz + blockIdx.y * kTile - R;
  const int x0 = map.tx + blockIdx.x * kTile - R;
  const int tid = threadIdx.x;
  const bool drain = drain_particles != 0;

  // the window's height and pool and the tile's drains, all in flight at
  // once (cp.async, zero-filled beyond the map)
  for (int i = tid; i < Window::kCells; i += kThreads) {
    const int z = z0 + i / W, x = x0 + i % W;
    const bool in = map.holds(z, x);
    const size_t g = in ? map.at(z, x) : 0;
    copy_async(hs + i, height + g, in);
    copy_async(ps + i, src + g, in);
  }
  if (drain) {
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int z = z0 + R + i / kTile, x = x0 + R + i % kTile;
      const bool in = map.holds(z, x);
      copy_async(dsum + i, drains + (in ? map.at(z, x) : 0), in);
    }
  }
  copy_async_wait();
  __syncthreads();

  // transfer and drain toward d of the active cell at compact index o
  auto xin = [&](int d, int o) { return xfer[d * L + o]; };
  auto din = [&](int d, int o) { return ((dto[o] >> d) & 1) ? damt[o] : 0.0f; };
  // a cell's new pool, and its drains if it lies in the tile
  auto put = [&](int lz, int lx, float v, float dv) {
    ps[lz * W + lx] = v;
    if (drain && static_cast<unsigned>(lz - R) < static_cast<unsigned>(kTile) &&
        static_cast<unsigned>(lx - R) < static_cast<unsigned>(kTile)) {
      float& acc = dsum[(lz - R) * kTile + (lx - R)];
      acc = add(acc, dv);
    }
  };
  // an inactive cell receives `first` then `second`: from its left then its
  // right neighbour in an active row, from below then above in a
  // complement row (+0 where that neighbour is off the lattice or the grid)
  auto receive = [&](bool row, int lz, int lx, float first, float second, float dfirst,
                     float dsecond) {
    const float v = take<kOrder>(row, ps[lz * W + lx], first, second);
    put(lz, lx, v, drain ? take<kOrder>(row, 0.0f, dfirst, dsecond) : 0.0f);
  };

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int xoff = (p >> 1) & 1, zoff = p & 1;  // _PHASE_ORDER: zoff varies fastest
    // the active cells of local rows and columns [lo, hi), n x n of them
    // (lo is odd, so each row and column starts at lo or lo + 1 by parity);
    // o = (lz >> 1) * H + (lx >> 1) is a cell's compact index
    const int lo = 2 * p + 1, hi = W - lo, n = (hi - lo) / 2;
    auto slot = [&](int i, int& lz, int& lx, int& o) {
      lz = lo + (zoff ^ 1) + 2 * (i / n);
      lx = lo + (((xoff + (z0 >> 1) + (lz >> 1)) & 1) ^ 1) + 2 * (i % n);
      o = (lz >> 1) * H + (lx >> 1);
      const int z = z0 + lz, x = x0 + lx;
      return z >= 0 && x >= 0 && z < res && x < res;
    };

    // (a) core: every active cell reads the phase-start snapshot
    for (int i = tid; i < n * n; i += kThreads) {
      int lz, lx, o;
      if (!slot(i, lz, lx, o)) continue;
      const int z = z0 + lz, x = x0 + lx;
      // a neighbour off the grid aliases the cell itself (SafeIdx)
      const int zu = noize::clampi(z + 1, 0, res - 1) - z0;
      const int zd = noize::clampi(z - 1, 0, res - 1) - z0;
      const int xr = noize::clampi(x + 1, 0, res - 1) - x0;
      const int xl = noize::clampi(x - 1, 0, res - 1) - x0;
      const int c = lz * W + lx;
      const int nidx[4] = {zu * W + lx, lz * W + xr, zd * W + lx, lz * W + xl};
      float nh[4], nw[4];
      for (int d = 0; d < 4; ++d) {
        nh[d] = hs[nidx[d]];
        nw[d] = ps[nidx[d]];
      }
      const Core r = phase_core(hs[c], ps[c], nh, nw, drain);
      ps[c] = r.water;
      for (int d = 0; d < 4; ++d) xfer[d * L + o] = r.delta[d];
      if (drain) {
        damt[o] = r.drain;
        dto[o] = r.drain_to;
      }
    }
    __syncthreads();

    // (b) scatter: every active cell writes itself and the inactive cells
    // only it gives to — the cells above and below it (a complement cell
    // has one neighbour on the lattice) and the cell to its right, which
    // also takes the left transfer of the next active cell; the cell at
    // x = 0 of an active row is written by its right neighbour.  Each
    // cell of the region [lo + 1, hi - 1) is written exactly once.
    for (int i = tid; i < n * n; i += kThreads) {
      int lz, lx, o;
      if (!slot(i, lz, lx, o)) continue;
      const int z = z0 + lz, x = x0 + lx;
      float dl[4], dd[4];
      for (int d = 0; d < 4; ++d) {
        dl[d] = xin(d, o);
        dd[d] = drain ? din(d, o) : 0.0f;
      }
      // its own water, then its border self-returns
      float v = ps[lz * W + lx], dv = 0.0f;
      if (kOrder == Order::kPair) {
        // _phase_pair.scatter: right, left, vertical
        if (x == res - 1) {
          v = add(v, dl[1]);
          dv = add(dv, dd[1]);
        }
        if (x == 0) {
          v = add(v, dl[3]);
          dv = add(dv, dd[3]);
        }
        if (z == 0) {
          v = add(v, dl[2]);
          dv = add(dv, dd[2]);
        } else if (z == res - 1) {
          v = add(v, dl[0]);
          dv = add(dv, dd[0]);
        }
      } else {
        // _spread_phase: up, right, down, left, each after the +0 its
        // inactive neighbour gives
        const bool border[4] = {z == res - 1, x == res - 1, z == 0, x == 0};
        for (int d = 0; d < 4; ++d) {
          v = add(add(v, 0.0f), border[d] ? dl[d] : 0.0f);
          dv = add(add(dv, 0.0f), border[d] ? dd[d] : 0.0f);
        }
      }
      put(lz, lx, v, dv);
      if (z + 1 < res) receive(false, lz + 1, lx, dl[0], 0.0f, dd[0], 0.0f);
      if (z > 0) receive(false, lz - 1, lx, 0.0f, dl[2], 0.0f, dd[2]);
      if (x + 1 < res) {
        // the next active cell, if on the grid and in this phase's region
        const bool next = x + 2 < res && lx + 2 < hi;
        receive(true, lz, lx + 1, dl[1], next ? xin(3, o + 1) : 0.0f, dd[1],
                next && drain ? din(3, o + 1) : 0.0f);
      }
      if (x == 1) receive(true, lz, 0 - x0, 0.0f, dl[3], 0.0f, dd[3]);
    }
    // cells with no neighbour on the lattice (a complement row's cell on the
    // grid's top or bottom row whose lattice neighbour is off the grid, and
    // a 1 x 1 grid's cell) take +0s
    {
      const int alo = lo + 1, ahi = hi - 1, aw = ahi - alo;
      if (z0 + alo <= 0 || z0 + ahi >= res) {
        for (int i = tid; i < 2 * aw; i += kThreads) {
          const int z = i < aw ? 0 : res - 1;
          const int lz = z - z0, lx = alo + (i < aw ? i : i - aw), x = x0 + lx;
          if (lz < alo || lz >= ahi || x < 0 || x >= res || (i >= aw && res == 1)) continue;
          const bool row_active = (z & 1) == zoff;
          const bool below_on = (x & 1) == ((xoff + ((z - 1) >> 1)) & 1);
          const bool written = row_active ? res > 1 || (x & 1) == ((xoff + (z >> 1)) & 1)
                                          : (z > 0 && below_on) || (z < res - 1 && !below_on);
          if (!written) receive(row_active, lz, lx, 0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int lz = R + i / kTile, lx = R + i % kTile;
    const int z = z0 + lz, x = x0 + lx;
    if (!map.holds(z, x)) continue;
    const size_t g = map.at(z, x);
    dst[g] = ps[lz * W + lx];
    if (drain) drains[g] = dsum[i];
  }
}

// The launch's shared memory, and the carveout that lets as many blocks
// as it allows share an SM: set once per device.
template <Order kOrder>
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(pool_step<kOrder>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Window::kBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pool_step<kOrder>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// iterations water steps, one launch each; the pool ping-pongs so that the
// last launch writes pool_out.  drains_in: the starting sum (null: zeros).
// Step s launches the tiles that meet what it can leave exact: the map less
// Window::kHalo (s + 1) cells at each edge that is not the grid's (the
// whole map when it is the grid); when that is empty, no later step runs.
template <Order kOrder>
int run_automata(const float* height, const float* pool_in, float* pool_out,
                 const float* drains_in, float* drains, int* flag, float* pool_tmp, Map map,
                 int iterations, int drain_particles, cudaStream_t stream) {
  cudaError_t err = configure<kOrder>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = map.rows * map.cols;
  map.tz = map.org_z & ~1;
  map.tx = map.org_x & ~1;
  cudaMemsetAsync(flag, 0, sizeof(int), stream);
  pool_init<<<(n + 255) / 256, 256, 0, stream>>>(pool_in, pool_out, drains_in, drains, flag,
                                                 n);
  const float* src = pool_in;
  for (int k = 0; k < iterations; ++k) {
    float* dst = ((iterations - 1 - k) % 2 == 0) ? pool_out : pool_tmp;
    // the grid rows and columns this step leaves exact, and the tiles (from
    // the map's first tile, map.tz / map.tx) that meet them
    const long long cut = (long long)Window::kHalo * (k + 1);
    const long long z0 = map.org_z + (map.org_z > 0 ? cut : 0);
    const long long x0 = map.org_x + (map.org_x > 0 ? cut : 0);
    const long long z1 = map.org_z + map.rows - (map.org_z + map.rows < map.res ? cut : 0);
    const long long x1 = map.org_x + map.cols - (map.org_x + map.cols < map.res ? cut : 0);
    if (z0 >= z1 || x0 >= x1) break;
    const int bz = static_cast<int>((z0 - map.tz) / kTile);
    const int bx = static_cast<int>((x0 - map.tx) / kTile);
    const dim3 tiles(static_cast<unsigned>((x1 - map.tx + kTile - 1) / kTile - bx),
                     static_cast<unsigned>((z1 - map.tz + kTile - 1) / kTile - bz));
    Map step = map;
    step.tz = map.tz + bz * kTile;
    step.tx = map.tx + bx * kTile;
    pool_step<kOrder><<<tiles, kThreads, Window::kBytes, stream>>>(
        height, src, dst, drains, flag, step, drain_particles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool_tmp: a second res^2 pool buffer (the ping-pong partner of pool_out).
extern "C" int noize_pool_automata(const float* height, const float* pool_in, float* pool_out,
                                   float* drains, int* flag, float* pool_tmp, int res,
                                   int iterations, int drain_particles, void* stream_ptr) {
  if (res < 2 || res % 2 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_automata<Order::kPair>(height, pool_in, pool_out, nullptr, drains, flag, pool_tmp,
                                    Map{res, res, 0, 0, res, 0, 0}, iterations, drain_particles,
                                    static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int noize_pool_automata_full(const float* height, const float* pool_in,
                                        float* pool_out, float* drains, int* flag,
                                        float* pool_tmp, int res, int iterations,
                                        int drain_particles, void* stream_ptr) {
  if (res < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_automata<Order::kFull>(height, pool_in, pool_out, nullptr, drains, flag, pool_tmp,
                                    Map{res, res, 0, 0, res, 0, 0}, iterations, drain_particles,
                                    static_cast<cudaStream_t>(stream_ptr));
}

// K5 on a window: height, pool_in, pool_out, drains_in, drains and pool_tmp
// are rows x cols cells of a res^2 grid from (org_z, org_x) on, in the grid.
// After k steps the cells within 8k of an edge that is not the grid's are
// undefined in pool_out and drains.
extern "C" int noize_pool_automata_window(const float* height, const float* pool_in,
                                          float* pool_out, const float* drains_in,
                                          float* drains, int* flag, float* pool_tmp, int rows,
                                          int cols, int org_z, int org_x, int res,
                                          int iterations, int drain_particles,
                                          void* stream_ptr) {
  if (rows < 1 || cols < 1 || org_z < 0 || org_x < 0 || org_z + rows > res ||
      org_x + cols > res || iterations < 0 || drains_in == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_automata<Order::kFull>(height, pool_in, pool_out, drains_in, drains, flag,
                                    pool_tmp, Map{rows, cols, org_z, org_x, res, 0, 0},
                                    iterations, drain_particles,
                                    static_cast<cudaStream_t>(stream_ptr));
}
