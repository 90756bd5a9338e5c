// K2 — the whole flow map (virtual-pipes relaxation -> |velocity|).
//
// Replaces: noize_tpu/ops/pallas/flow_pl.py:_fused_flow_call (entry
// flow_map_fused) and _iteration_call (entry flow_map_pallas).  Computes
// WATER_INIT fill, `iterations` x (flow step, water step), the velocity
// field and the static normalise with its `norm_max - norm_min < 1e-12`
// guard (ops/flow.py:59-126).
//
// Bound: the float32 issue rate.  An iteration does 35 operations a cell
// (flow step 25, water step 10) and the velocity and normalise 14 once,
// each its own instruction (-fmad=false): 0.037 ms at 2048^2 and 8
// iterations, against 8 bytes a cell in and out (0.010 ms); chip_smoke.py
// computes both.  The design this replaces ran two launches an iteration
// (18 a call at 8), each moving water and the four flows through device
// memory.
//
// Design: the state stays on chip for m iterations, as _fused_flow_call
// keeps its block in VMEM.  The wrapper's plan (ops/cuda/flow.flow_plan)
// splits the iterations into launches of m.  A block's window is a
// kRegion^2 square: its output tile with a halo of 2m cells.  Each
// sub-step reads the 4 neighbours, and the velocity does not read the last
// water step's water, so the water and flows m iterations on (and the
// velocity) depend on the state within 2m cells; _fused_flow_call's halo
// of 2m + 1 is one more than needed.  Thread (tx, ty) owns the cells of a
// strip of kSlotsZ rows from ty * kSlotsZ in each of the columns tx + 32b,
// and keeps their height, water and four flows in registers.  Shared
// memory holds what other threads read: every cell's height + water and
// W and E flows (the horizontal neighbours are other lanes), the S flow of
// a strip's first cell and the N flow of its last (the vertical
// neighbours inside a strip are the thread's own registers).  A flow step
// reads height + water and writes flows, a water step reads flows and
// writes height + water, so one barrier after each suffices.  Every window
// cell is recomputed each sub-step; neighbour reads clamp to the window's
// cells on the grid, which at the grid's edge is the reference's clamped
// shift, and elsewhere lets an error enter one cell a sub-step from the
// window's edge, never reaching the tile.  The last launch computes
// velocity and normalise for its tile; an earlier one writes its tile's
// water and flows to device memory for the next (two sets of five maps,
// ping-ponged).  Every op rounds on its own, in the reference's order.
//
// Maps need not be square (parallel/sharded_ops runs K2 on a shard's block
// extended toward its neighbours).  A stack of `batch` maps
// (parallel/tiled's [T, R, R] tiles) runs in the
// same launches as one map: the map index is blockIdx.z, every device
// index is offset to its map (the carry holds a set of five maps per map),
// and the window clamps to the map's own cells, so no block reads another
// map's cells.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr float kTimestep = 0.2f;    // ops/flow.py TIMESTEP
constexpr float kWaterInit = 1e-4f;  // ops/flow.py WATER_INIT

constexpr int kThreads = 1024;            // 32 x kRows threads a block
constexpr int kRows = kThreads / 32;
constexpr int kSlotsX = 3, kSlotsZ = 3;   // columns a thread owns, rows of its strip
constexpr int kRegion = 32 * kSlotsX;     // window side
static_assert(kRows * kSlotsZ == kRegion, "the window must be square");
constexpr int kCells = kRegion * kRegion;
constexpr size_t kSharedBytes = 5 * sizeof(float) * kCells;

using noize::add;
using noize::divf;
using noize::mul;
using noize::sub;

// The carried state between launches: water and the four flows.
struct State {
  float* w;
  float* fw;
  float* fe;
  float* fs;
  float* fn;
};

// m iterations on one tile (W = x-1, E = x+1, S = z-1, N = z+1).
__global__ void __launch_bounds__(kThreads)
flow_tile(const float* __restrict__ height, State in, State carry, float* __restrict__ out,
          int rows, int cols, int m, int first, int last, float norm_min, float rng) {
  extern __shared__ float planes[];
  float* tot = planes;  // height + water
  float* pw = planes + kCells;
  float* pe = planes + 2 * kCells;
  float* ps = planes + 3 * kCells;  // a strip's first cells only
  float* pn = planes + 4 * kCells;  // a strip's last cells only
  const int halo = 2 * m;
  const int tile = kRegion - 2 * halo;
  const int z0 = blockIdx.y * tile - halo, x0 = blockIdx.x * tile - halo;
  // the window's cells on the grid, in window coordinates
  const int zl = max(0, z0) - z0, zh = min(rows - 1, z0 + kRegion - 1) - z0;
  const int xl = max(0, x0) - x0, xh = min(cols - 1, x0 + kRegion - 1) - x0;
  const int tx = threadIdx.x, r0 = threadIdx.y * kSlotsZ;
  constexpr int kLast = kSlotsZ - 1;
  const size_t base = (size_t)blockIdx.z * rows * cols;  // this block's map of the stack

  float h[kSlotsZ][kSlotsX], w[kSlotsZ][kSlotsX];
  float fw[kSlotsZ][kSlotsX], fe[kSlotsZ][kSlotsX], fs[kSlotsZ][kSlotsX],
      fn[kSlotsZ][kSlotsX];
#pragma unroll
  for (int a = 0; a < kSlotsZ; ++a) {
#pragma unroll
    for (int b = 0; b < kSlotsX; ++b) {
      const int r = r0 + a, c = tx + 32 * b, i = r * kRegion + c;
      h[a][b] = w[a][b] = fw[a][b] = fe[a][b] = fs[a][b] = fn[a][b] = 0.0f;
      if (r < zl || r > zh || c < xl || c > xh) continue;
      const size_t g = base + (size_t)(z0 + r) * cols + (x0 + c);
      h[a][b] = height[g];
      if (first) {
        w[a][b] = kWaterInit;
      } else {
        w[a][b] = in.w[g];
        fw[a][b] = in.fw[g];
        fe[a][b] = in.fe[g];
        fs[a][b] = in.fs[g];
        fn[a][b] = in.fn[g];
      }
      tot[i] = add(h[a][b], w[a][b]);
      pw[i] = fw[a][b];
      pe[i] = fe[a][b];
      if (a == 0) ps[i] = fs[a][b];
      if (a == kLast) pn[i] = fn[a][b];
    }
  }
  __syncthreads();

  for (int it = 0; it < m; ++it) {
    // compute_flow_step (flow.py:59-76)
#pragma unroll
    for (int a = 0; a < kSlotsZ; ++a) {
#pragma unroll
      for (int b = 0; b < kSlotsX; ++b) {
        const int r = r0 + a, c = tx + 32 * b, i = r * kRegion + c;
        if (r < zl || r > zh || c < xl || c > xh) continue;
        const int up = a > 0 ? a - 1 : 0, down = a < kLast ? a + 1 : kLast;
        const float total = add(h[a][b], w[a][b]);
        const float tw = c - 1 < xl ? total : tot[i - 1];
        const float te = c + 1 > xh ? total : tot[i + 1];
        const float ts = r - 1 < zl ? total
                         : a > 0    ? add(h[up][b], w[up][b])
                                    : tot[i - kRegion];
        const float tn = r + 1 > zh  ? total
                         : a < kLast ? add(h[down][b], w[down][b])
                                     : tot[i + kRegion];
        const float vw = noize::relu(add(fw[a][b], sub(total, tw)));
        const float ve = noize::relu(add(fe[a][b], sub(total, te)));
        const float vs = noize::relu(add(fs[a][b], sub(total, ts)));
        const float vn = noize::relu(add(fn[a][b], sub(total, tn)));
        const float s = add(add(add(vw, ve), vs), vn);
        float k = 0.0f;
        if (s > 0.0f) {
          k = noize::fmin2(noize::fmax2(divf(w[a][b], mul(s, kTimestep)), 0.0f), 1.0f);
        }
        fw[a][b] = mul(vw, k);
        fe[a][b] = mul(ve, k);
        fs[a][b] = mul(vs, k);
        fn[a][b] = mul(vn, k);
        pw[i] = fw[a][b];
        pe[i] = fe[a][b];
        if (a == 0) ps[i] = fs[a][b];
        if (a == kLast) pn[i] = fn[a][b];
      }
    }
    __syncthreads();
    // update_water_step (flow.py:79-88)
#pragma unroll
    for (int a = 0; a < kSlotsZ; ++a) {
#pragma unroll
      for (int b = 0; b < kSlotsX; ++b) {
        const int r = r0 + a, c = tx + 32 * b, i = r * kRegion + c;
        if (r < zl || r > zh || c < xl || c > xh) continue;
        const int up = a > 0 ? a - 1 : 0, down = a < kLast ? a + 1 : kLast;
        const float e_w = c - 1 < xl ? fe[a][b] : pe[i - 1];
        const float w_e = c + 1 > xh ? fw[a][b] : pw[i + 1];
        const float n_s = r - 1 < zl ? fn[a][b] : a > 0 ? fn[up][b] : pn[i - kRegion];
        const float s_n = r + 1 > zh ? fs[a][b] : a < kLast ? fs[down][b] : ps[i + kRegion];
        const float flow_out = add(add(add(fw[a][b], fe[a][b]), fs[a][b]), fn[a][b]);
        const float flow_in = add(add(add(e_w, w_e), n_s), s_n);
        w[a][b] = noize::relu(add(w[a][b], mul(sub(flow_in, flow_out), kTimestep)));
        tot[i] = add(h[a][b], w[a][b]);
      }
    }
    __syncthreads();
  }

  // the tile: window cells [halo, halo + tile) on the grid
#pragma unroll
  for (int a = 0; a < kSlotsZ; ++a) {
#pragma unroll
    for (int b = 0; b < kSlotsX; ++b) {
      const int r = r0 + a, c = tx + 32 * b, i = r * kRegion + c;
      if (r < halo || r >= halo + tile || c < halo || c >= halo + tile) continue;
      if (r < zl || r > zh || c < xl || c > xh) continue;
      const size_t g = base + (size_t)(z0 + r) * cols + (x0 + c);
      if (!last) {
        carry.w[g] = w[a][b];
        carry.fw[g] = fw[a][b];
        carry.fe[g] = fe[a][b];
        carry.fs[g] = fs[a][b];
        carry.fn[g] = fn[a][b];
        continue;
      }
      // velocity_field (flow.py:91-100) + the static normalise (flow.py:124-126)
      const int up = a > 0 ? a - 1 : 0, down = a < kLast ? a + 1 : kLast;
      const float e_w = c - 1 < xl ? fe[a][b] : pe[i - 1];
      const float w_e = c + 1 > xh ? fw[a][b] : pw[i + 1];
      const float n_s = r - 1 < zl ? fn[a][b] : a > 0 ? fn[up][b] : pn[i - kRegion];
      const float s_n = r + 1 > zh ? fs[a][b] : a < kLast ? fs[down][b] : ps[i + kRegion];
      const float dl = sub(e_w, fw[a][b]);
      const float dr = sub(fe[a][b], w_e);
      const float dt = sub(s_n, fn[a][b]);
      const float db = sub(fs[a][b], n_s);
      const float vx = mul(add(dl, dr), 0.5f);
      const float vy = mul(add(dt, db), 0.5f);
      float v = __fsqrt_rn(add(mul(vx, vx), mul(vy, vy)));
      if (rng < 1e-12f) v = 0.0f;
      out[g] = divf(sub(v, norm_min), rng);
    }
  }
}

// The launch's shared memory: set once per device.
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(flow_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSharedBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

State state_set(float* carry, int set, size_t n) {
  float* p = carry + set * 5 * n;
  return State{p, p + n, p + 2 * n, p + 3 * n, p + 4 * n};
}

}  // namespace

// height, out: `batch` rows x cols maps each, one after another.  per_launch
// (host int[launches]): iterations of each launch, in order (a call of 0
// iterations is one launch of 0).  carry: two sets of five stacks of
// `batch` rows x cols maps (water, W, E, S, N flows), read and written only when
// launches > 1.  region: the window side the caller planned with; it must
// be kRegion.
extern "C" int noize_flow_map(const float* height, float* out, float* carry, int rows,
                              int cols, int batch, const int* per_launch, int launches,
                              int region, float norm_min, float rng, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || cols < 1 || batch < 1 || batch > 65535 || launches < 1 || region != kRegion ||
      (launches > 1 && carry == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)batch * rows * cols;
  for (int i = 0; i < launches; ++i) {
    const int m = per_launch[i];
    const int last = i == launches - 1;
    const int tile = kRegion - 4 * m;
    if (m < 0 || tile < 1 || (m == 0 && !last)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((cols + tile - 1) / tile, (rows + tile - 1) / tile, batch);
    const State in = i > 0 ? state_set(carry, (i - 1) % 2, n) : State{};
    const State next = last ? State{} : state_set(carry, i % 2, n);
    flow_tile<<<grid, dim3(32, kRows), kSharedBytes, stream>>>(
        height, in, next, out, rows, cols, m, i == 0, last, norm_min, rng);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
