// K7 — particle descent: every step of every particle in one launch.
//
// Not a TPU kernel's port: the reference steps all particles together with
// descend_step (noize_tpu/erosion/particles.py:266) inside the lax.scan /
// while_loop of descend_all (:445), and its sharded cycle runs the same
// step on a rank's extended block (noize_tpu/parallel/sharded_erosion.py:
// 185-235); neither has a Pallas kernel.  The plain version is
// erosion/particles.descend_steps_plain, the torch-op loop of
// descend_step, on the step_maps table.
//
// Bound: latency, not bytes.  A particle's steps are one dependent chain:
// each step's table reads depend on where the last step moved it, and its
// atan, sin, two divisions and two roots on what it read.  The bytes (each
// step's reads, its event of 20 bytes) are a few MB a descent.  As torch
// operations every step is some 150 launches over N particles, and the
// plain loop's all-dead check is a host sync every 8 steps.
//
// Design (redesigned for the card): one thread a particle, any N, in blocks
// of one warp (kThreads), so 1000 particles run on 32 SMs, not 8.  The
// table is one 16-byte record a cell, {quantised all-heights, WIH, flow,
// plants or 0}, built in one pass (descent_records below; the plain
// version quantises per value, so the bits are the same), so a step's 3x3
// reads are nine aligned float4s.  Whatever heading a particle takes, its
// next 3x3 lies inside the 5x5 around its current cell: each step issues
// cp.async copies of that 5x5 into the thread's other slice of shared
// memory (two 5x5 slices a thread, 800 bytes) before it computes, and
// reads its own 3x3 from the slice the step before filled, so a step's
// round trip to memory overlaps the step's arithmetic instead of adding to
// it.  A move of more than one cell (positions off the integer grid round
// half-to-even) reloads the 5x5 and waits.  What is left of a step (1.6-2
// µs on an H100, PERF.md) is its chain of dependent arithmetic: two atan,
// two sin, two divisions and two roots (computing both candidate moves'
// velocity gain before the choice, so that the two could run side by side,
// was slower).  The eight fields live in registers for all `steps` steps.
// Each step writes the particle's event into [steps, N] buffers (the flat
// table cell, d_track, d_pool, d_sed), so the buffers hold, step-major then
// particle slot, the events the plain version concatenates; the caller
// scatter-adds them in that order (K9, scatter.cu).  A particle that dies stops computing and
// writes the plain version's dead-slot event for the steps left: its
// clamped cell and three zeros.  The accumulators start at +0.0 and never
// hold -0.0, so the zeros change no sum (K9 drops them from its runs), and
// there is no early exit and no host sync.
//
// Windowed form (K7@window): the table holds a window of the grid (its cell
// (0, 0) at the global (o_r, o_c), rows_w x cols_w); coordinates and the
// grid's edge clamp stay global, every read clamps into the window, and the
// event cell is the window's.  `owned` (u8[N], optional) zeroes the events
// of particles another rank owns.  The whole grid is the window at (0, 0)
// of res x res.
//
// Arithmetic: every float operation of the step is an explicit __f*_rn in
// the plain version's order, so nothing is contracted into an FMA; only
// atanf and sinf come from the math library, and they equal PyTorch's CUDA
// atan and sin bit for bit (the card test test_k7_atan_sin_match_torch).
// Rounding to an integer is half-to-even (__float2int_rn), as torch.round;
// the roots are correctly rounded (__fsqrt_rn), as ops/f32.sqrt; the one
// true division is __fdiv_rn.  Selects keep NaN where torch.clamp and
// torch.minimum keep it.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::add;
using noize::clampi;
using noize::mul;
using noize::sub;

constexpr int kThreads = 32;             // one warp a block
constexpr int kSide = 5;                  // the prefetched patch: 5x5 cells
constexpr int kPatch = kSide * kSide;
constexpr int kPatchBytes = 2 * kPatch * 16;  // two slices of float4 a thread

// Host-rounded float32 constants and the integer shape of one launch.
struct Params {
  float inv_hs, r_pr, r100, r_pi, gravity, drag, friction, veg, terminal, capacity,
      neg_erosion, deposition, evap_keep;
  int maxage, res, o_r, o_c, rows_w, cols_w, plants, steps, n;
  // NEIGHBOR_OFFSETS (d_row, d_col) and the compass ring (RING_DR, RING_DC)
  int nb_dr[8], nb_dc[8], ring_dr[8], ring_dc[8];
};

// out = v[k] as a select chain, so v stays in registers.
__device__ __forceinline__ float select8(const float (&v)[8], int k) {
  float out = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) out = k == j ? v[j] : out;
  return out;
}

__device__ __forceinline__ float clamp_min0(float x) { return x < 0.0f ? 0.0f : x; }

// torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// _velocity_term: sqrt(2·|gravity·sin(theta) ± friction| · (v / sin(theta))),
// theta = atan(v · r_pr).  NaN when v == 0 (0 / 0).
__device__ __forceinline__ float velocity_term(float v, float sin_t, float friction,
                                               float gravity, bool uphill) {
  const float s = mul(gravity, sin_t);
  const float accel = uphill ? add(s, friction) : sub(s, friction);
  return __fsqrt_rn(mul(mul(2.0f, fabsf(accel)), __fdiv_rn(v, sin_t)));
}

// The window's record for the global (r, c): clamped to the grid, then into
// the window.
__device__ __forceinline__ long long record_of(const Params& q, int r, int c) {
  const int last = q.res - 1;
  r = clampi(clampi(r, 0, last) - q.o_r, 0, q.rows_w - 1);
  c = clampi(clampi(c, 0, last) - q.o_c, 0, q.cols_w - 1);
  return (long long)r * q.cols_w + c;
}

// A 16-byte asynchronous copy from device to shared memory (cp.async).
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Issues the copies of the 5x5 records around (r, c) into a thread's slice
// (slot k at slice[k * stride]) as one group.
__device__ __forceinline__ void load_patch(float4* slice, int stride,
                                           const float4* __restrict__ table, const Params& q,
                                           int r, int c) {
  const int last = q.res - 1;
  int rows[kSide], cols[kSide];
#pragma unroll
  for (int d = 0; d < kSide; ++d) {
    rows[d] = clampi(clampi(r + d - 2, 0, last) - q.o_r, 0, q.rows_w - 1);
    cols[d] = clampi(clampi(c + d - 2, 0, last) - q.o_c, 0, q.cols_w - 1);
  }
#pragma unroll
  for (int dr = 0; dr < kSide; ++dr) {
#pragma unroll
    for (int dc = 0; dc < kSide; ++dc) {
      copy16(slice + (dr * kSide + dc) * stride, table + (long long)rows[dr] * q.cols_w + cols[dc]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every copy group the thread issued; its own slots are then
// visible to it (no other thread reads them).
__device__ __forceinline__ void wait_patches() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
descent(const float4* __restrict__ table, Params q, const float* __restrict__ row_in,
        const float* __restrict__ col_in, const int* __restrict__ heading_in,
        const float* __restrict__ vel_in, const float* __restrict__ water_in,
        const float* __restrict__ sed_in, const int* __restrict__ age_in,
        const unsigned char* __restrict__ alive_in, const unsigned char* __restrict__ owned,
        float* row_out, float* col_out, int* heading_out, float* vel_out, float* water_out,
        float* sed_out, int* age_out, unsigned char* alive_out, long long* ev_idx,
        float* ev_track, float* ev_pool, float* ev_sed) {
  extern __shared__ float4 patches[];  // [2][kPatch][blockDim.x]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.n) return;
  const int stride = blockDim.x;
  float4* const mine = patches + threadIdx.x;  // slice b's slot k: mine[(b·kPatch + k)·stride]
  float row = row_in[i], col = col_in[i], vel = vel_in[i], water = water_in[i],
        sed = sed_in[i];
  int heading = heading_in[i], age = age_in[i];
  bool alive = alive_in[i] != 0;
  const bool own = owned == nullptr || owned[i] != 0;
  const int last = q.res - 1;
  // the slice `cur` holds the 5x5 around the anchor cell (ar, ac)
  int cur = 0, ar = -1 << 30, ac = -1 << 30;

  int s = 0;
  for (; s < q.steps && alive; ++s) {
    const int ri = clampi(__float2int_rn(row), 0, last);
    const int ci = clampi(__float2int_rn(col), 0, last);
    const long long cell = record_of(q, ri, ci);

    // deaths before the move: dehydration, old age
    const bool dehydrated = water < 0.01f;
    float d_sed = dehydrated ? mul(sed, q.inv_hs) : 0.0f;
    const bool too_old = !dehydrated && age >= q.maxage;
    float d_pool = too_old ? mul(water, q.inv_hs) : 0.0f;
    d_sed = add(d_sed, too_old ? mul(sed, q.inv_hs) : 0.0f);
    const bool active = !dehydrated && !too_old;

    bool no_drain = false, slow = false, moving = false;
    float new_row = row, new_col = col, new_vel = vel, deposition = 0.0f;
    int new_ring = heading;
    if (active) {
      int da = ri - ar, db = ci - ac;
      const bool reload = da < -1 || da > 1 || db < -1 || db > 1;
      if (reload) {  // the first step, or a jump: fetch this cell's 5x5 and wait
        load_patch(mine + cur * kPatch * stride, stride, table, q, ri, ci);
        wait_patches();
        da = db = 0;
      } else {  // the next step's 3x3 lies in this cell's 5x5: fetch it now
        load_patch(mine + (cur ^ 1) * kPatch * stride, stride, table, q, ri, ci);
      }
      const float4* p = mine + cur * kPatch * stride;

      // the neighbourhood: 8 quantised all-heights, the WIH, the flow, plants
      float nb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        nb[k] = p[((da + q.nb_dr[k] + 2) * kSide + db + q.nb_dc[k] + 2) * stride].x;
      }
      const float4 here = p[((da + 2) * kSide + db + 2) * stride];
      const float current_h = here.y;
      const float flow_here = here.z;

      // natural drain: argmin, first wins (a NaN first of all), and amin
      int drain_nb = 0;
      float drain_height = nb[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        if (drain_height == drain_height && (nb[k] != nb[k] || nb[k] < drain_height)) {
          drain_height = nb[k];
          drain_nb = k;
        }
      }
      const int drain_ring = (drain_nb % 4) * 2 + drain_nb / 4;
      const int hd = heading < 0 ? drain_ring : heading;

      const float flow_pos = clamp_min0(flow_here);
      const float eff_drag = mul(sub(1.0f, flow_pos), q.drag);
      float eff_friction = mul(sub(1.0f, flow_pos), q.friction);
      if (q.plants) {
        const float pl = here.w;
        const float capped = pl > 2.0f ? 2.0f : pl;
        eff_friction = mul(eff_friction, add(1.0f, mul(capped, q.veg)));
      }

      // constrained steering; RING_TO_NB: nb = ring / 2 + 4 * (ring & 1)
      const int left = (hd + 7) % 8, right = (hd + 1) % 8;
      const float h_left = select8(nb, left / 2 + 4 * (left % 2));
      const float h_center = select8(nb, hd / 2 + 4 * (hd % 2));
      const float h_right = select8(nb, right / 2 + 4 * (right % 2));
      const bool go_left = h_left < h_center && h_left < h_right;
      const bool go_right = h_right < h_left && h_right < h_center;
      const int flow_ring = go_left ? left : (go_right ? right : hd);
      const float heading_height = go_left ? h_left : (go_right ? h_right : h_center);

      float h_diff = sub(heading_height, current_h);
      const float v0 = sub(vel, mul(vel, eff_drag));  // drag before the branch

      const float loss = velocity_term(h_diff, sinf(atanf(mul(h_diff, q.r_pr))), eff_friction,
                                       q.gravity, true);
      const bool downhill_ok = h_diff < 0.0f;
      const bool uphill_ok = !downhill_ok && loss <= v0;  // NaN loss: false
      const bool take_heading = downhill_ok || uphill_ok;
      const float velocity_loss = uphill_ok ? loss : 0.0f;

      // fallback: the natural drain; die if even the drain is uphill
      const float drain_h_diff = sub(drain_height, current_h);
      no_drain = !take_heading && drain_h_diff > 0.0f;
      moving = !no_drain;
      new_ring = take_heading ? flow_ring : drain_ring;
      h_diff = take_heading ? h_diff : drain_h_diff;

      int move_r = q.ring_dr[0], move_c = q.ring_dc[0];  // selects: no local copy
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        move_r = new_ring == k ? q.ring_dr[k] : move_r;
        move_c = new_ring == k ? q.ring_dc[k] : move_c;
      }
      new_row = add(row, (float)move_r);
      new_col = add(col, (float)move_c);
      const int nri = __float2int_rn(new_row), nci = __float2int_rn(new_col);
      const bool oob = moving && (nri < 0 || nci < 0 || nri >= q.res || nci >= q.res);
      moving = moving && !oob;

      // velocity update
      const float v_diff = fabsf(h_diff);
      const float theta = atanf(mul(v_diff, q.r_pr));
      const float theta_d = mul(mul(theta, 180.0f), q.r_pi);
      const float gain = velocity_term(v_diff, sinf(theta), eff_friction, q.gravity, false);
      const float delta_v = v_diff > 0.0f ? (h_diff > 0.0f ? -velocity_loss : gain) : 0.0f;
      float v = clamp_min0(add(v0, delta_v));
      const float over = sub(v, q.terminal);
      v = sub(v, clamp_min0(minimum(over, clamp_min0(mul(mul(mul(eff_drag, 0.25f), over),
                                                          over)))));
      new_vel = v;

      // slow-and-flat cull
      slow = moving && theta_d < 3.0f && v < 1.0f;
      moving = moving && !slow;

      // capacity exchange
      const float capacity = mul(mul(v, water), q.capacity);
      deposition = sed < capacity ? mul(sub(capacity, sed), q.neg_erosion)
                                  : mul(sub(sed, capacity), q.deposition);

      if (!reload) {  // the prefetch of this cell's 5x5 is the next step's
        wait_patches();
        cur ^= 1;
      }
      ar = ri;
      ac = ci;
    }
    d_pool = add(d_pool, no_drain ? mul(water, q.inv_hs) : 0.0f);
    d_sed = add(d_sed, no_drain ? mul(sed, q.inv_hs) : 0.0f);
    d_pool = add(d_pool, slow ? mul(water, q.inv_hs) : 0.0f);
    d_sed = add(d_sed, slow ? mul(sed, q.inv_hs) : 0.0f);
    d_sed = add(d_sed, moving ? mul(deposition, q.inv_hs) : 0.0f);
    const float d_track = moving ? water : 0.0f;

    const long long e = (long long)s * q.n + i;
    ev_idx[e] = cell;
    ev_track[e] = own ? d_track : 0.0f;
    ev_pool[e] = own ? d_pool : 0.0f;
    ev_sed[e] = own ? d_sed : 0.0f;

    if (moving) {
      sed = sub(sed, deposition);
      water = mul(water, q.evap_keep);
      row = new_row;
      col = new_col;
      heading = new_ring;
      vel = new_vel;
      age = age + 1;
    }
    alive = moving;
  }
  if (s < q.steps) {  // dead: the frozen cell and three zeros
    const long long cell = record_of(q, clampi(__float2int_rn(row), 0, last),
                                     clampi(__float2int_rn(col), 0, last));
    for (; s < q.steps; ++s) {
      const long long e = (long long)s * q.n + i;
      ev_idx[e] = cell;
      ev_track[e] = 0.0f;
      ev_pool[e] = 0.0f;
      ev_sed[e] = 0.0f;
    }
  }
  row_out[i] = row;
  col_out[i] = col;
  heading_out[i] = heading;
  vel_out[i] = vel;
  water_out[i] = water;
  sed_out[i] = sed;
  age_out[i] = age;
  alive_out[i] = alive ? 1 : 0;
}

// The record table: {_quantize(all_h), wih, flow, plants or 0} a cell, with
// wih = hs·(height + pool) and all_h = wih + fhc·flow, each op rounded as
// particles.step_maps and _quantize round it.
__global__ void descent_records(const float* __restrict__ height,
                                const float* __restrict__ pool,
                                const float* __restrict__ flow,
                                const float* __restrict__ plants, long long n, float hs,
                                float fhc, float r100, float4* __restrict__ out) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    const float f = flow[k];
    const float wih = mul(hs, add(height[k], pool[k]));
    const float all_h = add(wih, mul(fhc, f));
    out[k] = make_float4(mul(truncf(mul(100.0f, all_h)), r100), wih, f,
                         plants == nullptr ? 0.0f : plants[k]);
  }
}

// atanf and sinf of x as the step compiles them (the card test holds them
// against torch.atan and torch.sin).
__global__ void atan_sin(const float* x, float* atan_out, float* sin_out, long long n) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    atan_out[k] = atanf(x[k]);
    sin_out[k] = sinf(x[k]);
  }
}

int grid_of(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

}  // namespace

// table: the record table (float4 a cell, 16-byte aligned) of a rows_w x
// cols_w window.  fparams (host f32[13]): inv_hs, r_pr, r100, r_pi,
// gravity, drag, friction, vegetation friction, terminal velocity,
// capacity, -erosion, deposition, 1 - evap.  iparams (host i32[41]):
// maxage, res, o_r, o_c, rows_w, cols_w, plants, steps, n, then the
// neighbour offsets (8 d_row, 8 d_col) and the ring (8 d_row, 8 d_col).
// The particle fields in and out (f32/i32/u8[n]), owned (u8[n] or null) and
// the events ([steps, n]: i64 cells, f32 deltas) are device memory.
extern "C" int noize_descent(const float* table, const float* fparams, const int* iparams,
                             const float* row_in, const float* col_in, const int* heading_in,
                             const float* vel_in, const float* water_in, const float* sed_in,
                             const int* age_in, const unsigned char* alive_in,
                             const unsigned char* owned, float* row_out, float* col_out,
                             int* heading_out, float* vel_out, float* water_out,
                             float* sed_out, int* age_out, unsigned char* alive_out,
                             long long* ev_idx, float* ev_track, float* ev_pool, float* ev_sed,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Params q;
  const float* f = fparams;
  q.inv_hs = f[0], q.r_pr = f[1], q.r100 = f[2], q.r_pi = f[3], q.gravity = f[4];
  q.drag = f[5], q.friction = f[6], q.veg = f[7], q.terminal = f[8], q.capacity = f[9];
  q.neg_erosion = f[10], q.deposition = f[11], q.evap_keep = f[12];
  const int* p = iparams;
  q.maxage = p[0], q.res = p[1], q.o_r = p[2], q.o_c = p[3], q.rows_w = p[4];
  q.cols_w = p[5], q.plants = p[6], q.steps = p[7], q.n = p[8];
  for (int k = 0; k < 8; ++k) {
    q.nb_dr[k] = p[9 + k];
    q.nb_dc[k] = p[17 + k];
    q.ring_dr[k] = p[25 + k];
    q.ring_dc[k] = p[33 + k];
  }
  // the 5x5 patch holds the next 3x3 only for moves and offsets of one cell
  for (int k = 0; k < 8; ++k) {
    if (q.ring_dr[k] < -1 || q.ring_dr[k] > 1 || q.ring_dc[k] < -1 || q.ring_dc[k] > 1 ||
        q.nb_dr[k] < -1 || q.nb_dr[k] > 1 || q.nb_dc[k] < -1 || q.nb_dc[k] > 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (q.res < 1 || q.rows_w < 1 || q.cols_w < 1 || q.steps < 0 || q.n < 0 ||
      reinterpret_cast<unsigned long long>(table) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q.n == 0) return static_cast<int>(cudaSuccess);
  const int smem = kPatchBytes * kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(descent, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descent<<<(q.n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), q, row_in, col_in, heading_in, vel_in, water_in,
      sed_in, age_in, alive_in, owned, row_out, col_out, heading_out, vel_out, water_out,
      sed_out, age_out, alive_out, ev_idx, ev_track, ev_pool, ev_sed);
  return static_cast<int>(cudaGetLastError());
}

// height, pool, flow, plants (or null): f32[n] device memory; out: the
// f32[n, 4] record table, 16-byte aligned.  hs, fhc: the height scale and
// FLOW_HEIGHT_CONTRIBUTION rounded to f32; r100: recip(100).
extern "C" int noize_descent_records(const float* height, const float* pool, const float* flow,
                                     const float* plants, long long n, float hs, float fhc,
                                     float r100, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || reinterpret_cast<unsigned long long>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  descent_records<<<grid_of(n, 256), 256, 0, stream>>>(height, pool, flow, plants, n, hs, fhc,
                                                       r100, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x, atan_out, sin_out: f32[n] device memory.
extern "C" int noize_atan_sin(const float* x, float* atan_out, float* sin_out, long long n,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  atan_sin<<<grid_of(n, 256), 256, 0, stream>>>(x, atan_out, sin_out, n);
  return static_cast<int>(cudaGetLastError());
}
