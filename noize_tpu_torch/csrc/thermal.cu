// K3 — thermal (talus) erosion: 4 * iterations checkerboard phases.
//
// Replaces: noize_tpu/ops/pallas/thermal_pl.py:_fused_thermal_call (entry
// thermal_erosion_fused).  Each phase anchors 2x2 blocks at one (x, z)
// parity and runs the sequential 6-pair rectify chain inside each block
// (ops/thermal.py, _PAIRS and _PHASE_OFFSETS order).
//
// Bound: device memory.  A call needs each cell read once and written once,
// 8 bytes a cell (0.010 ms at 2048^2), against 48 counted operations a cell
// an iteration (0.004 ms).  The design this replaces copied the map, then
// ran one launch a phase, each reading and writing the whole map: five
// passes over device memory for one iteration.
//
// Design: temporal blocking, as the TPU kernel keeps a row block for all
// its phases.  The wrapper's plan (ops/cuda/thermal.thermal_plan) splits
// the iterations into launches of m; a block loads its output tile (even
// origin and sides) with a halo of 4m - 1 columns and 2m rows a side into
// shared memory (cp.async), runs the 4m phases there with one barrier
// between phases, and writes the tile.  The halo: a block that straddles
// the edge of the region still exact leaves its inner cell stale, so the
// region loses a column a side in every phase after the first (x0
// alternates 1, 2) and a row a side in every second phase (z0 runs 2, 2,
// 1, 1).  The kernel tracks that rectangle on grid coordinates, and a phase
// updates only the blocks inside it.  Coverage is decided on grid
// coordinates as thermal_phase_masked does: anchors x in [x0, res-2], z in
// [z0, zmax] with zmax = res-2 when z0 == 2, else res-3.  Cells beyond the
// grid are never loaded, and no block reaches them.
// Shared memory holds the window as two planes, the even and the odd grid
// columns, so the anchors of a phase, two columns apart, read and write
// consecutive words.  Launches ping-pong between `out` and `tmp`, the last
// writing `out`.
// max_diff is computed by the wrapper (float32 tan, as the reference does).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using noize::add;
using noize::Items;
using noize::mul;
using noize::sub;

// _rectify_pair (thermal.py)
__device__ __forceinline__ void rectify(float& v1, float& v2, float max_diff, float inc) {
  const float diff = fabsf(sub(v1, v2));
  const float excess = mul(noize::relu(sub(diff, max_diff)), inc);
  const float delta = v1 > v2 ? -excess : excess;
  const float n1 = add(v1, delta);
  const float n2 = sub(v2, delta);
  v1 = n1;
  v2 = n2;
}

// The 6-pair chain on one 2x2 block, in the reference's float4 order:
// v0 = (ax, az), v1 = (ax+1, az), v2 = (ax, az+1), v3 = (ax+1, az+1).
__device__ __forceinline__ void rectify_block(float& v0, float& v1, float& v2, float& v3,
                                              float max_diff, float inc) {
  rectify(v0, v1, max_diff, inc);
  rectify(v0, v2, max_diff, inc);
  rectify(v0, v3, max_diff, inc);
  rectify(v1, v2, max_diff, inc);
  rectify(v1, v3, max_diff, inc);
  rectify(v2, v3, max_diff, inc);
}

// The window of a tile_z x tile_x tile for m iterations: `rows` rows of
// `pitch` words in each plane, the odd plane `odd` words after the even
// one (16 banks apart, so a row's load writes both planes without
// conflict).
struct Layout {
  int rows, pitch, odd;
  __host__ __device__ Layout(int m, int tile_z, int tile_x)
      : rows(tile_z + 4 * m), pitch(tile_x / 2 + 4 * m),
        odd((rows * pitch + 31) / 32 * 32 + 16) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)odd + (size_t)rows * pitch);
  }
};

// First value >= v of the parity of p.
__device__ __forceinline__ int from_parity(int v, int p) { return v + ((v - p) & 1); }

// The map is rows x cols cells of a res^2 grid, its cell (0, 0) at grid
// cell (org_z, org_x); tiles start at the even grid coordinates (tz0, tx0)
// at or before the origin.
__global__ void thermal_tile(const float* __restrict__ in, float* __restrict__ out, int rows,
                             int cols, int org_z, int org_x, int res, int m, int tile_z,
                             int tile_x, float max_diff, float inc) {
  extern __shared__ float window[];
  const Layout lay(m, tile_z, tile_x);
  const int hz = 2 * m, hx = 4 * m - 1;
  const int gz = (org_z & ~1) + blockIdx.y * tile_z;  // the tile's origin
  const int gx = (org_x & ~1) + blockIdx.x * tile_x;
  const int z_end = org_z + rows - 1, x_end = org_x + cols - 1;  // the map's last cells
  const int oz = gz - hz;      // grid row of window row 0
  const int ox = gx - hx - 1;  // grid column of plane word 0 (even)
  // word of grid cell (z, x)
  auto word = [&](int z, int x) {
    const int c = x - ox;
    return (c & 1) * lay.odd + (z - oz) * lay.pitch + (c >> 1);
  };

  // the region still exact, inclusive, on grid coordinates: at first the
  // window's cells on the map
  int zl = max(org_z, oz), zh = min(z_end, gz + tile_z - 1 + hz);
  int xl = max(org_x, gx - hx), xh = min(x_end, gx + tile_x - 1 + hx);
  {
    const int nx = xh - xl + 1, nz = zh - zl + 1;
    for (Items it(nx); it.chunk < nz; it.next()) {
      const int z = zl + it.chunk, x = xl + it.line;
      noize::copy_async(window + word(z, x), in + (size_t)(z - org_z) * cols + (x - org_x),
                        true);
    }
  }
  noize::copy_async_wait();
  __syncthreads();

  for (int j = 0; j < 4 * m; ++j) {
    // _PHASE_OFFSETS (thermal.py) as (x0, z0): (1, 2), (2, 2), (1, 1), (2, 1)
    const int x0 = (j & 1) ? 2 : 1;
    const int z0 = (j & 2) ? 1 : 2;
    const int zmax = z0 == 2 ? res - 2 : res - 3;
    // anchors whose block lies inside the region
    const int ax0 = from_parity(max(xl, x0), x0), ax1 = min(xh - 1, res - 2);
    const int az0 = from_parity(max(zl, z0), z0), az1 = min(zh - 1, zmax);
    const int nax = ax1 >= ax0 ? (ax1 - ax0) / 2 + 1 : 0;
    const int naz = az1 >= az0 ? (az1 - az0) / 2 + 1 : 0;
    if (nax > 0) {
      // anchors two columns apart are neighbouring words of one plane; a
      // block's right column is in the other plane (one word on when the
      // left column is odd)
      float* const first = window + word(az0, ax0);
      const int right = (ax0 - ox) & 1 ? 1 - lay.odd : lay.odd;
      const int down = 2 * lay.pitch;
      for (Items it(nax); it.chunk < naz; it.next()) {
        float* a = first + it.chunk * down + it.line;
        float* b = a + right;
        float v0 = a[0], v1 = b[0], v2 = a[lay.pitch], v3 = b[lay.pitch];
        rectify_block(v0, v1, v2, v3, max_diff, inc);
        a[0] = v0;
        b[0] = v1;
        a[lay.pitch] = v2;
        b[lay.pitch] = v3;
      }
    }
    // a valid block across the region's edge left its inner cell stale
    if (xl - 1 >= x0 && ((xl - 1 - x0) & 1) == 0) ++xl;
    if (xh >= x0 && xh <= res - 2 && ((xh - x0) & 1) == 0) --xh;
    if (zl - 1 >= z0 && zl - 1 <= zmax && ((zl - 1 - z0) & 1) == 0) ++zl;
    if (zh >= z0 && zh <= zmax && ((zh - z0) & 1) == 0) --zh;
    __syncthreads();
  }

  // the tile's cells on the map (inside the region where the map's edge is
  // the grid's: the halo covers what it lost)
  const int z0 = max(gz, org_z), x0 = max(gx, org_x);
  const int nx = min(gx + tile_x - 1, x_end) - x0 + 1, nz = min(gz + tile_z - 1, z_end) - z0 + 1;
  for (Items it(nx); it.chunk < nz; it.next()) {
    const int z = z0 + it.chunk, x = x0 + it.line;
    out[(size_t)(z - org_z) * cols + (x - org_x)] = window[word(z, x)];
  }
}

// Lets thermal_tile take up to the device's opt-in shared memory; set once
// per device.
cudaError_t configure(int* optin) {
  static bool done[64] = {};
  static int limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) {
    *optin = limit[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(thermal_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
  if (err == cudaSuccess && dev < 64) {
    done[dev] = true;
    limit[dev] = *optin;
  }
  return err;
}

}  // namespace

// in, out: rows x cols maps, cell (0, 0) at grid cell (org_z, org_x) of a
// res^2 grid (the whole grid: rows = cols = res, origin 0).  Parity, the
// anchors' coverage and the border are the grid's; near an edge of the map
// that is not the grid's edge the cells come out stale (the sharded thermal
// erosion crops them).  per_launch (host int[launches]): iterations of each
// launch, in order; a call of 0 launches copies in to out.  tmp: a second
// map, read only when launches > 1.  tile_z, tile_x: even output tile sides.
extern "C" int noize_thermal_erosion(const float* in, float* out, float* tmp, int rows,
                                     int cols, int org_z, int org_x, int res,
                                     const int* per_launch, int launches, int tile_z,
                                     int tile_x, int threads, float max_diff, float increment,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || cols < 1 || org_z < 0 || org_x < 0 || org_z + rows > res ||
      org_x + cols > res || launches < 0 || tile_z < 2 || tile_x < 2 || tile_z % 2 ||
      tile_x % 2 || threads < 32 || threads > 1024 || threads % 32 ||
      (launches > 1 && tmp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (launches == 0) {
    cudaMemcpyAsync(out, in, sizeof(float) * (size_t)rows * cols, cudaMemcpyDeviceToDevice,
                    stream);
    return static_cast<int>(cudaGetLastError());
  }
  int optin = 0;
  cudaError_t err = configure(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((org_x + cols - (org_x & ~1) + tile_x - 1) / tile_x,
                  (org_z + rows - (org_z & ~1) + tile_z - 1) / tile_z);
  const float* src = in;
  for (int i = 0; i < launches; ++i) {
    const int m = per_launch[i];
    const size_t bytes = Layout(m, tile_z, tile_x).bytes();
    if (m < 1 || bytes > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : tmp;
    thermal_tile<<<grid, threads, bytes, stream>>>(src, dst, rows, cols, org_z, org_x, res, m,
                                                   tile_z, tile_x, max_diff, increment);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaSuccess);
}
