// The fBm's noise bases for K10 (fractal.cu): ops/noise.py's cnoise2, cnoise3,
// snoise2, snoise3, psrnoise2 and cellular2 and ops/fractal.noise_value, one
// float32 cell at a time, each operation the plain version's in its order
// (common.cuh's __f*_rn; fractal.cu says why these equal the plain version
// bit for bit).  Host-compilable through a shim of the CUDA names
// (tests/test_torch_fractal_kernel.py builds it with g++ against the plain
// version on the CPU).
#pragma once

#include "common.cuh"

namespace noize::noise {

// The plain version's constants (ops/noise.py, ops/fractal.py), each the
// float32 rounding of the Python expression after "=".
constexpr float kInv289 = 0x1.c5894ep-9f;     // = 1.0 / 289.0
constexpr float kInv7 = 0x1.24924ap-3f;       // = 1.0 / 7.0
constexpr float kInv41 = 0x1.8f9c18p-6f;      // = 1.0 / 41.0
constexpr float kTaylorA = 0x1.caf7c0p+0f;    // = 1.79284291400159
constexpr float kTaylorB = 0x1.b51cb8p-1f;    // = 0.85373472095314
constexpr float kS2Cx = 0x1.b0cb18p-3f;       // = 0.211324865405187
constexpr float kS2Cy = 0x1.76cf5ep-2f;       // = 0.366025403784439
constexpr float kS2Cz = -0x1.279a74p-1f;      // = -0.577350269189626
constexpr float kS2Cw = 0x1.8f9c18p-6f;       // = 0.024390243902439
constexpr float kS3Cx = 0x1.555556p-3f;       // = 1.0 / 6.0
constexpr float kS3Cy = 0x1.555556p-2f;       // = 1.0 / 3.0
constexpr float kNsX = 0x1.24924ap-2f;        // = 2.0 / 7.0
constexpr float kNsY = -0x1.db6db6p-1f;       // = 0.5 / 7.0 - 1.0
constexpr float kNsZ2 = 0x1.4e5e0ap-6f;       // = (1.0 / 7.0) * (1.0 / 7.0)
constexpr float kPsrY = 0x1.0624dep-10f;      // = 0.001
constexpr float kPsrW = 0x1.8f9c18p-6f;       // = 0.0243902439
constexpr float kTwoPi = 0x1.921fb6p+2f;      // = 6.28318530718
constexpr float kRot = 0x1.3d70a4p-1f;        // = 0.62
constexpr float kCellK = 0x1.24924ap-3f;      // = 0.142857142857
constexpr float kCellKo = 0x1.b6db6ep-2f;     // = 0.428571428571
constexpr float kRotS2 = -0x1.b0cb18p-3f;     // = -0.211324865405187
constexpr float kRotY = -0x1.279a74p-1f;      // = -0.577350269189626
constexpr float kC2_3 = 0x1.266666p+1f;       // = 2.3
constexpr float kC2_2 = 0x1.19999ap+1f;       // = 2.2
constexpr float kC0_6 = 0x1.333334p-1f;       // = 0.6
constexpr float kC0_8 = 0x1.99999ap-1f;       // = 0.8

// --- the webgl-noise common block -----------------------------------------

__device__ __forceinline__ float mod289(float x) {
  return sub(x, mul(floorf(mul(x, kInv289)), 289.0f));
}

__device__ __forceinline__ float mod7(float x) { return sub(x, mul(floorf(mul(x, kInv7)), 7.0f)); }

__device__ __forceinline__ float permute(float x) {
  return mod289(mul(add(mul(34.0f, x), 1.0f), x));
}

__device__ __forceinline__ float taylor_inv_sqrt(float r) {
  return sub(kTaylorA, mul(kTaylorB, r));
}

__device__ __forceinline__ float fade(float t) {
  return mul(mul(mul(t, t), t), add(mul(t, sub(mul(t, 6.0f), 15.0f)), 10.0f));
}

__device__ __forceinline__ float frac(float x) { return sub(x, floorf(x)); }

__device__ __forceinline__ float step(bool c) { return c ? 1.0f : 0.0f; }

__device__ __forceinline__ float rectify_half(float v) { return mul(add(1.0f, v), 0.5f); }

// --- classic Perlin (noise.cnoise2, cnoise3) -------------------------------

__device__ __forceinline__ float cgrad2(float ix, float iy, float fx, float fy) {
  const float i = permute(add(permute(ix), iy));
  float gx = sub(mul(frac(mul(i, kInv41)), 2.0f), 1.0f);
  const float gy = sub(fabsf(gx), 0.5f);
  const float tx = floorf(add(gx, 0.5f));
  gx = sub(gx, tx);
  const float norm = taylor_inv_sqrt(add(mul(gx, gx), mul(gy, gy)));
  return mul(norm, add(mul(gx, fx), mul(gy, fy)));
}

__device__ __forceinline__ float cnoise2(float x, float y) {
  float ix0 = floorf(x);
  float iy0 = floorf(y);
  const float fx0 = sub(x, ix0);
  const float fy0 = sub(y, iy0);
  const float fx1 = sub(fx0, 1.0f);
  const float fy1 = sub(fy0, 1.0f);
  ix0 = mod289(ix0);
  iy0 = mod289(iy0);
  const float ix1 = mod289(add(ix0, 1.0f));
  const float iy1 = mod289(add(iy0, 1.0f));
  const float n00 = cgrad2(ix0, iy0, fx0, fy0);
  const float n10 = cgrad2(ix1, iy0, fx1, fy0);
  const float n01 = cgrad2(ix0, iy1, fx0, fy1);
  const float n11 = cgrad2(ix1, iy1, fx1, fy1);
  const float fx = fade(fx0);
  const float fy = fade(fy0);
  const float nx0 = add(n00, mul(fx, sub(n10, n00)));
  const float nx1 = add(n01, mul(fx, sub(n11, n01)));
  return mul(kC2_3, add(nx0, mul(fy, sub(nx1, nx0))));
}

// The gradient's branch gz <= 0 on the hash's exact base-7 digits (PARITY.md D2).
__device__ __forceinline__ float cgrad3(float ix, float iy, float iz, float fx, float fy,
                                        float fz) {
  const float i = permute(add(permute(add(permute(ix), iy)), iz));
  const float q = floorf(mul(i, kInv7));
  const float k = sub(i, mul(7.0f, q));
  const float m = sub(q, mul(7.0f, floorf(mul(q, kInv7))));
  float gx = mul(k, kInv7);
  float gy = sub(mul(m, kInv7), 0.5f);
  const float gz = sub(sub(0.5f, gx), fabsf(gy));
  const float sz = step(add(mul(2.0f, k), fabsf(sub(mul(2.0f, m), 7.0f))) >= 7.0f);
  gx = sub(gx, mul(sz, 0.5f));
  gy = sub(gy, mul(sz, sub(step(m >= 4.0f), 0.5f)));
  const float norm = taylor_inv_sqrt(add(add(mul(gx, gx), mul(gy, gy)), mul(gz, gz)));
  return mul(norm, add(add(mul(gx, fx), mul(gy, fy)), mul(gz, fz)));
}

__device__ __forceinline__ float cnoise3(float x, float y, float z) {
  const float ix0 = mod289(floorf(x));
  const float iy0 = mod289(floorf(y));
  const float iz0 = mod289(floorf(z));
  const float ix1 = mod289(add(ix0, 1.0f));
  const float iy1 = mod289(add(iy0, 1.0f));
  const float iz1 = mod289(add(iz0, 1.0f));
  const float fx0 = frac(x);
  const float fy0 = frac(y);
  const float fz0 = frac(z);
  const float fx1 = sub(fx0, 1.0f);
  const float fy1 = sub(fy0, 1.0f);
  const float fz1 = sub(fz0, 1.0f);
  const float n000 = cgrad3(ix0, iy0, iz0, fx0, fy0, fz0);
  const float n100 = cgrad3(ix1, iy0, iz0, fx1, fy0, fz0);
  const float n010 = cgrad3(ix0, iy1, iz0, fx0, fy1, fz0);
  const float n110 = cgrad3(ix1, iy1, iz0, fx1, fy1, fz0);
  const float n001 = cgrad3(ix0, iy0, iz1, fx0, fy0, fz1);
  const float n101 = cgrad3(ix1, iy0, iz1, fx1, fy0, fz1);
  const float n011 = cgrad3(ix0, iy1, iz1, fx0, fy1, fz1);
  const float n111 = cgrad3(ix1, iy1, iz1, fx1, fy1, fz1);
  const float fx = fade(fx0);
  const float fy = fade(fy0);
  const float fz = fade(fz0);
  const float nz00 = add(n000, mul(fz, sub(n001, n000)));
  const float nz10 = add(n100, mul(fz, sub(n101, n100)));
  const float nz01 = add(n010, mul(fz, sub(n011, n010)));
  const float nz11 = add(n110, mul(fz, sub(n111, n110)));
  const float ny0 = add(nz00, mul(fy, sub(nz01, nz00)));
  const float ny1 = add(nz10, mul(fy, sub(nz11, nz10)));
  return mul(kC2_2, add(ny0, mul(fx, sub(ny1, ny0))));
}

// --- simplex (noise.snoise2, snoise3) --------------------------------------

__device__ __forceinline__ float surflet2(float p, float xd, float yd) {
  float m = relu(sub(0.5f, add(mul(xd, xd), mul(yd, yd))));
  m = mul(m, m);
  m = mul(m, m);
  const float gx = sub(mul(2.0f, frac(mul(p, kS2Cw))), 1.0f);
  const float h = sub(fabsf(gx), 0.5f);
  const float ox = floorf(add(gx, 0.5f));
  const float a0 = sub(gx, ox);
  m = mul(m, taylor_inv_sqrt(add(mul(a0, a0), mul(h, h))));
  return mul(m, add(mul(a0, xd), mul(h, yd)));
}

__device__ __forceinline__ float snoise2(float x, float y) {
  const float s = mul(add(x, y), kS2Cy);
  float i = floorf(add(x, s));
  float j = floorf(add(y, s));
  const float t = mul(add(i, j), kS2Cx);
  const float x0 = add(sub(x, i), t);
  const float y0 = add(sub(y, j), t);
  const float i1 = step(x0 > y0);
  const float j1 = sub(1.0f, i1);
  const float x1 = sub(add(x0, kS2Cx), i1);
  const float y1 = sub(add(y0, kS2Cx), j1);
  const float x2 = add(x0, kS2Cz);
  const float y2 = add(y0, kS2Cz);
  i = mod289(i);
  j = mod289(j);
  const float p0 = permute(add(permute(j), i));
  const float p1 = permute(add(add(permute(add(j, j1)), i), i1));
  const float p2 = permute(add(add(permute(add(j, 1.0f)), i), 1.0f));
  const float n = add(add(surflet2(p0, x0, y0), surflet2(p1, x1, y1)), surflet2(p2, x2, y2));
  return mul(130.0f, n);
}

// A corner's gradient; h <= 0 decided on the exact digits (PARITY.md D2).
__device__ __forceinline__ float surflet3(float p, float xd, float yd, float zd) {
  const float jv = sub(p, mul(49.0f, floorf(mul(p, kNsZ2))));
  const float x_ = floorf(mul(jv, kInv7));
  const float y_ = sub(jv, mul(7.0f, x_));
  float gx = add(mul(x_, kNsX), kNsY);
  float gy = add(mul(y_, kNsX), kNsY);
  float gz = sub(sub(1.0f, fabsf(gx)), fabsf(gy));
  const float sx = x_ <= 3.0f ? -1.0f : 1.0f;
  const float sy = y_ <= 3.0f ? -1.0f : 1.0f;
  const float a_ = fabsf(sub(mul(4.0f, x_), 13.0f));
  const float b_ = fabsf(sub(mul(4.0f, y_), 13.0f));
  const float sh = -step(add(a_, b_) >= 14.0f);
  gx = add(gx, mul(sx, sh));
  gy = add(gy, mul(sy, sh));
  const float norm = taylor_inv_sqrt(add(add(mul(gx, gx), mul(gy, gy)), mul(gz, gz)));
  gx = mul(gx, norm);
  gy = mul(gy, norm);
  gz = mul(gz, norm);
  float m = relu(sub(kC0_6, add(add(mul(xd, xd), mul(yd, yd)), mul(zd, zd))));
  m = mul(m, m);
  return mul(mul(m, m), add(add(mul(gx, xd), mul(gy, yd)), mul(gz, zd)));
}

__device__ __forceinline__ float snoise3(float x, float y, float z) {
  const float s = mul(add(add(x, y), z), kS3Cy);
  float i = floorf(add(x, s));
  float j = floorf(add(y, s));
  float k = floorf(add(z, s));
  const float t = mul(add(add(i, j), k), kS3Cx);
  const float x0 = add(sub(x, i), t);
  const float y0 = add(sub(y, j), t);
  const float z0 = add(sub(z, k), t);
  const float gx = step(x0 >= y0);
  const float gy = step(y0 >= z0);
  const float gz = step(z0 >= x0);
  const float lx = sub(1.0f, gx);
  const float ly = sub(1.0f, gy);
  const float lz = sub(1.0f, gz);
  const float i1 = fmin2(gx, lz);
  const float j1 = fmin2(gy, lx);
  const float k1 = fmin2(gz, ly);
  const float i2 = fmax2(gx, lz);
  const float j2 = fmax2(gy, lx);
  const float k2 = fmax2(gz, ly);
  const float x1 = add(sub(x0, i1), kS3Cx);
  const float y1 = add(sub(y0, j1), kS3Cx);
  const float z1 = add(sub(z0, k1), kS3Cx);
  const float x2 = add(sub(x0, i2), kS3Cy);
  const float y2 = add(sub(y0, j2), kS3Cy);
  const float z2 = add(sub(z0, k2), kS3Cy);
  const float x3 = sub(x0, 0.5f);
  const float y3 = sub(y0, 0.5f);
  const float z3 = sub(z0, 0.5f);
  i = mod289(i);
  j = mod289(j);
  k = mod289(k);
  const float p0 = permute(add(permute(add(permute(k), j)), i));
  const float p1 = permute(add(add(permute(add(add(permute(add(k, k1)), j), j1)), i), i1));
  const float p2 = permute(add(add(permute(add(add(permute(add(k, k2)), j), j2)), i), i2));
  const float p3 =
      permute(add(add(permute(add(add(permute(add(k, 1.0f)), j), 1.0f)), i), 1.0f));
  const float n = add(add(add(surflet3(p0, x0, y0, z0), surflet3(p1, x1, y1, z1)),
                          surflet3(p2, x2, y2, z2)),
                      surflet3(p3, x3, y3, z3));
  return mul(42.0f, n);
}

// --- periodic simplex with rotating gradients (noise.psrnoise2) -----------

// The gradient at lattice point (px, py), wrapped to the period (truncated
// fmod, PARITY.md D6), rotated by rot: (cos u, sin u).
__device__ __forceinline__ void rgrad2(float px, float py, float rot, float& gx, float& gy) {
  const float yw = fmodf(py, 102.0f);
  const float xw = add(fmodf(px, 1010.0f), mul(0.5f, yw));
  float u = add(mul(permute(add(permute(xw), yw)), kPsrW), rot);
  u = mul(frac(u), kTwoPi);
  gx = cosf(u);
  gy = sinf(u);
}

__device__ __forceinline__ float t4(float dx, float dy) {
  float t = relu(sub(kC0_8, add(mul(dx, dx), mul(dy, dy))));
  t = mul(t, t);
  return mul(t, t);
}

// psrnoise2(x, y, 1010, 102, rot): the period of NoiseStage's two bases.
__device__ __forceinline__ float psrnoise2(float x, float y, float rot) {
  y = add(y, kPsrY);
  const float uvx = add(x, mul(y, 0.5f));
  const float uvy = y;
  const float i0x = floorf(uvx);
  const float i0y = floorf(uvy);
  const float f0x = sub(uvx, i0x);
  const float f0y = sub(uvy, i0y);
  const float i1x = step(f0x > f0y);
  const float i1y = sub(1.0f, i1x);
  const float p0x = sub(i0x, mul(i0y, 0.5f));
  const float p0y = i0y;
  const float p1x = sub(add(p0x, i1x), mul(i1y, 0.5f));
  const float p1y = add(p0y, i1y);
  const float p2x = add(p0x, 0.5f);
  const float p2y = add(p0y, 1.0f);
  const float d0x = sub(x, p0x);
  const float d0y = sub(y, p0y);
  const float d1x = sub(x, p1x);
  const float d1y = sub(y, p1y);
  const float d2x = sub(x, p2x);
  const float d2y = sub(y, p2y);
  float g0x, g0y, g1x, g1y, g2x, g2y;
  rgrad2(p0x, p0y, rot, g0x, g0y);
  rgrad2(p1x, p1y, rot, g1x, g1y);
  rgrad2(p2x, p2y, rot, g2x, g2y);
  const float w0 = add(mul(g0x, d0x), mul(g0y, d0y));
  const float w1 = add(mul(g1x, d1x), mul(g1y, d1y));
  const float w2 = add(mul(g2x, d2x), mul(g2y, d2y));
  const float n = add(add(mul(t4(d0x, d0y), w0), mul(t4(d1x, d1y), w1)), mul(t4(d2x, d2y), w2));
  return mul(11.0f, n);
}

// --- cellular (noise.cellular2): F1 * F2 rectified ---------------------------

// The three squared distances of one column of the 3x3 search.
__device__ __forceinline__ void cell_column(float pxc, float piy, float pfx, float pfy,
                                            float dx_base, float (&d)[3]) {
  const float oi[3] = {-1.0f, 0.0f, 1.0f};
  const float of[3] = {-0.5f, 0.5f, 1.5f};
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    const float p = permute(add(add(pxc, piy), oi[row]));
    const float ox = sub(frac(mul(p, kCellK)), kCellKo);
    const float oy = sub(mul(mod7(floorf(mul(p, kCellK))), kCellK), kCellKo);
    const float dx = add(add(pfx, dx_base), mul(1.0f, ox));  // jitter 1.0
    const float dy = add(sub(pfy, of[row]), mul(1.0f, oy));
    d[row] = add(mul(dx, dx), mul(dy, dy));
  }
}

__device__ __forceinline__ float cellular_value(float x, float y) {
  const float pix = mod289(floorf(x));
  const float piy = mod289(floorf(y));
  const float pfx = frac(x);
  const float pfy = frac(y);
  float d1[3], d2[3], d3[3];
  cell_column(permute(add(pix, -1.0f)), piy, pfx, pfy, 0.5f, d1);
  cell_column(permute(add(pix, 0.0f)), piy, pfx, pfy, -0.5f, d2);
  cell_column(permute(add(pix, 1.0f)), piy, pfx, pfy, -1.5f, d3);
  // the two smallest distances, the plain version's swap network
  float d1a[3], e2[3], e1[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    d1a[r] = fmin2(d1[r], d2[r]);
    e2[r] = fmin2(fmax2(d1[r], d2[r]), d3[r]);
    e1[r] = fmin2(d1a[r], e2[r]);
    e2[r] = fmax2(d1a[r], e2[r]);
  }
  const bool swap_xy = e1[0] < e1[1];
  float d1x = swap_xy ? e1[0] : e1[1];
  float d1y = swap_xy ? e1[1] : e1[0];
  const bool swap_xz = d1x < e1[2];
  float d1z = swap_xz ? e1[2] : d1x;
  d1x = swap_xz ? d1x : e1[2];
  d1y = fmin2(d1y, e2[1]);
  d1z = fmin2(d1z, e2[2]);
  d1y = fmin2(d1y, d1z);
  d1y = fmin2(d1y, e2[0]);
  return mul(rectify_half(__fsqrt_rn(d1x)), rectify_half(__fsqrt_rn(d1y)));
}

// --- the bases (ops/fractal.noise_value), by NOISE_TYPES index --------------

template <int B>
__device__ __forceinline__ float noise_value(float x, float z) {
  if constexpr (B == 0) {  // Sin
    const float vx = add(0.5f, mul(0.5f, sinf(x)));
    const float vz = add(0.5f, mul(0.5f, sinf(z)));
    return mul(vx, vz);
  } else if constexpr (B == 1) {  // Perlin
    return rectify_half(cnoise2(x, z));
  } else if constexpr (B == 2) {  // PeriodicPerlin
    return rectify_half(psrnoise2(x, z, 0.0f));
  } else if constexpr (B == 3) {  // Simplex
    return rectify_half(snoise2(x, z));
  } else if constexpr (B == 4) {  // RotatedSimplex
    return rectify_half(psrnoise2(x, z, kRot));
  } else if constexpr (B == 5) {  // Cellular
    return cellular_value(x, z);
  } else {  // DomainRotatedPerlin (6), DomainRotatedSimplex (7)
    const float xz = add(x, z);
    const float s2 = mul(xz, kRotS2);
    const float u = add(x, s2), v = add(z, s2), w = mul(xz, kRotY);
    return rectify_half(B == 6 ? cnoise3(u, v, w) : snoise3(u, v, w));
  }
}

// One cell's fBm (ops/fractal.fractal_window_plain): t += a_o * basis(f_o x,
// f_o z) over the octaves, then t / acc.
template <int B>
__device__ __forceinline__ float fbm(float xi, float zi, const float* f, const float* a,
                                     int octaves, float acc) {
  float t = 0.0f;
  for (int o = 0; o < octaves; ++o) {
    const float v = noise_value<B>(mul(f[o], xi), mul(f[o], zi));
    t = add(t, mul(a[o], v));
  }
  return divf(t, acc);
}

}  // namespace noize::noise
