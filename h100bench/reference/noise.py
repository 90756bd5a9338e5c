"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.ops.noise``.

Gradient and cellular noise primitives — port of ``noize_tpu.ops.noise``:
classic Perlin (``cnoise2``, ``cnoise3``), simplex (``snoise2``,
``snoise3``), periodic simplex with rotating gradients (``psrnoise2``) and
Worley noise (``cellular2``), the webgl-noise algorithms behind Unity's
``noise.*``.

All functions take and return float32 tensors of one shape and run on
their inputs' device.  The lattice hashing relies on exact small-integer
float32 arithmetic, so never run them in reduced precision.  Python
constants multiply as float32, exactly as JAX's weakly typed scalars do.

Two documented choices of the reference are kept (PARITY.md):

  * D2: ``cnoise3`` and ``snoise3`` decide their gradient branch with an
    exact integer predicate on the hash digits, not on rounded float
    arithmetic;
  * D6: ``psrnoise2`` wraps its period with a truncated fmod (Unity's
    ``math.fmod``, C#'s ``%``): ``torch.fmod``, as ``jnp.fmod``, not the
    floored ``torch.remainder``.

``cellular2``'s square roots use ``f32.sqrt`` (PyTorch's CPU ``sqrt`` is
not correctly rounded).  ``psrnoise2``'s gradients call ``torch.cos`` and
``torch.sin``, which are other approximations than XLA's.
"""

from __future__ import annotations

import torch

from .f32 import sqrt


# ---------------------------------------------------------------------------
# shared helpers (webgl-noise "common" block)
# ---------------------------------------------------------------------------

def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _mod7(x):
    return x - torch.floor(x * (1.0 / 7.0)) * 7.0


def _permute(x):
    """Ashima permutation polynomial: mod289((34 x + 1) x)."""
    return _mod289((34.0 * x + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _frac(x):
    return x - torch.floor(x)


def _step(cond):
    """``jnp.where(cond, 1.0, 0.0)`` as float32."""
    return cond.to(torch.float32)


# ---------------------------------------------------------------------------
# classic Perlin noise (cnoise)
# ---------------------------------------------------------------------------

def cnoise2(x, y):
    """Classic Perlin noise, 2D; parity with noise.cnoise(float2)
    (``noize_tpu.ops.noise.cnoise2``).  Output approximately in [-1, 1]."""
    ix0 = torch.floor(x)
    iy0 = torch.floor(y)
    fx0 = x - ix0
    fy0 = y - iy0
    fx1 = fx0 - 1.0
    fy1 = fy0 - 1.0
    ix0 = _mod289(ix0)
    iy0 = _mod289(iy0)
    ix1 = _mod289(ix0 + 1.0)
    iy1 = _mod289(iy0 + 1.0)

    def grad(ix, iy, fx, fy):
        i = _permute(_permute(ix) + iy)
        gx = _frac(i * (1.0 / 41.0)) * 2.0 - 1.0
        gy = torch.abs(gx) - 0.5
        tx = torch.floor(gx + 0.5)
        gx = gx - tx
        norm = _taylor_inv_sqrt(gx * gx + gy * gy)
        return norm * (gx * fx + gy * fy)

    n00 = grad(ix0, iy0, fx0, fy0)
    n10 = grad(ix1, iy0, fx1, fy0)
    n01 = grad(ix0, iy1, fx0, fy1)
    n11 = grad(ix1, iy1, fx1, fy1)

    fx = _fade(fx0)
    fy = _fade(fy0)
    nx0 = n00 + fx * (n10 - n00)
    nx1 = n01 + fx * (n11 - n01)
    return 2.3 * (nx0 + fy * (nx1 - nx0))


def cnoise3(x, y, z):
    """Classic Perlin noise, 3D; parity with noise.cnoise(float3), with the
    exact branch predicate of PARITY.md D2."""
    ix0 = _mod289(torch.floor(x))
    iy0 = _mod289(torch.floor(y))
    iz0 = _mod289(torch.floor(z))
    ix1 = _mod289(ix0 + 1.0)
    iy1 = _mod289(iy0 + 1.0)
    iz1 = _mod289(iz0 + 1.0)
    fx0 = _frac(x)
    fy0 = _frac(y)
    fz0 = _frac(z)
    fx1 = fx0 - 1.0
    fy1 = fy0 - 1.0
    fz1 = fz0 - 1.0

    def grad(ix, iy, iz, fx, fy, fz):
        # the hash's two base-7 digits (k, m), exact in float32; the branch
        # gz <= 0 is the integer predicate 2k + |2m - 7| >= 7
        i = _permute(_permute(_permute(ix) + iy) + iz)
        q = torch.floor(i * (1.0 / 7.0))
        k = i - 7.0 * q
        m = q - 7.0 * torch.floor(q * (1.0 / 7.0))
        gx = k * (1.0 / 7.0)
        gy = m * (1.0 / 7.0) - 0.5
        gz = 0.5 - gx - torch.abs(gy)
        sz = _step(2.0 * k + torch.abs(2.0 * m - 7.0) >= 7.0)
        gx = gx - sz * 0.5
        gy = gy - sz * (_step(m >= 4.0) - 0.5)
        norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
        return norm * (gx * fx + gy * fy + gz * fz)

    n000 = grad(ix0, iy0, iz0, fx0, fy0, fz0)
    n100 = grad(ix1, iy0, iz0, fx1, fy0, fz0)
    n010 = grad(ix0, iy1, iz0, fx0, fy1, fz0)
    n110 = grad(ix1, iy1, iz0, fx1, fy1, fz0)
    n001 = grad(ix0, iy0, iz1, fx0, fy0, fz1)
    n101 = grad(ix1, iy0, iz1, fx1, fy0, fz1)
    n011 = grad(ix0, iy1, iz1, fx0, fy1, fz1)
    n111 = grad(ix1, iy1, iz1, fx1, fy1, fz1)

    fx = _fade(fx0)
    fy = _fade(fy0)
    fz = _fade(fz0)
    nz00 = n000 + fz * (n001 - n000)
    nz10 = n100 + fz * (n101 - n100)
    nz01 = n010 + fz * (n011 - n010)
    nz11 = n110 + fz * (n111 - n110)
    ny0 = nz00 + fy * (nz01 - nz00)
    ny1 = nz10 + fy * (nz11 - nz10)
    return 2.2 * (ny0 + fx * (ny1 - ny0))


# ---------------------------------------------------------------------------
# simplex noise (snoise)
# ---------------------------------------------------------------------------

def snoise2(x, y):
    """Simplex noise, 2D; parity with noise.snoise(float2)
    (``noize_tpu.ops.noise.snoise2``)."""
    C_x = 0.211324865405187  # (3 - sqrt(3)) / 6
    C_y = 0.366025403784439  # 0.5 * (sqrt(3) - 1)
    C_z = -0.577350269189626  # -1 + 2 * C_x
    C_w = 0.024390243902439  # 1 / 41

    s = (x + y) * C_y
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * C_x
    x0 = x - i + t
    y0 = y - j + t

    i1 = _step(x0 > y0)
    j1 = 1.0 - i1
    x1 = x0 + C_x - i1
    y1 = y0 + C_x - j1
    x2 = x0 + C_z
    y2 = y0 + C_z

    i = _mod289(i)
    j = _mod289(j)
    p0 = _permute(_permute(j) + i)
    p1 = _permute(_permute(j + j1) + i + i1)
    p2 = _permute(_permute(j + 1.0) + i + 1.0)

    def surflet(p, xd, yd):
        m = torch.clamp_min(0.5 - (xd * xd + yd * yd), 0.0)
        m = m * m
        m = m * m
        gx = 2.0 * _frac(p * C_w) - 1.0
        h = torch.abs(gx) - 0.5
        ox = torch.floor(gx + 0.5)
        a0 = gx - ox
        m = m * _taylor_inv_sqrt(a0 * a0 + h * h)
        return m * (a0 * xd + h * yd)

    n = surflet(p0, x0, y0) + surflet(p1, x1, y1) + surflet(p2, x2, y2)
    return 130.0 * n


def snoise3(x, y, z):
    """Simplex noise, 3D; parity with noise.snoise(float3), with the exact
    branch predicate of PARITY.md D2."""
    C_x = 1.0 / 6.0
    C_y = 1.0 / 3.0

    s = (x + y + z) * C_y
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    k = torch.floor(z + s)
    t = (i + j + k) * C_x
    x0 = x - i + t
    y0 = y - j + t
    z0 = z - k + t

    # rank the components to pick the simplex traversal order
    gx = _step(x0 >= y0)
    gy = _step(y0 >= z0)
    gz = _step(z0 >= x0)
    lx = 1.0 - gx
    ly = 1.0 - gy
    lz = 1.0 - gz
    i1 = torch.minimum(gx, lz)
    j1 = torch.minimum(gy, lx)
    k1 = torch.minimum(gz, ly)
    i2 = torch.maximum(gx, lz)
    j2 = torch.maximum(gy, lx)
    k2 = torch.maximum(gz, ly)

    x1 = x0 - i1 + C_x
    y1 = y0 - j1 + C_x
    z1 = z0 - k1 + C_x
    x2 = x0 - i2 + C_y
    y2 = y0 - j2 + C_y
    z2 = z0 - k2 + C_y
    x3 = x0 - 0.5
    y3 = y0 - 0.5
    z3 = z0 - 0.5

    i = _mod289(i)
    j = _mod289(j)
    k = _mod289(k)
    p0 = _permute(_permute(_permute(k) + j) + i)
    p1 = _permute(_permute(_permute(k + k1) + j + j1) + i + i1)
    p2 = _permute(_permute(_permute(k + k2) + j + j2) + i + i2)
    p3 = _permute(_permute(_permute(k + 1.0) + j + 1.0) + i + 1.0)

    ns_x = 2.0 / 7.0
    ns_y = 0.5 / 7.0 - 1.0
    ns_z = 1.0 / 7.0

    def gradp(p):
        # h <= 0 is decided on the exact digits: |4x-13| + |4y-13| >= 14
        jv = p - 49.0 * torch.floor(p * (ns_z * ns_z))  # p mod 49, exact
        x_ = torch.floor(jv * ns_z)                     # jv div 7, exact
        y_ = jv - 7.0 * x_                              # jv mod 7, exact
        gx = x_ * ns_x + ns_y                           # (4x - 13) / 14
        gy = y_ * ns_x + ns_y
        h = 1.0 - torch.abs(gx) - torch.abs(gy)
        sx = torch.where(x_ <= 3.0, -1.0, 1.0)          # sign(gx), exact
        sy = torch.where(y_ <= 3.0, -1.0, 1.0)
        a_ = torch.abs(4.0 * x_ - 13.0)
        b_ = torch.abs(4.0 * y_ - 13.0)
        sh = -_step(a_ + b_ >= 14.0)                     # h <= 0, exact
        gx = gx + sx * sh
        gy = gy + sy * sh
        return gx, gy, h

    def surflet(p, xd, yd, zd):
        gx, gy, gz = gradp(p)
        norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
        gx = gx * norm
        gy = gy * norm
        gz = gz * norm
        m = torch.clamp_min(0.6 - (xd * xd + yd * yd + zd * zd), 0.0)
        m = m * m
        return m * m * (gx * xd + gy * yd + gz * zd)

    n = (surflet(p0, x0, y0, z0) + surflet(p1, x1, y1, z1)
         + surflet(p2, x2, y2, z2) + surflet(p3, x3, y3, z3))
    return 42.0 * n


# ---------------------------------------------------------------------------
# periodic simplex noise with rotating gradients (psrnoise) — 2D
# ---------------------------------------------------------------------------

def _rgrad2(px, py, rot):
    u = _permute(_permute(px) + py) * 0.0243902439 + rot  # 1/41 shift rotate
    u = _frac(u) * 6.28318530718
    return torch.cos(u), torch.sin(u)


def psrnoise2(x, y, per_x, per_y, rot=0.0):
    """Periodic simplex noise with rotating gradients (Gustavson
    psrdnoise2D); parity with noise.psrnoise(float2, float2[, rot]).  The
    period wraps with a truncated fmod (PARITY.md D6)."""
    # the published source offsets y slightly to hide artifacts
    y = y + 0.001

    # skew to the hexagonal grid
    uvx = x + y * 0.5
    uvy = y
    i0x = torch.floor(uvx)
    i0y = torch.floor(uvy)
    f0x = uvx - i0x
    f0y = uvy - i0y
    i1x = _step(f0x > f0y)
    i1y = 1.0 - i1x

    # unskewed grid points
    p0x = i0x - i0y * 0.5
    p0y = i0y
    p1x = p0x + i1x - i1y * 0.5
    p1y = p0y + i1y
    p2x = p0x + 0.5
    p2y = p0y + 1.0

    d0x = x - p0x
    d0y = y - p0y
    d1x = x - p1x
    d1y = y - p1y
    d2x = x - p2x
    d2y = y - p2y

    # wrap to the period in (x, y), then map back to (u, v) for hashing
    def wrap(px, py):
        xw = torch.fmod(px, per_x)
        yw = torch.fmod(py, per_y)
        return xw + 0.5 * yw, yw

    g0x, g0y = _rgrad2(*wrap(p0x, p0y), rot)
    g1x, g1y = _rgrad2(*wrap(p1x, p1y), rot)
    g2x, g2y = _rgrad2(*wrap(p2x, p2y), rot)

    w0 = g0x * d0x + g0y * d0y
    w1 = g1x * d1x + g1y * d1y
    w2 = g2x * d2x + g2y * d2y

    def t4(dx, dy):
        t = torch.clamp_min(0.8 - (dx * dx + dy * dy), 0.0)
        t = t * t
        return t * t

    n = t4(d0x, d0y) * w0 + t4(d1x, d1y) * w1 + t4(d2x, d2y) * w2
    return 11.0 * n


# ---------------------------------------------------------------------------
# cellular (Worley) noise — 2D, returns (F1, F2)
# ---------------------------------------------------------------------------

def cellular2(x, y):
    """Cellular (Worley) noise, 2D, 3x3 search; parity with
    noise.cellular(float2).  Returns ``(F1, F2)``, the distances to the
    nearest and second-nearest feature points."""
    K = 0.142857142857  # 1/7
    Ko = 0.428571428571  # 3/7
    jitter = 1.0

    Pix = _mod289(torch.floor(x))
    Piy = _mod289(torch.floor(y))
    Pfx = _frac(x)
    Pfy = _frac(y)

    oi = (-1.0, 0.0, 1.0)
    of = (-0.5, 0.5, 1.5)

    px = [_permute(Pix + o) for o in oi]

    def column(pxc, dx_base):
        d = []
        for row in range(3):
            p = _permute(pxc + Piy + oi[row])
            ox = _frac(p * K) - Ko
            oy = _mod7(torch.floor(p * K)) * K - Ko
            dx = Pfx + dx_base + jitter * ox
            dy = Pfy - of[row] + jitter * oy
            d.append(dx * dx + dy * dy)
        return d

    d1 = column(px[0], 0.5)   # column x-1 → Pf.x + 0.5
    d2 = column(px[1], -0.5)  # column x   → Pf.x - 0.5
    d3 = column(px[2], -1.5)  # column x+1 → Pf.x - 1.5

    # the two smallest distances, elementwise (Ashima swap network)
    d1a = [torch.minimum(a, b) for a, b in zip(d1, d2)]
    d2_ = [torch.maximum(a, b) for a, b in zip(d1, d2)]
    d2_ = [torch.minimum(a, b) for a, b in zip(d2_, d3)]
    d1_ = [torch.minimum(a, b) for a, b in zip(d1a, d2_)]
    d2_ = [torch.maximum(a, b) for a, b in zip(d1a, d2_)]

    swap_xy = d1_[0] < d1_[1]
    d1x = torch.where(swap_xy, d1_[0], d1_[1])
    d1y = torch.where(swap_xy, d1_[1], d1_[0])
    swap_xz = d1x < d1_[2]
    d1z = torch.where(swap_xz, d1_[2], d1x)
    d1x = torch.where(swap_xz, d1x, d1_[2])
    d1y = torch.minimum(d1y, d2_[1])
    d1z = torch.minimum(d1z, d2_[2])
    d1y = torch.minimum(d1y, d1z)
    d1y = torch.minimum(d1y, d2_[0])
    return sqrt(d1x), sqrt(d1y)
