"""Gradient noise primitives — port of ``noize_tpu.ops.noise``.

Only 2-D simplex noise (``snoise2``) is on the flagship path and ported
here, with the shared webgl-noise helpers it uses.  The other noise bases
of the reference (``cnoise2``, ``cnoise3``, ``snoise3``, ``psrnoise2``,
``cellular2``) are not ported yet; ``fractal.noise_value`` raises
``NotImplementedError`` for the bases built on them.

All functions take and return float32 tensors of one shape.  The lattice
hashing relies on exact small-integer float32 arithmetic, so never run
them in reduced precision.  Python constants multiply as float32, exactly
as JAX's weakly typed scalars do.
"""

from __future__ import annotations

import torch


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    """Ashima permutation polynomial: mod289((34 x + 1) x)."""
    return _mod289((34.0 * x + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _frac(x):
    return x - torch.floor(x)


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

    i1 = (x0 > y0).to(x.dtype)
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
