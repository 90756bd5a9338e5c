"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.ops.f32``.

float32 arithmetic that rounds the way the reference does, on the CPU
and on the card alike."""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x):
    """Correctly rounded float32 square root.  PyTorch's vectorised CPU
    ``sqrt`` is off by one ulp on ~0.5% of float32 inputs (XLA's and CUDA's
    are exact); the float64 root rounded to float32 is exact everywhere."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def recip(c) -> float:
    """float32 reciprocal of a constant divisor: XLA's algebraic simplifier
    turns ``x / c`` into ``x * (1/c)`` in every compiled JAX program, and
    writing the product keeps the CPU and the card on the same bits."""
    return float(np.float32(1.0) / np.float32(c))


# --- host-scalar transcendentals -------------------------------------------
# The reference computes the fractal's octave gain exp2(-hurst) and thermal's
# tan(talus angle) on the host's XLA runtime.  Its CPU backend evaluates exp
# with its own polynomial (the Cephes range reduction and polynomial, fused
# multiply-adds) and tan with the C library's tanf; neither is correctly
# rounded, so PyTorch's exp2 and tan differ from both by an ulp on some
# inputs.  The functions below replay those two recipes step by step in
# float32 (the C library's argument reduction in float64), on NumPy scalars
# or arrays, so the port's constants carry the reference's bits.

_F = np.float32


def _bits(x):
    return np.asarray(x, _F).view(np.int32)


def _fma(a, b, c):
    """float32 fused multiply-add, rounded once: the product is exact in
    float64, and a sum that rounds to a float32 halfway point in float64 is
    moved toward its exact value before the final rounding."""
    p = np.asarray(a, _F).astype(np.float64) * np.asarray(b, _F).astype(np.float64)
    c = np.asarray(c, _F).astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    half = (np.asarray(s).view(np.int64) & ((1 << 29) - 1)) == (1 << 28)
    nudge = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    return np.where(half & (err != 0), nudge, s).astype(_F)


_LN2 = _F(np.log(2.0))
_LOG2E = _F(1.44269504088896341)
_EXP_C1 = _F(0.693359375)
_EXP_C2 = _F(-2.12194440e-4)
_EXP_P = tuple(_F(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                               4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def exp2(x):
    """float32 ``2 ** x`` as the reference's XLA CPU runtime evaluates
    ``jnp.exp2``: ``exp(x · f32(ln 2))`` with XLA's own exp (clamp, n =
    floor(y·log2(e) + ½), Cody-Waite reduction by ln 2 in two parts, a
    degree-5 polynomial, all in fused multiply-adds, scaled by 2ⁿ).
    Bit-equal to ``jnp.exp2`` on every float32 x in [-2, 0]
    (``scripts/host_scalar_parity.py``)."""
    with np.errstate(all="ignore"):
        y = np.clip(np.asarray(x, _F) * _LN2, _F(-87.8), _F(88.8)).astype(_F)
        n = np.clip(np.floor(_fma(y, _LOG2E, _F(0.5))), _F(-127), _F(127)).astype(_F)
        r = (y - _EXP_C1 * n).astype(_F)          # exact: C1 has 9 bits
        r = _fma(-_EXP_C2, n, r)
        z = _fma(r, _EXP_P[0], _EXP_P[1])
        for c in _EXP_P[2:]:
            z = _fma(z, r, c)
        z = _fma(z, (r * r).astype(_F), r)
        z = (_F(1) + z).astype(_F)
        out = np.ldexp(z, n.astype(np.int32)).astype(_F)
        out = np.where(out < np.finfo(_F).tiny, _F(0), out)  # XLA flushes subnormals
    return out[()] if out.ndim == 0 else out


_PIO4 = _F(0.785398125648)           # 0x3f490fda
_PIO4LO = _F(3.77489470793e-08)      # 0x33222168
# the tangent's odd series, T[0] .. T[12] (the C library's __kernel_tanf)
_TAN_T = tuple(np.array([0x3eaaaaab, 0x3e088889, 0x3d5d0dd1, 0x3cb327a4, 0x3c11371f,
                         0x3b6b6916, 0x3abede48, 0x3a1a26c8, 0x398137b9, 0x38a3f445,
                         0x3895c07a, 0xb79bae5f, 0x37d95384], np.uint32).view(_F))


def _kernel_tan(x, y, iy, hx):
    """tan(x + y) for |x + y| <= π/4 (``iy`` = 1), or -1/tan (``iy`` = -1),
    every step in float32; ``hx`` the bits of x."""
    T = _TAN_T
    ix = hx & 0x7FFFFFFF
    big = ix > 0x3F2CA13F                      # |x| >= 0.6744: tan(π/4 - x)
    neg = big & (hx < 0)
    x = np.where(neg, -x, x)
    y = np.where(neg, -y, y)
    xb = (_PIO4LO - y) + (_PIO4 - x)
    x = np.where(big, xb, x).astype(_F)
    tiny_b = big & (np.abs(x) < _F(2.0 ** -13))
    y = np.where(big, _F(0), y).astype(_F)
    sign = (1 - ((hx >> 30) & 2)).astype(np.int32)
    z = x * x
    s = x * z
    w = z * z
    u = T[12]
    for c in (T[10], T[8], T[6], T[4], T[2]):
        u = u * w + c
    r = T[11]
    for c in (T[9], T[7], T[5], T[3], T[1]):
        r = r * w + c
    t = (u * z + r) * s
    t = (t + y) * z
    r = (s * T[0]) + (y + t)
    w = x + r
    v = iy.astype(_F)
    out_big = sign.astype(_F) * (v - (x - (w * w / (w + v) - r)) * _F(2))
    # -1/(x + r) to within an ulp (iy = -1 below 0.6744)
    a = _F(-1) / w
    zt = (w.view(np.int32) & np.int32(-4096)).view(_F)
    tt = (a.view(np.int32) & np.int32(-4096)).view(_F)
    out_inv = tt + a * ((zt * tt + _F(1)) + (r - (zt - x)) * tt)
    out = np.where(big, out_big, np.where(iy == 1, w, out_inv))
    out_tiny_b = (sign * iy).astype(_F) * (_F(1) - (_F(2) * iy.astype(_F)) * x)
    out = np.where(tiny_b, out_tiny_b, out)
    tiny = ix <= 0x38FFFFFF                    # |x| < 2**-13
    out_tiny = np.where(iy == 1, x, np.where(ix == 0, _F(1) / np.abs(x), _F(-1) / x))
    return np.where(tiny, out_tiny, out).astype(_F)


def tan(x):
    """float32 tangent as the reference's XLA CPU runtime evaluates
    ``jnp.tan`` (the C library's tanf: reduction by π/2 in float64, the
    float32 kernel on the two-part remainder).  |x| < 120 only; bit-equal
    to ``jnp.tan`` on every angle the thermal talus gives
    (``scripts/host_scalar_parity.py``)."""
    x = np.asarray(x, _F)
    if np.any(~(np.abs(x) < 120)):
        raise ValueError("f32.tan: |x| must be below 120")
    with np.errstate(all="ignore"):
        hx = _bits(x)
        small = (hx & 0x7FFFFFFF) <= 0x3F490FDA  # |x| <= π/4: no reduction
        xd = x.astype(np.float64)
        n = ((np.trunc(xd * 10680707.430881744).astype(np.int32) + 0x800000) >> 24)
        xd = xd - n.astype(np.float64) * 1.5707963267948966
        y0 = xd.astype(_F)
        y1 = (xd - y0.astype(np.float64)).astype(_F)
        x0 = np.where(small, x, y0).astype(_F)
        x1 = np.where(small, _F(0), y1).astype(_F)
        iy = np.where(small, 1, 1 - ((2 * n) & 2)).astype(np.int32)
        out = _kernel_tan(x0, x1, iy, _bits(x0))
    return out[()] if out.ndim == 0 else out
