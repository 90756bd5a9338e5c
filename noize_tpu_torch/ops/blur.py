"""Parametric Gaussian / box blur — port of ``noize_tpu.ops.blur``.

``gauss_blur`` and ``smooth_blur`` are one separable X/Z pass each, in
plain PyTorch.  The blur stages and the flagship run whole chains of them
on kernel K1 (``ops.cuda.stencil``).
"""

from __future__ import annotations

import numpy as np

from .kernels import gaussian_taps, separable_series

MAX_WIDTH = 25

#: GaussSigma enum parity (BlurKernels.cs:8-25): s0d50 → 0.5 ... s8d00 → 8.0.
GAUSS_SIGMAS = tuple(0.5 * (i + 1) for i in range(16))
GAUSS_SIGMA_NAMES = tuple(
    f"s{int(s)}d{int(round((s % 1) * 100)):02d}" for s in GAUSS_SIGMAS
)


def limit_width(width: int) -> int:
    """BlurHelper.limitWidth: even widths round up, clamped to [3, 25]."""
    if width % 2 == 0:
        width += 1
    return max(3, min(width, MAX_WIDTH))


def sigma_value(sigma) -> float:
    """Accept 0.5..8.0 float, enum index, or name like 's2d50'."""
    if isinstance(sigma, str):
        return GAUSS_SIGMAS[GAUSS_SIGMA_NAMES.index(sigma)]
    if isinstance(sigma, int) and sigma < len(GAUSS_SIGMAS):
        return GAUSS_SIGMAS[sigma]
    return float(sigma)


def smooth_taps(width: int) -> np.ndarray:
    """SmoothBlur.GetKernel (BlurKernels.cs:40-44): box of 1/width."""
    return np.full((width,), 1.0 / width, np.float32)


def gauss_blur(a, width: int, sigma):
    """GaussFilter.Schedule (BlurJob.cs:11-21): separable X/Z pass."""
    width = limit_width(width)
    taps = gaussian_taps(sigma_value(sigma), width)
    return separable_series(a, taps, taps, 1.0)


def smooth_blur(a, width: int):
    """SmoothFilter.Schedule (BlurJob.cs:34-44)."""
    width = limit_width(width)
    taps = smooth_taps(width)
    return separable_series(a, taps, taps, 1.0)
