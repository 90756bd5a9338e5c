"""Gaussian blur helpers — the subset of ``noize_tpu.ops.blur`` the
flagship blur needs.  The blur itself runs on kernel K1
(``ops.cuda.stencil.gauss_chain``)."""

from __future__ import annotations

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
