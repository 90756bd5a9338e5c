"""Separable stencil kernels — port of ``noize_tpu.ops.kernels``: the
X / Z passes, the min filters, the tap tables and ``kernel_filter``
(KernelFilterStage's filter types).

Borders replicate the edge sample (the reference's clamped ``getIdx``), and
the Z pass applies the taps *flipped* relative to the X pass
(KernelOperators.cs:58-65; kernels.py:51-62) — irrelevant for symmetric
taps, load-bearing for Sobel/Prewitt.  Each output cell sums tap 0 first,
in the reference's order, and each pass multiplies its sum by ``factor``.
The min-filter window excludes the top tap (``k < k_off``): a 3-wide "min"
looks at offsets {-1, 0}.

On the card ``kernel_filter`` and the edge filters run their series on
kernel K1 (``ops.cuda.stencil.separable_chain``), and ``sobel2d`` on
K1@rss (``ops.cuda.stencil.root_sum_squares_chain``), which compute the
same numbers bit for bit; a CPU tensor takes the plain passes.
"""

from __future__ import annotations

import numpy as np
import torch

_F32_MAX = float(np.finfo(np.float32).max)


def _clamped_range(n: int, off: int, device):
    return torch.arange(-off, n + off, device=device).clamp_(0, n - 1)


def conv_x(a, taps, factor=1.0):
    """1-D correlation along x (columns): out[z,x] = Σ_d a[z, x+d]·taps[off+d].
    The last two axes are (z, x): a stack of maps ``[T, R, C]`` takes the
    pass map by map."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    w = a.shape[-1]
    ap = a[..., _clamped_range(w, off, a.device)]
    out = torch.zeros_like(a)
    for i in range(k):
        out = out + float(taps[i]) * ap[..., i:i + w]
    return out * factor


def conv_z(a, taps, factor=1.0):
    """1-D pass along z (rows) with the reference's flipped indexing:
    out[z,x] = Σ_d a[z+d, x]·taps[off-d], on the last two axes."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    h = a.shape[-2]
    ap = a[..., _clamped_range(h, off, a.device), :]
    out = torch.zeros_like(a)
    for i in range(k):
        # tap i multiplies the sample at offset d = off - i
        out = out + float(taps[i]) * ap[..., 2 * off - i:2 * off - i + h, :]
    return out * factor


def separable_series(a, taps_x, taps_z, factor=1.0):
    """X pass then Z pass (SeparableKernelFilter.ScheduleSeries)."""
    return conv_z(conv_x(a, taps_x, factor), taps_z, factor)


def min_x(a, size):
    """Min filter along x over offsets [-off, off) — note the open top end
    (KernelOperators.cs:86)."""
    off = (size - 1) // 2
    w = a.shape[1]
    ap = a[:, _clamped_range(w, off, a.device)]
    out = torch.full_like(a, _F32_MAX)
    for i in range(2 * off):  # offsets -off .. off-1
        out = torch.minimum(out, ap[:, i:i + w])
    return out


def min_z(a, size):
    off = (size - 1) // 2
    h = a.shape[0]
    ap = a[_clamped_range(h, off, a.device), :]
    out = torch.full_like(a, _F32_MAX)
    for i in range(2 * off):
        out = torch.minimum(out, ap[i:i + h, :])
    return out


def value_erosion(a, size=3):
    """ErosionKernelJob (KernelJob.cs:317-347): min-X pass then min-Z pass."""
    return min_z(min_x(a, size), size)


# ---------------------------------------------------------------------------
# tap tables (SeparableKernelFilter, KernelJob.cs:97-136)
# ---------------------------------------------------------------------------

def gaussian_taps(sigma: float, width: int) -> np.ndarray:
    """Normalized Gaussian taps exp(-k²/2σ²)/Σ, float32
    (``noize_tpu.ops.kernels.gaussian_taps``)."""
    off = (width - 1) // 2
    k = np.arange(-off, off + 1, dtype=np.float64)
    t = np.exp(-(k * k) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


_SMOOTH3 = np.array([1.0, 1.0, 1.0], np.float32)
_SMOOTH3_FACTOR = 1.0 / 3.0
_SOBEL3_HX = np.array([-1.0, 0.0, 1.0], np.float32)
_SOBEL3_HZ = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL3_VX = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL3_VZ = np.array([1.0, 0.0, -1.0], np.float32)
_PREWITT3_HX = np.array([1.0, 0.0, -1.0], np.float32)
_PREWITT3_HZ = np.array([1.0, 1.0, 1.0], np.float32)
_PREWITT3_VX = np.array([1.0, 1.0, 1.0], np.float32)
_PREWITT3_VZ = np.array([-1.0, 0.0, 1.0], np.float32)

#: KernelFilterType enum parity (KernelJob.cs:79-94).
KERNEL_FILTER_TYPES = (
    "Gauss9_S1", "Gauss7_S1", "Gauss5_S1", "Gauss3_S1",
    "Gauss9_S2", "Gauss7_S2", "Gauss5_S2", "Gauss3_S2",
    "Smooth3",
    "Sobel3Horizontal", "Sobel3Vertical", "Sobel3_2D",
    "Prewitt3Horizontal", "Prewitt3Vertical",
)

_SERIES_TABLE = {
    "Gauss9_S1": (gaussian_taps(1.0, 9), gaussian_taps(1.0, 9), 1.0),
    "Gauss7_S1": (gaussian_taps(1.0, 7), gaussian_taps(1.0, 7), 1.0),
    "Gauss5_S1": (gaussian_taps(1.0, 5), gaussian_taps(1.0, 5), 1.0),
    "Gauss3_S1": (gaussian_taps(1.0, 3), gaussian_taps(1.0, 3), 1.0),
    "Gauss9_S2": (gaussian_taps(2.0, 9), gaussian_taps(2.0, 9), 1.0),
    "Gauss7_S2": (gaussian_taps(2.0, 7), gaussian_taps(2.0, 7), 1.0),
    "Gauss5_S2": (gaussian_taps(2.0, 5), gaussian_taps(2.0, 5), 1.0),
    "Gauss3_S2": (gaussian_taps(2.0, 3), gaussian_taps(2.0, 3), 1.0),
    "Smooth3": (_SMOOTH3, _SMOOTH3, _SMOOTH3_FACTOR),
    "Sobel3Horizontal": (_SOBEL3_HX, _SOBEL3_HZ, 1.0),
    "Sobel3Vertical": (_SOBEL3_VX, _SOBEL3_VZ, 1.0),
    "Prewitt3Horizontal": (_PREWITT3_HX, _PREWITT3_HZ, 1.0),
    "Prewitt3Vertical": (_PREWITT3_VX, _PREWITT3_VZ, 1.0),
}


def _chain(a, taps_x, taps_z, factor, iterations):
    """``iterations`` × ``separable_series`` on K1 (the plain passes for a
    CPU tensor)."""
    return _stencil.separable_chain(a, taps_x, iterations, taps_z=taps_z, factor=factor)


def sobel2d(a):
    """Sobel3_2D: H and V separable series on the same input, combined by
    root-sum-squares (ScheduleReduce, KernelJob.cs:187-215); on the card
    one K1@rss launch, on the CPU the two series and
    ``filters.root_sum_squares_tiles``."""
    return _stencil.root_sum_squares_chain(a, (_SOBEL3_HX, _SOBEL3_HZ),
                                           (_SOBEL3_VX, _SOBEL3_VZ))


def kernel_filter(a, filter_type: str, iterations: int = 1):
    """KernelFilterStage: apply ``filter_type`` ``iterations`` times
    (KernelFilterStage.cs:32-43).  On the card a series filter is one K1
    call of ``iterations``; Sobel3_2D is one K1@rss launch an
    iteration."""
    if filter_type not in KERNEL_FILTER_TYPES:
        raise ValueError(f"unknown filter {filter_type!r}")
    if filter_type == "Sobel3_2D":
        for _ in range(iterations):
            a = sobel2d(a)
        return a
    tx, tz, factor = _SERIES_TABLE[filter_type]
    return _chain(a, tx, tz, factor, iterations)


# K1's wrappers import this module's passes and taps, so they come last.
from .cuda import stencil as _stencil  # noqa: E402
