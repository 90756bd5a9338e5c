"""Separable stencil passes — the subset of ``noize_tpu.ops.kernels`` the
blur needs.

Borders replicate the edge sample (the reference's clamped ``getIdx``), and
the Z pass applies the taps *flipped* relative to the X pass
(KernelOperators.cs:58-65; kernels.py:51-62).  Each output cell sums tap 0
first, in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch


def _clamped_range(n: int, off: int, device):
    return torch.arange(-off, n + off, device=device).clamp_(0, n - 1)


def conv_x(a, taps, factor=1.0):
    """1-D correlation along x (columns): out[z,x] = Σ_d a[z, x+d]·taps[off+d]."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    w = a.shape[1]
    ap = a[:, _clamped_range(w, off, a.device)]
    out = torch.zeros_like(a)
    for i in range(k):
        out = out + float(taps[i]) * ap[:, i:i + w]
    return out * factor


def conv_z(a, taps, factor=1.0):
    """1-D pass along z (rows) with the reference's flipped indexing:
    out[z,x] = Σ_d a[z+d, x]·taps[off-d]."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    h = a.shape[0]
    ap = a[_clamped_range(h, off, a.device), :]
    out = torch.zeros_like(a)
    for i in range(k):
        # tap i multiplies the sample at offset d = off - i
        out = out + float(taps[i]) * ap[2 * off - i:2 * off - i + h, :]
    return out * factor


def separable_series(a, taps_x, taps_z, factor=1.0):
    """X pass then Z pass (SeparableKernelFilter.ScheduleSeries)."""
    return conv_z(conv_x(a, taps_x, factor), taps_z, factor)


def gaussian_taps(sigma: float, width: int) -> np.ndarray:
    """Normalized Gaussian taps exp(-k²/2σ²)/Σ, float32
    (``noize_tpu.ops.kernels.gaussian_taps``)."""
    off = (width - 1) // 2
    k = np.arange(-off, off + 1, dtype=np.float64)
    t = np.exp(-(k * k) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)
