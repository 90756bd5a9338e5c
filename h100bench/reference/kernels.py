"""Frozen copy, for the benchmark's reference, of the plain separable chain:
``noize_tpu_torch.ops.kernels``' X / Z passes and Gaussian taps,
``noize_tpu_torch.ops.blur``'s width and sigma rules and
``noize_tpu_torch.ops.cuda.stencil.separable_chain_plain`` (K1's plain
version).

Borders replicate the edge sample; the Z pass applies the taps flipped
relative to the X pass; each output cell sums tap 0 first.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WIDTH = 25
GAUSS_SIGMAS = tuple(0.5 * (i + 1) for i in range(16))
GAUSS_SIGMA_NAMES = tuple(
    f"s{int(s)}d{int(round((s % 1) * 100)):02d}" for s in GAUSS_SIGMAS
)


def _clamped_range(n: int, off: int, device):
    return torch.arange(-off, n + off, device=device).clamp_(0, n - 1)


def conv_x(a, taps, factor=1.0):
    """out[z,x] = Σ_d a[z, x+d]·taps[off+d] on the last two axes."""
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
    """out[z,x] = Σ_d a[z+d, x]·taps[off-d] on the last two axes."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    h = a.shape[-2]
    ap = a[..., _clamped_range(h, off, a.device), :]
    out = torch.zeros_like(a)
    for i in range(k):
        out = out + float(taps[i]) * ap[..., 2 * off - i:2 * off - i + h, :]
    return out * factor


def separable_series(a, taps_x, taps_z, factor=1.0):
    return conv_z(conv_x(a, taps_x, factor), taps_z, factor)


def gaussian_taps(sigma: float, width: int) -> np.ndarray:
    """Normalized Gaussian taps exp(-k²/2σ²)/Σ, float32."""
    off = (width - 1) // 2
    k = np.arange(-off, off + 1, dtype=np.float64)
    t = np.exp(-(k * k) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


def limit_width(width: int) -> int:
    """Even widths round up, clamped to [3, 25]."""
    if width % 2 == 0:
        width += 1
    return max(3, min(width, MAX_WIDTH))


def sigma_value(sigma) -> float:
    """0.5..8.0 float, enum index, or name like 's2d50'."""
    if isinstance(sigma, str):
        return GAUSS_SIGMAS[GAUSS_SIGMA_NAMES.index(sigma)]
    if isinstance(sigma, int) and sigma < len(GAUSS_SIGMAS):
        return GAUSS_SIGMAS[sigma]
    return float(sigma)


def gauss_chain(x, width: int, sigma, iterations: int):
    """The iterated Gaussian blur of a map or a stack of maps."""
    taps = gaussian_taps(sigma_value(sigma), limit_width(width))
    for _ in range(iterations):
        x = separable_series(x, taps, taps, 1.0)
    return x
