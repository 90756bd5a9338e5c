"""K1 — the iterated separable stencil chain (``csrc/stencil.cu``).

Port of the TPU kernels ``noize_tpu.ops.pallas.stencil.fused_separable_chain``
(2-D halo blocks) and ``fused_separable_chain_rows`` (full-width row
blocks) and of their entry ``gauss_chain``: ``iterations`` × (X pass,
flipped Z pass) of an edge-clamped correlation, i.e.
``kernels.separable_series`` iterated.  The blur stages and the flagship
blur run here.  The two JAX entries have counterparts of the same names;
their blocking arguments choose TPU layouts, not results, and are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _cuda
from .. import kernels as _kernels
from ..blur import limit_width, sigma_value


def separable_chain_plain(x, taps, iterations: int):
    """The plain PyTorch version: ``separable_series`` applied
    ``iterations`` times."""
    taps = np.asarray(taps, np.float32)
    for _ in range(iterations):
        x = _kernels.separable_series(x, taps, taps, 1.0)
    return x


def separable_chain(x, taps, iterations: int):
    """``iterations`` × (X pass, flipped Z pass) with the same odd-length
    ``taps`` on both axes.  A CPU tensor takes the plain version; a CUDA
    tensor launches K1 or raises."""
    taps = np.ascontiguousarray(np.asarray(taps, np.float32))
    if x.device.type == "cpu":
        return separable_chain_plain(x, taps, iterations)
    _cuda.check_map(x, "separable_chain", square=False)
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > 25:
        raise ValueError(f"separable_chain: taps must be 1-D, odd, ≤ 25 long; "
                         f"got shape {taps.shape}")
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    rows, cols = x.shape
    with torch.cuda.device(x.device):
        _cuda.call("noize_separable_chain", x.data_ptr(), out.data_ptr(),
                   tmp.data_ptr(), rows, cols, taps.ctypes.data, len(taps),
                   int(iterations), _cuda.stream(x))
    separable_chain.launches += 1
    return out


separable_chain.launches = 0


def gauss_chain(x, width: int, sigma, iterations: int):
    """StageGaussianBlur's iterated blur on K1 (``stencil.gauss_chain``)."""
    taps = _kernels.gaussian_taps(sigma_value(sigma), limit_width(width))
    return separable_chain(x, taps, iterations)


def _entry(entry, x, taps, iterations):
    out = separable_chain(x, taps, iterations)
    if x.device.type != "cpu":
        entry.launches += 1
    return out


def fused_separable_chain(x, taps, iterations: int, block: int = 256):
    """``stencil.fused_separable_chain`` (2-D blocks on the TPU) on K1."""
    return _entry(fused_separable_chain, x, taps, iterations)


def fused_separable_chain_rows(x, taps, iterations: int, block: int = None,
                               iterations_per_launch: int = 6):
    """``stencil.fused_separable_chain_rows`` (row blocks on the TPU) on
    K1."""
    return _entry(fused_separable_chain_rows, x, taps, iterations)


fused_separable_chain.launches = 0
fused_separable_chain_rows.launches = 0
