"""Sediment write-back: kernel dispersal + pile deposition; port of
``noize_tpu.erosion.sediment``.

A clamped-scatter stamp is a full correlation whose out-of-range margins
fold onto the edge rows/columns; it is separable because the reference
clamps each axis on its own.  The [0,1] "bad build breaker" applies per
destination cell on the summed delta.  Piles (cells banking more than
PILE_THRESHOLD metres) are deposited as a separable tent of radius
PILING_RADIUS.  The reference's opt-in serial pile solver (``EXACT_PILES``)
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# ErodeHeightMaps kernel5 (MultiThreadErosionJob.cs:449-455)
KERNEL5 = np.array(
    [0.12007838424321349, 0.23388075658535032, 0.29208171834287244,
     0.23388075658535032, 0.12007838424321349],
    np.float32,
)


def _disperse_axis(s, taps, axis: int):
    """Clamped-scatter 1-D dispersal: every source cell stamps taps at
    clamp(c+d); out-of-range taps accumulate on the edge cell."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    n = s.shape[axis]
    s = torch.movedim(s, axis, -1)
    zpad = torch.nn.functional.pad(s, (off, off))
    out = None
    for i in range(k):
        piece = zpad[..., i:i + n] * float(taps[k - 1 - i])
        out = piece if out is None else out + piece
    if off > 0:
        # fold: source col j (< off) sends Σ_{i<off-j} taps[i] to col 0
        t_lo = np.cumsum(taps)
        for j in range(off):
            w_lo = float(t_lo[off - j - 1])
            out[..., 0] = out[..., 0] + s[..., j] * w_lo
            out[..., n - 1] = out[..., n - 1] + s[..., n - 1 - j] * w_lo
    return torch.movedim(out, -1, axis)


def kernel_disperse(sed, taps=KERNEL5):
    """2-D separable clamped-scatter stamp (KernelDisperse)."""
    return _disperse_axis(_disperse_axis(sed, taps, 0), taps, 1)


def _triangle_taps(radius: int) -> np.ndarray:
    """Normalised 1-D triangle taps (radius − |d|)₊ with an emphasised
    peak — the separable factor of the pile profile."""
    d = np.arange(-radius, radius + 1)
    w = np.maximum(radius - np.abs(d), 0.0).astype(np.float64)
    w[radius] = radius
    return (w / w.sum()).astype(np.float32)


def pile_deposit(pile_map, radius: int):
    """Deposit each cell's pile volume as a separable tent (triangle ⊗
    triangle) of radius ``radius``, folding at the borders so mass is
    conserved."""
    taps = _triangle_taps(radius)
    return _disperse_axis(_disperse_axis(pile_map, taps, 0), taps, 1)


def write_sediment_map(height, sed_acc, params, height_scale, *, syncs: list = None):
    """ErodeHeightMaps + WriteSedimentMap: deltas up to
    PILE_THRESHOLD/HEIGHT disperse through KERNEL5, larger ones pile; then
    the [0,1] breaker.  The pile pass runs only when a pile exists (one
    host sync, counted in ``syncs`` when given)."""
    if params.EXACT_PILES:
        raise NotImplementedError(
            "EXACT_PILES (the serial PileSolver) is not ported to "
            "noize_tpu_torch yet")
    thresh = params.PILE_THRESHOLD / height_scale
    disperse_part = torch.where(sed_acc <= thresh, sed_acc, 0.0)
    pile_part = torch.where(sed_acc > thresh, sed_acc, 0.0)
    delta = kernel_disperse(disperse_part, KERNEL5)
    if syncs is not None:
        syncs.append("sediment.piles")
    if bool((pile_part > 0.0).any()):
        delta = delta + pile_deposit(pile_part, params.PILING_RADIUS)
    new_height = height + delta
    ok = (new_height >= 0.0) & (new_height <= 1.0)
    return torch.where(ok, new_height, height)
