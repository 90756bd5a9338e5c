"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.ops.thermal``.

Thermal (talus-angle) erosion — 4-phase checkerboard slope limiter;
port of ``noize_tpu.ops.thermal``.

This is the plain PyTorch version of kernel K3
(``ops.cuda.thermal.thermal_erosion_fused``), in the reference's
mask/role phase formulation (``thermal_phase_masked``): each covered cell
finds its corner role in its 2x2 block, rebuilds the block's four values
from shifts, runs the sequential 6-pair rectify chain (order xy, xz, xw,
yz, yw, zw) and keeps its own corner.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import f32 as _f32
from .flow import shift_clamped

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))  # a,b,c,d indices

# phase → (x0, z0), from the Execute() decode (ThermalErosionFilter.cs:97-109)
_PHASE_OFFSETS = ((1, 2), (2, 2), (1, 1), (2, 1))


def _rectify_pair(v1, v2, max_diff, increment):
    """Move increment·excess from the higher cell to the lower when
    |v1−v2| exceeds max_diff."""
    diff = torch.abs(v1 - v2)
    excess = torch.clamp_min(diff - max_diff, 0.0) * increment
    delta = torch.where(v1 > v2, -excess, excess)
    return v1 + delta, v2 - delta


def thermal_phase_masked(d, x0: int, z0: int, origin_row: int, origin_col: int,
                         res_global: int, max_diff, increment):
    """One checkerboard phase, per cell (``thermal_phase_masked``);
    ``origin_row``/``origin_col`` are the global coordinates of d[0, 0]."""
    h, w = d.shape
    gz = torch.arange(h, device=d.device)[:, None] + origin_row
    gx = torch.arange(w, device=d.device)[None, :] + origin_col
    rx = (gx - x0) % 2
    rz = (gz - z0) % 2
    ax = gx - rx
    az = gz - rz
    zmax = res_global - 2 if z0 == 2 else res_global - 3
    valid = (ax >= x0) & (ax < res_global - 1) & (az >= z0) & (az <= zmax)

    shifted = {
        (dz, dx): shift_clamped(d, dz, dx)
        for dz in (-1, 0, 1) for dx in (-1, 0, 1)
    }
    rx0 = rx == 0
    rz0 = rz == 0

    def corner(cx, cz):
        return torch.where(
            rz0,
            torch.where(rx0, shifted[(cz, cx)], shifted[(cz, cx - 1)]),
            torch.where(rx0, shifted[(cz - 1, cx)], shifted[(cz - 1, cx - 1)]),
        )

    # float4 order: x=(0,0), y=(1,0), z=(0,1), w=(1,1)
    vals = [corner(cx, cz) for cx, cz in ((0, 0), (1, 0), (0, 1), (1, 1))]
    for i, j in _PAIRS:
        vals[i], vals[j] = _rectify_pair(vals[i], vals[j], max_diff, increment)
    own = torch.where(
        rz0,
        torch.where(rx0, vals[0], vals[1]),
        torch.where(rx0, vals[2], vals[3]),
    )
    return torch.where(valid, own, d)


def max_diff_value(talus, height_width_ratio, res: int) -> float:
    """maxDiff = tan((talus/90)·π/2)·heightRatio / res, as the TPU kernel
    computes it (thermal_pl.py:113-122): the angle in double, its tangent
    in float32 as the reference's XLA runtime evaluates it (``f32.tan``,
    the value ``ensure_compile_time_eval`` and eager JAX give), the rest
    in float32.  XLA's constant folder rounds the tangent otherwise, so
    a compiled program with a constant angle differs by an ulp at talus
    21, 56 and 90 (ROADMAP.md §3)."""
    return _max_diff(float(talus), float(height_width_ratio), int(res))


@functools.lru_cache(maxsize=256)
def _max_diff(talus: float, height_width_ratio: float, res: int) -> float:
    # a few hundred µs of NumPy scalar steps: once a setting, not once a call
    talus_rad = (talus / 90.0) * 3.14159 / 2.0
    t = _f32.tan(np.float32(talus_rad))
    return float((t * np.float32(height_width_ratio)) / np.float32(res))


def thermal_erosion_window(data, talus, increment_ratio, height_width_ratio,
                           iterations: int, origin, res: int):
    """``thermal_erosion`` of a ``res``² grid on the window ``data`` whose
    cell (0, 0) is the grid's ``origin`` = (row, col): the phases' parity,
    coverage and ``max_diff`` are the grid's (the plain version of
    ``ops.cuda.thermal.thermal_erosion_window``)."""
    max_diff = max_diff_value(talus, height_width_ratio, res)
    for _ in range(iterations):
        for x0, z0 in _PHASE_OFFSETS:
            data = thermal_phase_masked(data, x0, z0, int(origin[0]), int(origin[1]), res,
                                        max_diff, increment_ratio)
    return data


def thermal_erosion(data, talus, increment_ratio, height_width_ratio,
                    iterations: int = 1):
    """ThermalErosionFilter.Schedule: ``talus`` in degrees,
    ``increment_ratio`` = THERMAL_STEP, ``height_width_ratio`` =
    TILE_SIZE / HEIGHT."""
    return thermal_erosion_window(data, talus, increment_ratio, height_width_ratio,
                                  iterations, (0, 0), data.shape[0])
