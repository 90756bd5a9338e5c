"""K3 — thermal erosion in CUDA (``csrc/thermal.cu``).

Port of ``noize_tpu.ops.pallas.thermal_pl._fused_thermal_call`` (entry
``thermal_erosion_fused``): 4·``iterations`` checkerboard talus phases.
The plain version is ``ops.thermal.thermal_erosion``.

K3 keeps the phases on chip: :func:`thermal_plan` splits the iterations
into launches, each of which runs all the phases of its iterations on a
tile and its halo in shared memory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ... import _cuda
from .. import thermal as _thermal

#: K3's blocking (``scripts/thermal_sweep.py`` chose it; PERF.md): output
#: tiles of TILE rows × columns (even sides), THREADS threads a block, and
#: up to PER_LAUNCH iterations a launch.
TILE = (128, 128)
THREADS = 512
PER_LAUNCH = 4


@dataclass(frozen=True)
class ThermalPlan:
    """How K3 runs a call: ``launches[i]`` iterations in launch ``i``, on
    ``tile`` output tiles whose windows carry ``halos[i]`` = (rows,
    columns) of halo a side."""

    launches: tuple
    halos: tuple
    tile: tuple
    threads: int


def thermal_plan(iterations: int, per_launch: int = PER_LAUNCH, tile=TILE,
                 threads: int = THREADS) -> ThermalPlan:
    """Split ``iterations`` into as few launches of at most ``per_launch``
    as go, as evenly as they go; 0 iterations is no launch (a copy).  A
    launch of m iterations needs 4m − 1 columns and 2m rows of halo around
    tiles of even origin: a phase's 2×2 blocks alternate their column
    parity every phase and their row parity every second phase, and each
    change moves the edge of what is still exact by one cell."""
    tile = tuple(tile)
    if len(tile) != 2 or min(tile) < 2 or tile[0] % 2 or tile[1] % 2:
        raise ValueError(f"thermal_plan: tile sides must be even and ≥ 2, got {tile}")
    if iterations == 0:
        return ThermalPlan((), (), tile, threads)
    n = -(-iterations // per_launch)
    base, extra = divmod(iterations, n)
    launches = tuple(base + (i < extra) for i in range(n))
    return ThermalPlan(launches, tuple((2 * m, 4 * m - 1) for m in launches), tile, threads)


@functools.lru_cache(maxsize=64)
def _max_diff(talus: float, height_width_ratio: float, res: int) -> float:
    return _thermal.max_diff_value(talus, height_width_ratio, res)


def _launch(data, iterations: int, max_diff: float, increment, origin, res: int):
    """K3 on ``data``, a window of a ``res``² grid whose cell (0, 0) is the
    grid's ``origin``; counted in ``thermal_erosion_fused.launches``."""
    if iterations < 0:
        raise ValueError(f"thermal_erosion: iterations must be ≥ 0, got {iterations}")
    plan = thermal_plan(int(iterations))
    rows, cols = data.shape
    out = torch.empty_like(data)
    tmp = torch.empty_like(data) if len(plan.launches) > 1 else None
    per_launch = np.asarray(plan.launches, np.int32)
    with torch.cuda.device(data.device):
        _cuda.call("noize_thermal_erosion", data.data_ptr(), out.data_ptr(),
                   None if tmp is None else tmp.data_ptr(), rows, cols, int(origin[0]),
                   int(origin[1]), int(res), per_launch.ctypes.data, len(per_launch),
                   plan.tile[0], plan.tile[1], plan.threads, max_diff,
                   float(increment), _cuda.stream(data))
    thermal_erosion_fused.launches += 1
    return out


def thermal_erosion_fused(data, talus, increment_ratio, height_width_ratio,
                          iterations: int = 1, block: int = None,
                          unroll: bool = True):
    """``thermal_erosion`` on K3.  A CPU tensor takes the plain version; a
    CUDA tensor launches K3 or raises.  ``block`` and ``unroll`` choose the
    TPU kernel's layout, not its result, and are ignored.  ``max_diff`` is
    computed on the host (float32 tan) once per (talus, ratio, res)."""
    if data.device.type == "cpu":
        return _thermal.thermal_erosion(data, talus, increment_ratio,
                                        height_width_ratio, iterations)
    _cuda.check_map(data, "thermal_erosion_fused")
    res = data.shape[0]
    return _launch(data, iterations, _max_diff(float(talus), float(height_width_ratio), res),
                   increment_ratio, (0, 0), res)


thermal_erosion_fused.launches = 0


def thermal_erosion_window(data, talus, increment_ratio, height_width_ratio,
                           iterations: int, origin, res: int):
    """``thermal_erosion`` of a ``res``² grid on a window of it: ``data``
    (rows × cols) holds the grid's cells from ``origin`` = (row, col) on.
    Parity, coverage, border and ``max_diff`` are the grid's.  Cells within
    2 a phase of a window edge that is not the grid's edge are not exact
    (the sharded thermal erosion extends its blocks by that much and crops
    it).  A CPU tensor takes the plain version; a CUDA tensor launches K3
    (counted in ``thermal_erosion_fused.launches``) or raises."""
    if data.device.type == "cpu":
        return _thermal.thermal_erosion_window(data, talus, increment_ratio,
                                               height_width_ratio, iterations, origin, res)
    _cuda.check_map(data, "thermal_erosion_window", square=False)
    if origin[0] < 0 or origin[1] < 0 or origin[0] + data.shape[0] > res \
            or origin[1] + data.shape[1] > res:
        raise ValueError(f"thermal_erosion_window: a {tuple(data.shape)} window at {origin} "
                         f"leaves the {res}² grid")
    return _launch(data, iterations, _max_diff(float(talus), float(height_width_ratio), res),
                   increment_ratio, origin, res)
