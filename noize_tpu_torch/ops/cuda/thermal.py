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
    if iterations < 0:
        raise ValueError(f"thermal_erosion_fused: iterations must be ≥ 0, got {iterations}")
    plan = thermal_plan(int(iterations))
    res = data.shape[0]
    out = torch.empty_like(data)
    tmp = torch.empty_like(data) if len(plan.launches) > 1 else None
    per_launch = np.asarray(plan.launches, np.int32)
    max_diff = _max_diff(float(talus), float(height_width_ratio), res)
    with torch.cuda.device(data.device):
        _cuda.call("noize_thermal_erosion", data.data_ptr(), out.data_ptr(),
                   None if tmp is None else tmp.data_ptr(), res, per_launch.ctypes.data,
                   len(per_launch), plan.tile[0], plan.tile[1], plan.threads, max_diff,
                   float(increment_ratio), _cuda.stream(data))
    thermal_erosion_fused.launches += 1
    return out


thermal_erosion_fused.launches = 0
