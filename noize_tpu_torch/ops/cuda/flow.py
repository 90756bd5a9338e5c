"""K2 — the whole flow map in CUDA (``csrc/flow.cu``).

Port of ``noize_tpu.ops.pallas.flow_pl._fused_flow_call`` (entry
``flow_map_fused``): WATER_INIT fill, ``iterations`` × (flow step, water
step), velocity and the static normalise with its ``rng < 1e-12`` guard.
The plain version is ``ops.flow.flow_map``.

K2 keeps the state on chip for several iterations: :func:`flow_plan` splits
the iterations into launches, each of which runs its iterations on a tile
and its halo in shared memory and registers.  Maps need not be square (the
sharded flow map runs on extended shard blocks).  A stack of maps ``[T, R, C]``
(``parallel.tiled``'s tiles) runs in the same launches as one map, each
map clamped at its own edges.

The TPU's per-iteration kernel ``flow_pl._iteration_call`` (entry
``flow_map_pallas``) computes the same map one launch per iteration; here
``flow_map_pallas`` is K2 under that name (``block`` is a TPU layout
choice and is ignored).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import _cuda
from .. import flow as _flow

#: K2's blocking (``scripts/stencil_flow_sweep.py`` chose it; PERF.md): a
#: block's window is REGION² cells (csrc/flow.cu's ``kRegion``), and a launch
#: runs up to PER_LAUNCH iterations.
REGION = 96
PER_LAUNCH = 4


@dataclass(frozen=True)
class FlowPlan:
    """How K2 runs a flow map: ``launches[i]`` iterations in launch ``i``,
    whose windows carry ``halos[i]`` cells a side around ``tiles[i]``²
    output tiles."""

    launches: tuple
    halos: tuple
    tiles: tuple


def flow_plan(iterations: int, per_launch: int = PER_LAUNCH,
              region: int = REGION) -> FlowPlan:
    """Split ``iterations`` into as few launches of at most ``per_launch``
    as go, as evenly as they go.  A sub-step reads the 4 neighbours, and
    the velocity does not read the last water step's water, so a launch of
    m iterations needs a halo of 2m cells.  0 iterations is one launch of
    0."""
    n = max(1, -(-iterations // per_launch))
    base, extra = divmod(iterations, n)
    launches = tuple(base + (i < extra) for i in range(n))
    halos = tuple(2 * m for m in launches)
    tiles = tuple(region - 2 * h for h in halos)
    if min(tiles) < 1:
        raise ValueError(f"flow_plan: {per_launch} iterations a launch leave no tile "
                         f"in a {region}² window")
    return FlowPlan(launches, halos, tiles)


def flow_map_fused(height, iterations: int = 5, norm_min=-0.1, norm_max=0.1,
                   block: int = None):
    """``flow_map`` on K2, of a map ``[R, C]`` or each map of a stack
    ``[T, R, C]``.  A CPU tensor takes the plain version; a CUDA tensor
    launches K2 or raises.  ``block`` (the TPU's row block) does not change
    the result and is ignored."""
    if height.device.type == "cpu":
        return _flow.flow_map(height, iterations, norm_min, norm_max)
    _cuda.check_map(height, "flow_map_fused", square=False, stack=True)
    if iterations < 0:
        raise ValueError(f"flow_map_fused: iterations must be ≥ 0, got {iterations}")
    plan = flow_plan(int(iterations))
    rows, cols = height.shape[-2:]
    batch = height.shape[0] if height.dim() == 3 else 1
    out = torch.empty_like(height)
    n = len(plan.launches)
    # water and four flows of every map carried between launches,
    # ping-ponged from the third launch on
    carry = (torch.empty((min(2, n - 1), 5, batch, rows, cols), dtype=height.dtype,
                         device=height.device) if n > 1 else None)
    per_launch = np.asarray(plan.launches, np.int32)
    lo, rng = _flow.norm_params(norm_min, norm_max)
    with torch.cuda.device(height.device):
        _cuda.call("noize_flow_map", height.data_ptr(), out.data_ptr(),
                   None if carry is None else carry.data_ptr(), rows, cols, batch,
                   per_launch.ctypes.data, n, REGION, float(lo), float(rng),
                   _cuda.stream(height))
    flow_map_fused.launches += 1
    return out


flow_map_fused.launches = 0


def flow_map_pallas(height, iterations: int = 5, norm_min=-0.1, norm_max=0.1,
                    block: int = 512):
    """``flow_pl.flow_map_pallas`` (TPU kernel ``_iteration_call``) on
    K2."""
    out = flow_map_fused(height, iterations, norm_min, norm_max)
    if height.device.type != "cpu":
        flow_map_pallas.launches += 1
    return out


flow_map_pallas.launches = 0
