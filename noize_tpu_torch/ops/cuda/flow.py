"""K2 — the whole flow map in CUDA (``csrc/flow.cu``).

Port of ``noize_tpu.ops.pallas.flow_pl._fused_flow_call`` (entry
``flow_map_fused``): WATER_INIT fill, ``iterations`` × (flow step, water
step), velocity and the static normalise with its ``rng < 1e-12`` guard.
The plain version is ``ops.flow.flow_map``.

The TPU's per-iteration kernel ``flow_pl._iteration_call`` (entry
``flow_map_pallas``) computes the same map one launch per iteration; K2
already runs each iteration as its own pair of launches, so
``flow_map_pallas`` here is K2 under that name (``block`` is a TPU layout
choice and is ignored).
"""

from __future__ import annotations

import torch

from ... import _cuda
from .. import flow as _flow


def flow_map_fused(height, iterations: int = 5, norm_min=-0.1, norm_max=0.1):
    """``flow_map`` on K2.  A CPU tensor takes the plain version; a CUDA
    tensor launches K2 or raises."""
    if height.device.type == "cpu":
        return _flow.flow_map(height, iterations, norm_min, norm_max)
    _cuda.check_map(height, "flow_map_fused")
    res = height.shape[0]
    out = torch.empty_like(height)
    water, fw, fe, fs, fn = (torch.empty_like(height) for _ in range(5))
    lo, rng = _flow.norm_params(norm_min, norm_max)
    with torch.cuda.device(height.device):
        _cuda.call("noize_flow_map", height.data_ptr(), out.data_ptr(),
                   water.data_ptr(), fw.data_ptr(), fe.data_ptr(),
                   fs.data_ptr(), fn.data_ptr(), res, int(iterations),
                   float(lo), float(rng), _cuda.stream(height))
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
