"""K3 — thermal erosion in CUDA (``csrc/thermal.cu``).

Port of ``noize_tpu.ops.pallas.thermal_pl._fused_thermal_call`` (entry
``thermal_erosion_fused``): 4·``iterations`` checkerboard talus phases.
The plain version is ``ops.thermal.thermal_erosion``.
"""

from __future__ import annotations

import torch

from ... import _cuda
from .. import thermal as _thermal


def thermal_erosion_fused(data, talus, increment_ratio, height_width_ratio,
                          iterations: int = 1):
    """``thermal_erosion`` on K3.  A CPU tensor takes the plain version; a
    CUDA tensor launches K3 or raises.  ``max_diff`` is computed once on
    the host (float32 tan) and passed to the kernel."""
    if data.device.type == "cpu":
        return _thermal.thermal_erosion(data, talus, increment_ratio,
                                        height_width_ratio, iterations)
    _cuda.check_map(data, "thermal_erosion_fused")
    res = data.shape[0]
    max_diff = _thermal.max_diff_value(talus, height_width_ratio, res)
    out = torch.empty_like(data)
    with torch.cuda.device(data.device):
        _cuda.call("noize_thermal_erosion", data.data_ptr(), out.data_ptr(),
                   res, int(iterations), max_diff, float(increment_ratio),
                   _cuda.stream(data))
    thermal_erosion_fused.launches += 1
    return out


thermal_erosion_fused.launches = 0
