"""K4 — pool automata in CUDA (``csrc/pool.cu``).

One entry point stands in for both TPU kernels that compute
``pool.pool_automata``'s (pool, drains) on an even grid:
``noize_tpu.erosion.pool_pallas._mega_call`` (entry
``pool_automata_pallas_mega``) and ``_fused_pair_call`` (entry
``pool_automata_pallas_pair_fused``).  The plain version is
``erosion.pool.pool_automata``.

The wetness gate never syncs the host: the kernel raises a device flag
when any cell holds ``>= MIN_WATER`` and every phase launch returns at
once when it is down.  ``pool_automata_cuda.wet_calls`` adds up those
flags on the device (an int32 tensor; ``None`` until the first call on
the card — set it back to ``None`` to reset), so a caller can count the
calls that ran phases without stalling the main path; reading it syncs.
"""

from __future__ import annotations

import torch

from .. import _cuda
from . import pool as _pool


def pool_automata_cuda(height, pool, iterations: int = 10,
                       drain_particles: bool = True):
    """``pool_automata`` on K4.  A CPU tensor takes the plain version; a
    CUDA tensor launches K4 or raises (it needs an even, square grid)."""
    if height.device.type == "cpu":
        return _pool.pool_automata(height, pool, iterations, drain_particles)
    _cuda.check_map(height, "pool_automata_cuda", even=True)
    _cuda.check_map(pool, "pool_automata_cuda", even=True)
    if pool.shape != height.shape or pool.device != height.device:
        raise ValueError("pool_automata_cuda: height and pool must match in "
                         "shape and device")
    res = height.shape[0]
    out = torch.empty_like(pool)
    drains = torch.empty_like(pool)
    flag = torch.empty((1,), dtype=torch.int32, device=pool.device)
    scratch = torch.empty(9 * (res // 2) ** 2, dtype=torch.float32,
                          device=pool.device)
    with torch.cuda.device(pool.device):
        _cuda.call("noize_pool_automata", height.data_ptr(), pool.data_ptr(),
                   out.data_ptr(), drains.data_ptr(), flag.data_ptr(),
                   scratch.data_ptr(), res, int(iterations),
                   int(bool(drain_particles)), _cuda.stream(pool))
    pool_automata_cuda.launches += 1
    wet = pool_automata_cuda.wet_calls
    if wet is None or wet.device != flag.device:
        pool_automata_cuda.wet_calls = flag.clone()
    else:
        wet.add_(flag)
    return out, drains


pool_automata_cuda.launches = 0
pool_automata_cuda.wet_calls = None
