"""K6 — the exact PileSolver in CUDA (``csrc/piles.cu``).

``EXACT_PILES`` deposits each pile by the reference's serial Manhattan-ring
solver (``noize_tpu.erosion.sediment._solve_pile`` / ``_handle_pile`` /
``exact_pile_deposit``), which has no Pallas kernel: the reference runs it
as one XLA program.  As torch operations it is launch-bound beyond use
(some 25,000 launches and a host sync a sweep at radius 15), so the card
runs every pile of a call in one launch of one block; the plain version is
``sediment.exact_pile_deposit_plain``.

The pile selection (``sediment.select_piles``: a stable sort of the map)
stays on the device, and K6 skips piles of zero volume itself, so a call
does not sync the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from . import sediment as _sediment

#: K6 keeps a pile's slots in shared memory, 5 bytes a slot, within the
#: 48 KB a launch gets without opting in: radius 68 at most.
MAX_RADIUS = 68


@functools.lru_cache(maxsize=16)
def _tables(radius: int, device: torch.device):
    t = _sediment._pile_tables(radius)
    return tuple(torch.from_numpy(t[k]).to(device) for k in ("off_r", "off_c", "ends"))


def exact_piles(height, pile_map, increment: float, radius: int, max_piles: int = 64):
    """Deposit the ``max_piles`` largest piles of ``pile_map`` on a copy of
    ``height`` by the exact solver at ``radius`` with float32 step
    ``increment``.  A CPU tensor takes the plain version; a CUDA tensor
    launches K6 (one launch) or raises."""
    if height.device.type == "cpu":
        return _sediment.exact_pile_deposit_plain(height, pile_map, increment, radius,
                                                  max_piles)
    _cuda.check_map(height, "exact_piles", square=False)
    _cuda.check_map(pile_map, "exact_piles", square=False)
    if pile_map.shape != height.shape or pile_map.device != height.device:
        raise ValueError("exact_piles: height and pile_map must match in shape and device")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"exact_piles: radius must be in [1, {MAX_RADIUS}], got {radius}")
    if not np.float32(increment) > 0.0:
        raise ValueError(f"exact_piles: increment must be > 0, got {increment}")
    vols, idxs = _sediment.select_piles(pile_map, max_piles)
    off_r, off_c, ends = _tables(int(radius), height.device)
    out = height.clone()
    rows, cols = height.shape
    with torch.cuda.device(height.device):
        _cuda.call("noize_exact_piles", out.data_ptr(), vols.data_ptr(), idxs.data_ptr(),
                   int(vols.numel()), rows, cols, off_r.data_ptr(), off_c.data_ptr(),
                   ends.data_ptr(), int(radius), int(off_r.numel()),
                   float(np.float32(increment)), _cuda.stream(height))
    exact_piles.launches += 1
    return out


exact_piles.launches = 0
