"""K6 — the exact PileSolver in CUDA (``csrc/piles.cu``).

``EXACT_PILES`` deposits each pile by the reference's serial Manhattan-ring
solver (``noize_tpu.erosion.sediment._solve_pile`` / ``_handle_pile`` /
``exact_pile_deposit``), which has no Pallas kernel: the reference runs it
as one XLA program.  As torch operations it is launch-bound beyond use
(some 25,000 launches and a host sync a sweep at radius 15), so the card
runs every pile of a call in one launch: a warp a pile ranks each round's
visits with ballots, and piles whose slots cannot share a cell run at
once; the plain version is ``sediment.exact_pile_deposit_plain``.

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
    """The slot tables on ``device``: off_r, off_c, later (the next slot on
    the same cell, -1 for the last) and ends; then the visits of one sweep
    and the slots' reach (the largest |off_r| + |off_c|)."""
    t = _sediment._pile_tables(radius)
    later, seen = np.full(t["off_r"].size, -1, np.int32), {}
    for k in range(later.size - 1, -1, -1):
        cell = (int(t["off_r"][k]), int(t["off_c"][k]))
        later[k] = seen.get(cell, -1)
        seen[cell] = k
    on_device = tuple(torch.from_numpy(a).to(device)
                      for a in (t["off_r"], t["off_c"], later, t["ends"]))
    reach = int((np.abs(t["off_r"]) + np.abs(t["off_c"])).max())
    return on_device + (int(t["ends"].sum()), reach)


@functools.lru_cache(maxsize=16)
def _deposits(increment: float, visits: int, device: torch.device):
    """f32[visits + 1]: n whole increments placed, deps[n] = deps[n - 1] +
    increment rounded to float32 add by add, as a sweep's deposits sum."""
    inc = np.float32(increment)
    deps = np.zeros(visits + 1, np.float32)
    for n in range(visits):
        deps[n + 1] = deps[n] + inc
    return torch.from_numpy(deps).to(device)


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
    off_r, off_c, later, ends, visits, reach = _tables(int(radius), height.device)
    inc = float(np.float32(increment))
    deps = _deposits(inc, visits, height.device)
    out = height.clone()
    done = torch.empty(vols.numel(), dtype=torch.int32, device=height.device)
    rows, cols = height.shape
    with torch.cuda.device(height.device):
        _cuda.call("noize_exact_piles", out.data_ptr(), vols.data_ptr(), idxs.data_ptr(),
                   int(vols.numel()), rows, cols, off_r.data_ptr(), off_c.data_ptr(),
                   later.data_ptr(), ends.data_ptr(), int(radius), int(off_r.numel()),
                   deps.data_ptr(), visits, inc, reach, done.data_ptr(),
                   _cuda.stream(height))
    exact_piles.launches += 1
    return out


exact_piles.launches = 0


def solve_pile_table(vals0, valid, vols, cid, increment: float, radius: int):
    """The sharded ``EXACT_PILES`` solve on a pile table every rank holds
    (K piles × S slots: ``vals0`` f32 gathered slot values, ``valid`` bool,
    ``vols`` f32[K], ``cid`` int64 clamped cells; see
    ``sediment.solve_pile_table_plain``, its plain version).  Returns
    (com_vals f32[K, S], com_eff bool[K, S]).  A CPU tensor takes the
    plain version; a CUDA tensor launches K6's table entry (one launch) or
    raises."""
    if vals0.device.type == "cpu":
        return _sediment.solve_pile_table_plain(vals0, valid, vols, cid, increment, radius)
    name = "solve_pile_table"
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius must be in [1, {MAX_RADIUS}], got {radius}")
    if not np.float32(increment) > 0.0:
        raise ValueError(f"{name}: increment must be > 0, got {increment}")
    off_r, _, _, ends, visits, _ = _tables(int(radius), vals0.device)
    inc = float(np.float32(increment))
    deps = _deposits(inc, visits, vals0.device)
    k, s = vals0.shape
    if s != off_r.numel() or valid.shape != vals0.shape or cid.shape != vals0.shape \
            or vols.shape != (k,):
        raise ValueError(f"{name}: expected [K, {off_r.numel()}] tables and K volumes, got "
                         f"{tuple(vals0.shape)}, {tuple(valid.shape)}, {tuple(cid.shape)}, "
                         f"{tuple(vols.shape)}")
    dev = vals0.device
    work = vals0.to(torch.float32).contiguous().clone()
    valid_u8 = valid.to(torch.uint8).contiguous()
    vols = vols.to(torch.float32).contiguous()
    cid = cid.to(torch.int64).contiguous()
    com_vals = torch.empty_like(work)
    com_eff = torch.empty((k, s), dtype=torch.bool, device=dev)
    cap = 1 << max(6, (2 * s - 1).bit_length())
    keys = torch.full((cap,), -1, dtype=torch.int64, device=dev)  # all bits set: empty
    last = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("noize_pile_table", valid_u8.data_ptr(), vols.data_ptr(), cid.data_ptr(),
                   work.data_ptr(), com_vals.data_ptr(), com_eff.data_ptr(), keys.data_ptr(),
                   last.data_ptr(), cap, k, ends.data_ptr(), int(radius), s, deps.data_ptr(),
                   visits, inc, _cuda.stream(vals0))
    solve_pile_table.launches += 1
    return com_vals, com_eff


solve_pile_table.launches = 0
