"""Vegetation layer — plant rooting, survival and growth over the erosion
world; port of ``noize_tpu.erosion.vegetation``.

Survival is evaluated for a whole batch of candidate positions at once,
and a density splat mirrors ChangeVegetationDensity (+1 at the cell, +0.6
on the 4 axes, +0.4 on the diagonals, clamped at the border).  The draws
come from ``noize_tpu_torch.prng`` (``jax.random``'s threefry bits), so a
key reproduces the reference's plant set.  Splats add duplicates in plant
order through the descent's event scatter (``particles.scatter_events``:
pieces of 32767 on the CPU, K9 on the card), as the reference's
scatter-adds do; ``growth`` stays int32 throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..prng import _randint_of_split, randint, split
from .particles import scatter_events
from .world import WorldState, normal_map

_F32 = torch.float32
_I32 = torch.int32


@dataclass(frozen=True)
class PlantType:
    """Vegetation.cs:27-35 — survival thresholds."""

    type_idx: int = 0
    density_modifier: float = 1.0
    max_angle: float = 1.0          # max normal.y (un-normalised 4-cross sum)
    spawn_range: float = 1.0
    max_density: float = 1.0
    max_pool_survival: float = 1e-4
    max_stream_survival: float = 0.5
    max_spawn_attempts: int = 8


class Plants(NamedTuple):
    """SoA plant records (Vegetation.cs:83-90)."""

    type_idx: torch.Tensor  # i32[N]
    growth: torch.Tensor    # i32[N] of 100
    row: torch.Tensor       # i32[N]
    col: torch.Tensor       # i32[N]
    height: torch.Tensor    # f32[N] cached for change detection
    alive: torch.Tensor     # bool[N]


def _env_ok(ptype: PlantType, state: WorldState, height_scale, patch_res):
    """The pool, stream and slope gates of every cell."""
    n = normal_map(state, height_scale, patch_res)
    return ((state.pool <= ptype.max_pool_survival)
            & (state.flow <= ptype.max_stream_survival)
            & (n[..., 1] <= ptype.max_angle))


def can_survive(ptype: PlantType, state: WorldState, height_scale, patch_res):
    """CanSurvive (Vegetation.cs:65-78) for every cell at once: density,
    pool, stream and slope gates."""
    return (state.plants <= ptype.max_density) & _env_ok(ptype, state, height_scale,
                                                         patch_res)


def root_plants(key, ptype: PlantType, state: WorldState, n: int,
                height_scale, patch_res):
    """Root (Vegetation.cs:37-59): ``max_spawn_attempts`` candidate cells
    a plant, the first survivable one kept (attempt 0, dead, if none)."""
    res = state.height.shape[0]
    device = state.height.device
    rows, cols = _randint_of_split(key, (n, ptype.max_spawn_attempts), 0, res)  # (kr, kc)
    ok_map = can_survive(ptype, state, height_scale, patch_res)
    ok = ok_map[rows.long(), cols.long()]               # [n, attempts]
    first = torch.argmax(ok.to(_I32), dim=1, keepdim=True)  # the first True
    row = torch.gather(rows, 1, first)[:, 0]
    col = torch.gather(cols, 1, first)[:, 0]
    return Plants(
        type_idx=torch.full((n,), ptype.type_idx, dtype=_I32, device=device),
        growth=torch.full((n,), 20, dtype=_I32, device=device),
        row=row,
        col=col,
        height=state.height[row.long(), col.long()],
        alive=ok.any(dim=1),
    )


def splat_density(plants_map, plants: Plants, magnitude=1.0):
    """ChangeVegetationDensity (LiveErosionDataTypes.cs:888-936): +1·mag at
    the plant cell, +0.6·mag on the 4-neighbourhood, +0.4·mag on the
    diagonals, with the reference's clamped border indexing.  As the
    reference adds them: the centre stamps into zeros, that stamp onto
    ``plants_map``, then each neighbour's stamps in the reference's offset
    order, every stamp in plant slot order (flat cells ``row·cols + col``
    through ``scatter_events``)."""
    res = plants_map.shape[0]
    cols = plants_map.shape[1]
    mag = torch.as_tensor(magnitude, dtype=_F32, device=plants_map.device)
    m = torch.where(plants.alive, mag, torch.zeros((), dtype=_F32, device=mag.device))
    m = m.expand(plants.alive.shape).contiguous()
    row, col = plants.row.long(), plants.col.long()
    (stamp,) = scatter_events(row * cols + col, [m], plants_map.numel())
    out = (plants_map + stamp.reshape(plants_map.shape)).reshape(-1)
    cells, values = [], []
    for w, offs in (
        (0.6, ((1, 0), (0, 1), (-1, 0), (0, -1))),
        (0.4, ((1, 1), (-1, 1), (1, -1), (-1, -1))),
    ):
        mw = m * w
        for dr, dc in offs:
            r = torch.clamp(row + dr, 0, res - 1)
            c = torch.clamp(col + dc, 0, res - 1)
            cells.append(r * cols + c)
            values.append(mw)
    scatter_events(torch.cat(cells), [torch.cat(values)], out.numel(), [out])
    return out.reshape(plants_map.shape)


def grow(plants: Plants, state: WorldState) -> Plants:
    """Grow is a no-op in the reference (Vegetation.cs:61-63); kills the
    plants whose ground moved (the cached-height hook)."""
    current = state.height[plants.row.long(), plants.col.long()]
    still = plants.alive & (torch.abs(current - plants.height) < 1e-3)
    return plants._replace(alive=still)


def _i32(v, device):
    return torch.tensor(v, dtype=_I32, device=device)


def grow_cycle(key, plants: Plants, state: WorldState, ptype: PlantType,
               height_scale, patch_res, *,
               moisture_gain: int = 10, drought_loss: int = 4,
               erosion_shock: int = 10, mature_at: int = 80) -> Plants:
    """The reference's growth/decay cycle, over all plant slots: the
    environment cull, moisture (growth ± by water traffic), the erosion
    shock of ground moving under a plant, and dead slots re-rooting as
    seedlings next to a random mature donor within ``spawn_range``.
    Rebuild the density map from the result with ``density_map``."""
    res = state.height.shape[0]
    device = state.height.device
    nslots = plants.row.shape[0]
    env_ok = _env_ok(ptype, state, height_scale, patch_res)
    row, col = plants.row.long(), plants.col.long()

    cur_height = state.height[row, col]
    alive = plants.alive & env_ok[row, col]
    moist = state.track[row, col] > 0.0
    growth = plants.growth + torch.where(moist, _i32(moisture_gain, device),
                                         _i32(-drought_loss, device))
    growth = growth - torch.where(torch.abs(cur_height - plants.height) >= 1e-3,
                                  _i32(erosion_shock, device), _i32(0, device))
    growth = torch.clamp(growth, 0, 100)
    alive = alive & (growth > 0)

    # reproduction into freed slots
    kd, kr, kc = split(key, 3)
    spawn = max(1, int(ptype.spawn_range))
    donor = randint(kd, (nslots,), 0, nslots).long()
    d_mature = alive[donor] & (growth[donor] >= mature_at)
    cand_r = torch.clamp(plants.row[donor] + randint(kr, (nslots,), -spawn, spawn + 1),
                         0, res - 1)
    cand_c = torch.clamp(plants.col[donor] + randint(kc, (nslots,), -spawn, spawn + 1),
                         0, res - 1)
    cr, cc = cand_r.long(), cand_c.long()
    root_ok = d_mature & env_ok[cr, cc] & (state.plants[cr, cc] <= ptype.max_density)
    seeded = ~alive & root_ok
    row = torch.where(seeded, cand_r, plants.row)
    col = torch.where(seeded, cand_c, plants.col)
    growth = torch.where(seeded, _i32(20, device), growth)
    return Plants(
        type_idx=plants.type_idx,
        growth=growth,
        row=row,
        col=col,
        height=state.height[row.long(), col.long()],
        alive=alive | seeded,
    )


def density_map(shape, plants: Plants, ptype: PlantType):
    """The world's plant-density map from the plant set: each plant splats
    ChangeVegetationDensity's stamp scaled by its growth fraction and the
    type's density modifier."""
    device = plants.growth.device
    # a device tensor divisor keeps true division on CUDA as well
    mag = (plants.growth.to(_F32) / torch.tensor(100.0, device=device)) \
        * ptype.density_modifier
    return splat_density(torch.zeros(tuple(shape), dtype=_F32, device=device), plants,
                         magnitude=mag)
