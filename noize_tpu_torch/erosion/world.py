"""Erosion world state and per-cell helpers — port of
``noize_tpu.erosion.world``.

The world is five float32 ``[R, R]`` maps: height, pool (standing water),
flow (stream intensity), track (per-cycle water traffic) and plants, in
one ``[row, col]`` layout; particle positions are (row, col).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MINFLOWPOOL = 5e-5  # WorldTile.MINFLOWPOOL (LiveErosionDataTypes.cs:440)

# 8-neighbourhood in the reference's nb-array order (WTORDER):
# up, right, down, left, ne, se, sw, nw, as (d_row, d_col).
NEIGHBOR_OFFSETS = (
    (1, 0),    # up
    (0, 1),    # right
    (-1, 0),   # down
    (0, -1),   # left
    (1, 1),    # ne
    (-1, 1),   # se
    (-1, -1),  # sw
    (1, -1),   # nw
)


@dataclass
class WorldState:
    """The five live maps (LiveErosionDataTypes.cs:446-464)."""

    height: torch.Tensor
    pool: torch.Tensor
    flow: torch.Tensor
    track: torch.Tensor
    plants: torch.Tensor

    @classmethod
    def create(cls, height):
        z = torch.zeros_like(height)
        return cls(height=height, pool=z, flow=z, track=z, plants=z)


def wih(state: WorldState, height_scale):
    """Water-inclusive height: HEIGHT · (height + pool)."""
    return height_scale * (state.height + state.pool)


def all_heights(state: WorldState, height_scale, max_flow_height=25.0):
    """WIH plus the flow map's virtual obstacle contribution."""
    return wih(state, height_scale) + max_flow_height * state.flow


def update_flow_from_track(state: WorldState, params, height_scale) -> WorldState:
    """UpdateFlowMapFromTrack: track decays into flow (saturating
    50t/(1+50t)), pools suppress accumulation, pools evaporate at a fixed
    surface rate; track resets every cycle."""
    flr = params.FLOW_LOSS_RATE
    ser = params.SURFACE_EVAPORATION_RATE
    pv = state.flow
    tv = state.track
    poolv = state.pool
    has_pool = poolv > MINFLOWPOOL
    has_track = tv > 0.0
    flow_pool = (1.0 - 0.1 * flr) * pv
    flow_track = (1.0 - flr) * pv + (flr * 50.0 * tv) / (1.0 + 50.0 * tv)
    flow_plain = (1.0 - flr) * pv
    new_flow = torch.where(has_pool, flow_pool,
                           torch.where(has_track, flow_track, flow_plain))
    new_pool = torch.clamp_min(poolv - (ser / height_scale), 0.0)
    return WorldState(
        height=state.height,
        pool=new_pool,
        flow=new_flow,
        track=torch.zeros_like(tv),
        plants=state.plants,
    )
