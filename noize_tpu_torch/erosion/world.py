"""Erosion world state and per-cell helpers — port of
``noize_tpu.erosion.world``.

The world is five float32 ``[R, R]`` maps: height, pool (standing water),
flow (stream intensity), track (per-cycle water traffic) and plants, in
one ``[row, col]`` layout; particle positions are (row, col).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops.flow import shift_clamped

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


def deposit_and_decay_plain(world: WorldState, track_acc, pool_acc, params,
                            height_scale) -> WorldState:
    """The plain version of kernel K12: the deposit's pool and track adds
    (``pool_acc``, ``track_acc``: the descent's accumulators; both None
    where the cycle does not spawn, and then no add), then
    ``update_flow_from_track``, as PyTorch operations on any device."""
    if track_acc is not None:
        world = replace(
            world,
            pool=world.pool + pool_acc * params.POOL_PLACEMENT_MULTIPLIER,
            track=world.track + track_acc * params.TRACK_PLACEMENT_MULTIPLIER,
        )
    return update_flow_from_track(world, params, height_scale)


def deposit_and_decay(world: WorldState, track_acc, pool_acc, params, height_scale, *,
                      out: WorldState = None) -> WorldState:
    """The deposit's adds and the track/flow decay of one cycle
    (``deposit_and_decay_plain``): CUDA tensors run kernel K12
    (``decay_cuda``) or raise, CPU tensors the plain version.  ``out``: a
    world whose flow and track maps take the new flow and track (they may
    be ``world``'s own); the pool always goes to a new map."""
    if world.pool.device.type == "cuda":
        from .decay_cuda import _launch

        return _launch(world, track_acc, pool_acc, params, height_scale, out)
    new = deposit_and_decay_plain(world, track_acc, pool_acc, params, height_scale)
    if out is None:
        return new
    return replace(new, flow=out.flow.copy_(new.flow), track=out.track.copy_(new.track))


def normal_map(state: WorldState, height_scale, patch_res):
    """4-cross summed normal (LiveErosionDataTypes.cs:502-523) of the
    water-inclusive height; f32[R, R, 3]."""
    h = wih(state, height_scale)
    up = shift_clamped(h, 1, 0)
    right = shift_clamped(h, 0, 1)
    down = shift_clamped(h, -1, 0)
    left = shift_clamped(h, 0, -1)
    # a = cross((0, h-up, p), (p, h-right, 0)); b = cross((0, h-down, -p), (-p, h-left, 0))
    p = patch_res
    ax = -p * (h - right)
    az = -(h - up) * p
    bx = p * (h - left)
    bz = p * (h - down)
    y = torch.full_like(h, 2.0 * p * p)  # a_y + b_y = 2p²
    return torch.stack([ax + bx, y, az + bz], -1)


# --- curvature (LiveErosionDataTypes.cs:729-867) ----------------------------

def _derivatives(height, height_scale, w):
    """CalculateDerivatives: 3x3 finite differences on scaled height,
    (zx, zy, zxx, zyy, zxy) before the reference's negation.  zyy keeps
    the reference's ``- 2.0f + (...)`` term verbatim
    (LiveErosionDataTypes.cs:773)."""
    h = height * height_scale
    w2 = w * w
    nw_ = shift_clamped(h, 1, -1)
    up_ = shift_clamped(h, 1, 0)
    ne_ = shift_clamped(h, 1, 1)
    left_ = shift_clamped(h, 0, -1)
    right_ = shift_clamped(h, 0, 1)
    sw_ = shift_clamped(h, -1, -1)
    down_ = shift_clamped(h, -1, 0)
    se_ = shift_clamped(h, -1, 1)
    z5 = h
    zx = (ne_ + right_ + se_ - nw_ - left_ - sw_) / (6.0 * w)
    zy = (nw_ + up_ + ne_ - sw_ - down_ - se_) / (6.0 * w)
    zxx = (nw_ + ne_ + left_ + right_ + sw_ + se_ - 2.0 * (up_ + z5 + down_)) / (3.0 * w2)
    zyy = (nw_ + up_ + ne_ + sw_ + down_ + se_ - 2.0 + (left_ + z5 + right_)) / (3.0 * w2)
    zxy = (ne_ + sw_ - nw_ - se_) / (4.0 * w2)
    return zx, zy, zxx, zyy, zxy


def _horizontal_curvature(zx, zy, zxx, zyy, zxy):
    """HorizontalCurvature (LiveErosionDataTypes.cs:820-829)."""
    zx2 = zx * zx
    zy2 = zy * zy
    p = zx2 + zy2
    n = zy2 * zxx - 2.0 * zxy * zx * zy + zx2 * zyy
    d = p * torch.pow(p + 1.0, 0.5)
    return torch.where(torch.abs(d) < 1e-18, 0.0, n / d)


def _rectify_range(v, exp_):
    """RectifyRange (LiveErosionDataTypes.cs:862-867): signed log
    compression."""
    pow_ = 10.0 ** exp_
    return torch.sign(v) * torch.log(1.0 + pow_ * torch.abs(v))


def curvature_map(height, height_scale, patch_res):
    """Curviture (LiveErosionDataTypes.cs:847-859): |horizontal
    curvature|, log-rectified with exponent .05, halved — the cavity
    texture channel."""
    zx, zy, zxx, zyy, zxy = _derivatives(height, height_scale, patch_res)
    v = torch.abs(_horizontal_curvature(-zx, -zy, -zxx, -zyy, -zxy))
    return torch.abs(_rectify_range(v, 0.05)) / 2.0
