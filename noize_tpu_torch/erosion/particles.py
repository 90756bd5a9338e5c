"""Beyer droplet particles — simultaneous descent; port of
``noize_tpu.erosion.particles``.

All N particles advance together, one step per iteration, with an alive
mask; each step's event deltas are scatter-added into three accumulator
maps (track, pool, sediment) in the reference's order (step-major, then
particle slot), so on the CPU every per-cell float32 sum matches.  The
reference's semantics are kept: flow-inflated neighbour heights quantised to 2
decimals, 8-heading constrained steering with the natural drain as
fallback, the death conditions and their payouts, drag, slope-resolved
acceleration, the terminal-velocity soft clamp, the capacity exchange and
evaporation.

Division by a constant is written as multiplication by its float32
reciprocal: that is what XLA's algebraic simplifier makes of the
reference's divisions in every compiled JAX program, and it keeps the
CPU and the card on the same bits.

Only the ``"waf"`` table layout is ported; the reference's patch
prefetch (``patch_k``), the ``"wf"`` layout and the alive-compaction
cascade are TPU tuning and give the same sums as the plain loop here.

On the card the descent is K7 (``erosion.descent_cuda``, ``csrc/descent.cu``):
one thread a particle for every step; ``descend_steps_plain`` is its plain
version.  Its events go through K9 (``erosion.scatter_cuda``,
``csrc/scatter.cu``), whose plain version is ``scatter_events`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.f32 import recip, sqrt
from ..prng import _randint_of_split
from ..utils.tracking import sync_bool
from .world import NEIGHBOR_OFFSETS, WorldState

_F32 = torch.float32

# Compass ring in ChooseHeading order: N, NE, E, SE, S, SW, W, NW as
# (d_row, d_col); N = +row ("up"), E = +col.
RING_DR = (1, 1, 0, -1, -1, -1, 0, 1)
RING_DC = (0, 1, 1, 1, 0, -1, -1, -1)

NONE_HEADING = -1

_NB_DR = tuple(o[0] for o in NEIGHBOR_OFFSETS)
_NB_DC = tuple(o[1] for o in NEIGHBOR_OFFSETS)


class Particles(NamedTuple):
    """SoA particle state (BeyerParticle fields)."""

    row: torch.Tensor       # f32[N]
    col: torch.Tensor       # f32[N]
    heading: torch.Tensor   # i32[N] ring index, -1 = NONE
    vel: torch.Tensor       # f32[N]
    water: torch.Tensor     # f32[N]
    sediment: torch.Tensor  # f32[N]
    age: torch.Tensor       # i32[N]
    alive: torch.Tensor     # bool[N]


def spawn(key, n: int, res: int, water=1.0, alive=True):
    """FillBeyerQueueJob parity: uniform random integer positions, vel .01,
    water 1, no heading.  ``key`` is a threefry key (``prng.PRNGKey``);
    the draws are ``jax.random``'s bits, on the key's device: ``randint``
    of each half of ``split(key)``, in one draw (one K8 launch on the
    card)."""
    row, col = _randint_of_split(key, (n,), 0, res, _F32)  # (kr, kc)
    device = key.device
    return Particles(
        row=row,
        col=col,
        heading=torch.full((n,), NONE_HEADING, dtype=torch.int32, device=device),
        vel=torch.full((n,), 0.01, dtype=_F32, device=device),
        water=torch.full((n,), water, dtype=_F32, device=device),
        sediment=torch.zeros((n,), dtype=_F32, device=device),
        age=torch.zeros((n,), dtype=torch.int32, device=device),
        alive=torch.full((n,), alive, dtype=torch.bool, device=device),
    )


def _quantize(v):
    """int(100·v)/100 — CollectNeighbors* truncation."""
    return torch.trunc(100.0 * v) * recip(100.0)


def _select8(table_rows, idx):
    """out[i] = table_rows[i, idx[i]] as an 8-way select chain."""
    out = table_rows[:, 0]
    for k in range(1, 8):
        out = torch.where(idx == k, table_rows[:, k], out)
    return out


def _velocity_term(v_diff, eff_friction, gravity, patch_res, sign):
    """UphillVelocityLoss (sign +1) / DownhillVelocityGain (sign −1) —
    NaN when v_diff == 0, as the reference's 0/0; callers rely on
    NaN-compares-false."""
    theta = torch.atan(v_diff * recip(patch_res))
    s = gravity * torch.sin(theta)
    accel = s + eff_friction if sign > 0 else s - eff_friction
    return sqrt(2.0 * torch.abs(accel) * (v_diff / torch.sin(theta)))


def _with_plants(params) -> bool:
    """The vegetation friction extension is on."""
    return getattr(params, "VEGETATION_FRICTION", 0.0) > 0.0


def step_maps(state: WorldState, params, height_scale):
    """The descent's read-only lookup table: [wih, all_heights, flow]
    flattened and concatenated (the reference's ``"waf"`` layout), with
    the plant density map as a fourth part when ``VEGETATION_FRICTION``
    is on."""
    wih_map = height_scale * (state.height + state.pool)
    all_h = wih_map + params.FLOW_HEIGHT_CONTRIBUTION * state.flow
    pieces = [wih_map.reshape(-1), all_h.reshape(-1), state.flow.reshape(-1)]
    if _with_plants(params):
        pieces.append(state.plants.reshape(-1))
    return torch.cat(pieces)


def _gather_step_values(combo, row_i, col_i, res, with_plants=False,
                        origin=None, shape=None):
    """All of a step's map lookups: 8 quantised all-heights neighbours,
    the WIH and the flow at the particle, and the plant density there
    when ``with_plants`` (else None).

    ``origin``/``shape``: when ``combo`` holds a window of the grid (the
    sharded descent's extended block), the global (row, col) of its cell
    (0, 0) and its (rows, cols).  Coordinates stay global, and so does the
    edge clamp; only the flat index changes.  A particle whose
    neighbourhood leaves the window (one another rank owns) reads the
    window's nearest cells: the reference's gather fills those reads, and
    its owner mask drops what they give."""
    n = row_i.shape[0]
    if shape is None:
        o_r = o_c = 0
        rows_w, cols_w = res, res
    else:
        o_r, o_c = (int(v) for v in origin)
        rows_w, cols_w = (int(v) for v in shape)
    sz = rows_w * cols_w
    dr = torch.tensor(_NB_DR, dtype=row_i.dtype, device=row_i.device)
    dc = torch.tensor(_NB_DC, dtype=col_i.dtype, device=col_i.device)
    r = torch.clamp(row_i[:, None] + dr[None, :], 0, res - 1) - o_r
    c = torch.clamp(col_i[:, None] + dc[None, :], 0, res - 1) - o_c
    rc, cc = row_i - o_r, col_i - o_c
    if shape is not None:
        r, c = torch.clamp(r, 0, rows_w - 1), torch.clamp(c, 0, cols_w - 1)
        rc, cc = torch.clamp(rc, 0, rows_w - 1), torch.clamp(cc, 0, cols_w - 1)
    center = rc * cols_w + cc
    parts = [(r * cols_w + c).reshape(-1) + sz, center, center + 2 * sz]
    if with_plants:
        parts.append(center + 3 * sz)
    vals = combo[torch.cat(parts).long()]
    nb = _quantize(vals[:8 * n].reshape(n, 8))
    plants_here = vals[10 * n:] if with_plants else None
    return nb, vals[8 * n:9 * n], vals[9 * n:10 * n], plants_here


def descend_step(p: Particles, state: WorldState, params, height_scale,
                 patch_res, res: int, maps=None, patch_ctx=None,
                 window_origin=None, window_shape=None, table_layout: str = "waf"):
    """One DescendSimultaneous step for every particle.  Returns
    (new_particles, events) with per-particle deltas and the cell
    (row_i, col_i) they land on.  ``table_layout`` chose the reference's
    gather table on the TPU and gives the same result either way.

    ``maps``: a precomputed table (``step_maps``).  ``window_origin`` and
    ``window_shape``: ``maps`` is built from a window of the grid (its
    cell (0, 0) at the global ``window_origin``), as the sharded descent
    builds it from a rank's extended block; see ``_gather_step_values``.
    The patch prefetch (``patch_ctx``) is a TPU workaround and raises."""
    if patch_ctx is not None:
        raise NotImplementedError("descend_step: the TPU patch prefetch is not ported")
    if (window_origin is None) != (window_shape is None):
        raise ValueError("descend_step: window_origin and window_shape go together")
    if window_shape is not None and maps is None:
        raise ValueError("descend_step: a windowed table needs maps=")
    if table_layout not in ("waf", "wf"):
        raise ValueError(f"unknown table_layout {table_layout!r}")
    inv_hs = recip(height_scale)
    row_i = torch.clamp(torch.round(p.row).to(torch.int32), 0, res - 1)
    col_i = torch.clamp(torch.round(p.col).to(torch.int32), 0, res - 1)
    was_alive = p.alive

    # death: dehydration
    dehydrated = was_alive & (p.water < 0.01)
    d_sed = torch.where(dehydrated, p.sediment * inv_hs, 0.0)
    # death: old age
    too_old = was_alive & ~dehydrated & (p.age >= params.MAXAGE)
    d_pool = torch.where(too_old, p.water * inv_hs, 0.0)
    d_sed = d_sed + torch.where(too_old, p.sediment * inv_hs, 0.0)

    active = was_alive & ~dehydrated & ~too_old

    with_plants = _with_plants(params)
    combo = maps if maps is not None else step_maps(state, params, height_scale)
    nb, current_h, flow_here, plants_here = _gather_step_values(
        combo, row_i, col_i, res, with_plants=with_plants, origin=window_origin,
        shape=window_shape)

    # natural drain: argmin (first-wins) over nb, direction via WTORDER
    drain_nb_idx = torch.argmin(nb, dim=-1).to(torch.int32)
    drain_height = torch.amin(nb, dim=-1)
    drain_ring = (drain_nb_idx % 4) * 2 + torch.div(drain_nb_idx, 4, rounding_mode="floor")

    heading = torch.where(p.heading < 0, drain_ring, p.heading)

    flow_pos = torch.clamp_min(flow_here, 0.0)
    eff_drag = params.DRAG * (1.0 - flow_pos)
    eff_friction = params.FRICTION * (1.0 - flow_pos)
    if with_plants:
        # the reference's extension: plant density scales friction,
        # capped at 2 stacked canopies
        eff_friction = eff_friction * (
            1.0 + params.VEGETATION_FRICTION * torch.clamp_max(plants_here, 2.0))

    # constrained steering; RING_TO_NB: nb = ring//2 + 4·(ring&1)
    left = (heading + 7) % 8
    right = (heading + 1) % 8

    def ring_to_nb(ring):
        return torch.div(ring, 2, rounding_mode="floor") + 4 * (ring % 2)

    h_left = _select8(nb, ring_to_nb(left))
    h_center = _select8(nb, ring_to_nb(heading))
    h_right = _select8(nb, ring_to_nb(right))
    go_left = (h_left < h_center) & (h_left < h_right)
    go_right = (h_right < h_left) & (h_right < h_center)
    flow_ring = torch.where(go_left, left, torch.where(go_right, right, heading))
    heading_height = torch.where(go_left, h_left,
                                 torch.where(go_right, h_right, h_center))

    h_diff = heading_height - current_h
    vel = p.vel - p.vel * eff_drag  # drag applies before the branch

    loss = _velocity_term(h_diff, eff_friction, params.GRAVITY, patch_res, +1)
    downhill_ok = h_diff < 0.0
    uphill_ok = ~downhill_ok & (loss <= vel)      # NaN loss → False
    take_heading = downhill_ok | uphill_ok
    velocity_loss = torch.where(uphill_ok, loss, 0.0)

    # fallback: natural drain; die if even the drain is uphill
    drain_h_diff = drain_height - current_h
    no_drain = active & ~take_heading & (drain_h_diff > 0.0)
    d_pool = d_pool + torch.where(no_drain, p.water * inv_hs, 0.0)
    d_sed = d_sed + torch.where(no_drain, p.sediment * inv_hs, 0.0)

    moving = active & ~no_drain
    new_ring = torch.where(take_heading, flow_ring, drain_ring)
    h_diff = torch.where(take_heading, h_diff, drain_h_diff)

    ring_dr = torch.tensor(RING_DR, dtype=_F32, device=p.row.device)
    ring_dc = torch.tensor(RING_DC, dtype=_F32, device=p.row.device)
    new_row = p.row + ring_dr[new_ring.long()]
    new_col = p.col + ring_dc[new_ring.long()]

    # out-of-bounds death loses everything
    nri = torch.round(new_row).to(torch.int32)
    nci = torch.round(new_col).to(torch.int32)
    oob = moving & ((nri < 0) | (nci < 0) | (nri >= res) | (nci >= res))
    moving = moving & ~oob

    # velocity update
    v_diff = torch.abs(h_diff)
    theta = torch.atan(v_diff * recip(patch_res))
    theta_d = theta * 180.0 * recip(3.14159)
    gain = _velocity_term(v_diff, eff_friction, params.GRAVITY, patch_res, -1)
    delta_v = torch.where(
        v_diff > 0.0, torch.where(h_diff > 0.0, -velocity_loss, gain), 0.0)
    vel = torch.clamp_min(vel + delta_v, 0.0)
    over = vel - params.TERMINAL_VELOCITY
    vel = vel - torch.clamp_min(
        torch.minimum(over, torch.clamp_min(eff_drag * 0.25 * over * over, 0.0)),
        0.0)

    # slow-and-flat cull — literal 3° / 1.0 thresholds
    slow = moving & (theta_d < 3.0) & (vel < 1.0)
    d_pool = d_pool + torch.where(slow, p.water * inv_hs, 0.0)
    d_sed = d_sed + torch.where(slow, p.sediment * inv_hs, 0.0)
    moving = moving & ~slow

    # capacity exchange
    capacity = vel * p.water * params.CAPACITY
    deposition = torch.where(
        p.sediment < capacity,
        -params.EROSION * (capacity - p.sediment),
        params.DEPOSITION * (p.sediment - capacity),
    )
    d_sed = d_sed + torch.where(moving, deposition * inv_hs, 0.0)
    new_sediment = torch.where(moving, p.sediment - deposition, p.sediment)

    # water track + evaporation
    d_track = torch.where(moving, p.water, 0.0)
    new_water = torch.where(moving, p.water * (1.0 - params.EVAP), p.water)

    out = Particles(
        row=torch.where(moving, new_row, p.row),
        col=torch.where(moving, new_col, p.col),
        heading=torch.where(moving, new_ring, p.heading),
        vel=torch.where(moving, vel, p.vel),
        water=new_water,
        sediment=new_sediment,
        age=torch.where(moving, p.age + 1, p.age),
        alive=moving,
    )
    events = dict(row=row_i, col=col_i, d_track=d_track, d_pool=d_pool, d_sed=d_sed)
    return out, events


def _event_cells(ev, res: int, origin=None, shape=None):
    """The flat table cell of each event: ``row·res + col`` on the grid's
    table, or the window's cell (clamped into it) on a window's."""
    if shape is None:
        return (ev["row"] * res + ev["col"]).long()
    wr = torch.clamp(ev["row"] - int(origin[0]), 0, int(shape[0]) - 1)
    wc = torch.clamp(ev["col"] - int(origin[1]), 0, int(shape[1]) - 1)
    return (wr * int(shape[1]) + wc).long()


def descend_steps_plain(p: Particles, maps, params, height_scale, patch_res, res: int,
                        steps: int, window_origin=None, window_shape=None, owned=None):
    """``steps`` ``descend_step``s on the table ``maps`` (``step_maps``, or
    a window's: ``window_origin``/``window_shape``), with no early exit:
    the plain version of K7 (``descent_cuda.descend_steps`` and
    ``descend_steps_window``).  Returns (particles, cells i64[steps·N],
    d_track, d_pool, d_sed f32[steps·N]): every step's events, dead slots
    included, step-major then particle slot.  ``owned`` (bool[N]) zeroes
    the events of particles another rank owns."""
    cells = [torch.zeros(0, dtype=torch.int64, device=p.row.device)]
    evs = tuple([torch.zeros(0, dtype=_F32, device=p.row.device)] for _ in range(3))
    for _ in range(steps):
        p, ev = descend_step(p, None, params, height_scale, patch_res, res, maps=maps,
                             window_origin=window_origin, window_shape=window_shape)
        cells.append(_event_cells(ev, res, window_origin, window_shape))
        for e, k in zip(evs, ("d_track", "d_pool", "d_sed")):
            e.append(ev[k] if owned is None else torch.where(owned, ev[k], 0.0))
    return (p, torch.cat(cells)) + tuple(torch.cat(e) for e in evs)


#: the most values a CPU ``index_put_(accumulate=True)`` call adds in
#: order: from PyTorch's grain size (32768) up, with more than one thread,
#: it adds them with atomics in no fixed order
CPU_IN_ORDER = 32767


def scatter_events(cells, deltas, size: int, acc=None):
    """The per-cell sums of the events, added into ``acc`` (flat f32 maps,
    in place) or into zeros of ``size``: each cell's events added to it one
    by one in their order (step-major, then particle slot), as the
    reference's scatter adds them.  On the CPU that is ``index_put_`` with
    ``accumulate=True``, a map at a time, in calls of at most
    ``CPU_IN_ORDER`` events; on CUDA it is K9 (``scatter_cuda``, one call
    for up to four maps), which gives the same bits whatever the events'
    chunking, or raises."""
    if cells.device.type != "cpu":
        from .scatter_cuda import scatter_in_order

        return scatter_in_order(cells, list(deltas), size, acc)
    if acc is None:
        acc = [torch.zeros(size, dtype=_F32, device=cells.device) for _ in deltas]
    for a, d in zip(acc, deltas):
        for c, v in zip(cells.split(CPU_IN_ORDER), d.split(CPU_IN_ORDER)):
            a.index_put_((c,), v, accumulate=True)
    return acc


def _descend_all_plain(p: Particles, state: WorldState, params, height_scale, patch_res,
                       res: int, steps: int, chunk: int, syncs: list = None):
    """``descend_all`` as torch operations: chunks of ``chunk`` steps
    (``descend_steps_plain``), the reference's all-dead early exit before
    each (one host sync each, counted in ``syncs`` when given), and each
    chunk's events scatter-added into the accumulators, as the reference's
    ``scatter="chunk"`` mode adds them."""
    n_chunks = -(-steps // chunk)
    shape = state.height.shape
    maps = step_maps(state, params, height_scale)
    acc = [torch.zeros(shape[0] * shape[1], dtype=_F32, device=state.height.device)
           for _ in range(3)]
    for _ in range(n_chunks):
        if not sync_bool("descent.alive", p.alive.any(), syncs):
            break
        p, cells, *deltas = descend_steps_plain(p, maps, params, height_scale, patch_res,
                                                res, chunk)
        scatter_events(cells, deltas, shape[0] * shape[1], acc)
    track_acc, pool_acc, sed_acc = (a.reshape(shape) for a in acc)
    return p, track_acc, pool_acc, sed_acc


def _descend_all_fixed(p: Particles, state: WorldState, params, height_scale, patch_res,
                       res: int, steps: int):
    """``descend_all`` as K7 runs it: ``steps`` steps in one
    ``descent_cuda.descend_steps`` call (K7 on the record table on the card,
    the plain loop on ``step_maps`` on the CPU) and one ``scatter_events``
    call for the three maps (K9 on the card).  Steps after a particle's
    death add zeros to accumulators that never hold -0.0, so the sums are
    bit-equal to ``_descend_all_plain``'s, which stops early, on the CPU and
    on the card alike."""
    from .descent_cuda import descend_steps, descent_table

    shape = state.height.shape
    table = descent_table(state, params, height_scale)
    p, cells, *deltas = descend_steps(p, table, params, height_scale, patch_res, res, steps)
    track_acc, pool_acc, sed_acc = (a.reshape(shape)
                                    for a in scatter_events(cells, deltas, shape[0] * shape[1]))
    return p, track_acc, pool_acc, sed_acc


def descend_all(p: Particles, state: WorldState, params, height_scale,
                patch_res, res: int, max_steps: int = None, chunk: int = 8,
                patch_k: int = 0, table_layout: str = "waf", scatter: str = "chunk",
                compact: bool = True, *, syncs: list = None):
    """Run the full descent; returns (particles, track_acc, pool_acc,
    sed_acc).

    ``MAXAGE + 1`` steps cover every trajectory, run as ``chunk``-step
    chunks (the reference's ``lax.scan`` length), so ``ceil(steps / chunk)
    · chunk`` steps in all.  Events scatter-add step-major, then particle
    slot — the reference's order, so duplicate-cell f32 sums match it, on
    the card too (``scatter_events``).

    On CUDA tensors the descent is K7 (``descent_cuda.descend_steps``): the
    record table, one launch for every step and one in-order scatter of
    the three maps (K9), no host sync.  On CPU
    tensors it is the plain loop, with the reference's all-dead early exit
    before each chunk (one host sync each, counted in ``syncs`` when
    given).  ``patch_k``, ``table_layout``, ``scatter`` and ``compact``
    chose how the TPU ran the same sums and are ignored."""
    steps = (params.MAXAGE + 1) if max_steps is None else max_steps
    if state.height.device.type == "cpu":
        return _descend_all_plain(p, state, params, height_scale, patch_res, res, steps,
                                  chunk, syncs=syncs)
    return _descend_all_fixed(p, state, params, height_scale, patch_res, res,
                              -(-steps // chunk) * chunk)
