"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.erosion.pool``, without the K4
entry.  Pool automata — cellular standing-water spread with drain detection.

This is the plain PyTorch version of kernel K4
(``erosion.pool_cuda.pool_automata_cuda``), bit-equal to the reference's
``pool_automata``: WATER_STEPS × 4 phases on the even/odd half-row
lattices (``_phase_pair``), each cell ranking its 4 neighbours by
ascending (height+pool, direction) and running the 4 sequential
sub-steps (``_phase_core``), with transfers added in the reference's
order.  Odd grids use the full-grid masked phases
(``_pool_automata_fullgrid``).
"""

from __future__ import annotations

import torch

from .flow import shift_clamped

#: Per-cell activity gate — SpreadPool skips a cell while
#: ``hWater < 1E-3f`` (LiveErosionDataTypes.cs:972).  A grid where no cell
#: reaches it is a bit-exact fixed point of the automata, so a whole call
#: is skipped then (see ``noize_tpu.erosion.pool.MIN_WATER``).
MIN_WATER = 1e-3

# neighbour order in SpreadPool: up, right, down, left (as (d_row, d_col))
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))

# phase order (xoff, zoff) nesting parity with MultiThreadErosionJob.cs:314-324
_PHASE_ORDER = tuple((xo, zo) for xo in (0, 1) for zo in (0, 1))


def _shift_zero(a, dz: int, dc: int):
    """out[r] = a[r + (dz, dc)] with zeros outside."""
    out = a
    if dz > 0:
        out = torch.cat([out[dz:, :], out.new_zeros((dz,) + out.shape[1:])], 0)
    elif dz < 0:
        out = torch.cat([out.new_zeros((-dz,) + out.shape[1:]), out[:dz, :]], 0)
    if dc > 0:
        out = torch.cat([out[:, dc:], out.new_zeros(out.shape[:1] + (dc,))], 1)
    elif dc < 0:
        out = torch.cat([out.new_zeros(out.shape[:1] + (-dc,)), out[:, :dc]], 1)
    return out


def _phase_core(n_height, n_water, h_land, pool_snapshot, geo_mask,
                drain_particles: bool, hl_ge_nh=None):
    """The per-cell phase body (``pool._phase_core``): rank the 4
    neighbours by ascending (height+pool, direction), run the 4 sequential
    rank-ordered sub-steps, and return (new_water, deltas[4], drain_out[4])
    — giver-indexed per-direction transfer volumes."""
    if hl_ge_nh is None:
        hl_ge_nh = [h_land >= n_height[d] for d in range(4)]
    keys = [n_height[d] + n_water[d] for d in range(4)]
    elig = [(n_water[d] <= 0.0) & hl_ge_nh[d] for d in range(4)]

    def le(a, b):
        return (a <= b).to(a.dtype)

    a01 = le(keys[0], keys[1])
    a02 = le(keys[0], keys[2])
    a03 = le(keys[0], keys[3])
    a12 = le(keys[1], keys[2])
    a13 = le(keys[1], keys[3])
    a23 = le(keys[2], keys[3])
    rank = [
        3.0 - a01 - a02 - a03,
        2.0 + a01 - a12 - a13,
        1.0 + a02 + a12 - a23,
        a03 + a13 + a23,
    ]
    hits = [[rank[d] == float(e) for e in range(4)] for d in range(4)]

    def pick(e, f):
        return torch.where(hits[0][e], f[0],
                           torch.where(hits[1][e], f[1],
                                       torch.where(hits[2][e], f[2], f[3])))

    def pick_bool(e, f):
        return ((hits[0][e] & f[0]) | (hits[1][e] & f[1])
                | (hits[2][e] & f[2]) | (hits[3][e] & f[3]))

    h_water = pool_snapshot
    t_height = h_land + h_water
    moved_s = []
    drain_s = []
    for e in range(4):
        key_e = pick(e, keys)
        bw_e = pick(e, n_water)
        elig_e = pick_bool(e, elig)
        diff_v = t_height - key_e
        can = geo_mask & (h_water >= MIN_WATER)
        clipv = torch.minimum(
            torch.maximum(0.25 * diff_v, -0.25 * bw_e), 0.25 * h_water)
        moved = torch.where(can, torch.where(elig_e, h_water, clipv), 0.0)
        h_water = h_water - moved
        t_height = h_land + h_water
        moved_s.append(moved)
        drain_s.append(elig_e)

    def demux(vals):
        return [
            torch.where(hits[d][0], vals[0],
                        torch.where(hits[d][1], vals[1],
                                    torch.where(hits[d][2], vals[2], vals[3])))
            for d in range(4)
        ]

    all_d = demux(moved_s)
    if drain_particles:
        drain_amt = torch.where(drain_s[0], moved_s[0], 0.0)
        for e in range(1, 4):
            drain_amt = drain_amt + torch.where(drain_s[e], moved_s[e], 0.0)
        minus_one = torch.full_like(h_water, -1.0)
        drain_e = torch.where(
            drain_s[0], 0.0,
            torch.where(drain_s[1], 1.0,
                        torch.where(drain_s[2], 2.0,
                                    torch.where(drain_s[3], 3.0, minus_one))))
        drain_out = [torch.where(rank[d] == drain_e, drain_amt, 0.0)
                     for d in range(4)]
        deltas = [all_d[d] - drain_out[d] for d in range(4)]
    else:
        deltas = all_d
        drain_out = [torch.zeros_like(pool_snapshot) for _ in range(4)]
    return h_water, deltas, drain_out


# --- even grids: the (active, complement) half-row lattice pair ------------

def _halfrow_views(full, zoff: int):
    r = full.shape[0]
    x = full.reshape(r // 2, 2, r)
    return x[:, zoff, :], x[:, 1 - zoff, :]


def _halfrow_join(active, comp, zoff: int):
    r2, r = active.shape
    pair = (active, comp) if zoff == 0 else (comp, active)
    return torch.stack(pair, dim=1).reshape(2 * r2, r)


def _pair_iotas(shape, device):
    j = torch.arange(shape[0], device=device)[:, None].expand(shape)
    col = torch.arange(shape[1], device=device)[None, :].expand(shape)
    return j, col


def _pair_geo_mask(shape, xoff: int, device):
    """Lattice mask of one phase on the pair layout (column parity per
    lattice row j)."""
    j, col = _pair_iotas(shape, device)
    return (col % 2) == ((xoff + j) % 2)


def _shift_down_row(x):  # out[k] = x[k-1]; row 0 value unused
    return torch.cat([x[:1], x[:-1]], 0)


def _shift_up_row(x):    # out[k] = x[k+1]; last row unused
    return torch.cat([x[1:], x[-1:]], 0)


def _pair_pre(a_h, c_h, zoff: int, res: int):
    """Phase-invariant neighbour heights and drain-eligibility compares."""
    r2 = res // 2
    j, _ = _pair_iotas(a_h.shape, a_h.device)
    if zoff == 0:
        up_h = c_h
        down_h = torch.where(j == 0, a_h, _shift_down_row(c_h))
    else:
        up_h = torch.where(j == r2 - 1, a_h, _shift_up_row(c_h))
        down_h = c_h
    n_height = [up_h, shift_clamped(a_h, 0, 1), down_h,
                shift_clamped(a_h, 0, -1)]
    return {"n_height": n_height,
            "hl_ge_nh": [a_h >= n_height[d] for d in range(4)]}


def _phase_pair(a_h, a_p, c_p, zoff: int, drain_particles: bool, res: int,
                pre, geo_mask):
    """One phase on the (active, complement) row-lattice pair; ``pre`` and
    ``geo_mask`` are the phase-invariant ``_pair_pre`` / ``_pair_geo_mask``.
    Returns (new_active_pool, new_comp_pool, drain_active, drain_comp)."""
    r2 = res // 2
    j, col = _pair_iotas(a_p.shape, a_p.device)
    if zoff == 0:
        up_p = c_p
        down_p = torch.where(j == 0, a_p, _shift_down_row(c_p))
    else:
        up_p = torch.where(j == r2 - 1, a_p, _shift_up_row(c_p))
        down_p = c_p
    n_water = [up_p, shift_clamped(a_p, 0, 1), down_p,
               shift_clamped(a_p, 0, -1)]
    h_water, deltas, drain_out = _phase_core(
        pre["n_height"], n_water, a_h, a_p, geo_mask, drain_particles,
        hl_ge_nh=pre["hl_ge_nh"])

    border_up = (j == r2 - 1) if zoff == 1 else torch.zeros_like(geo_mask)
    border_down = (j == 0) if zoff == 0 else torch.zeros_like(geo_mask)
    border_right = col == res - 1
    border_left = col == 0

    def scatter(a_acc, c_acc, dl):
        a_acc = (a_acc + _shift_zero(dl[1], 0, -1)
                 + torch.where(border_right, dl[1], 0.0))
        a_acc = (a_acc + _shift_zero(dl[3], 0, 1)
                 + torch.where(border_left, dl[3], 0.0))
        if zoff == 0:
            c_acc = c_acc + dl[0]
        else:
            c_acc = c_acc + _shift_zero(dl[0], -1, 0)
            a_acc = a_acc + torch.where(border_up, dl[0], 0.0)
        if zoff == 0:
            c_acc = c_acc + _shift_zero(dl[2], 1, 0)
            a_acc = a_acc + torch.where(border_down, dl[2], 0.0)
        else:
            c_acc = c_acc + dl[2]
        return a_acc, c_acc

    new_a, new_c = scatter(h_water, c_p, deltas)
    if drain_particles:
        da, dc = scatter(torch.zeros_like(a_p), torch.zeros_like(c_p), drain_out)
    else:
        da = torch.zeros_like(a_p)
        dc = torch.zeros_like(c_p)
    return new_a, new_c, da, dc


def pool_automata(height, pool, iterations: int = 10, drain_particles: bool = True):
    """PoolAutomataJob.Schedule parity: iterations × 4 phases in
    ``_PHASE_ORDER``.  Returns (pool, drain_map); drain_map accumulates
    the water dropped at drain sites across all phases."""
    res = height.shape[0]
    if res % 2:
        return _pool_automata_fullgrid(height, pool, iterations, drain_particles)
    if not bool((pool >= MIN_WATER).any()):  # the wetness gate (a host sync)
        return pool, torch.zeros_like(pool)
    h_even, h_odd = _halfrow_views(height, 0)
    p_even, p_odd = _halfrow_views(pool, 0)
    d_even = torch.zeros_like(p_even)
    d_odd = torch.zeros_like(p_odd)
    pre_z = (_pair_pre(h_even, h_odd, 0, res), _pair_pre(h_odd, h_even, 1, res))
    masks = {xo: _pair_geo_mask(p_even.shape, xo, pool.device) for xo in (0, 1)}
    for _ in range(iterations):
        for xoff, zoff in _PHASE_ORDER:
            if zoff == 0:
                p_even, p_odd, da, dc = _phase_pair(
                    h_even, p_even, p_odd, 0, drain_particles, res,
                    pre_z[0], masks[xoff])
                d_even, d_odd = d_even + da, d_odd + dc
            else:
                p_odd, p_even, da, dc = _phase_pair(
                    h_odd, p_odd, p_even, 1, drain_particles, res,
                    pre_z[1], masks[xoff])
                d_even, d_odd = d_even + dc, d_odd + da
    return _halfrow_join(p_even, p_odd, 0), _halfrow_join(d_even, d_odd, 0)


# --- odd grids: full-grid masked phases ------------------------------------

def _phase_mask_from_coords(grow, gcol, xoff: int, zoff: int):
    """Active lattice of one phase, from the cells' global (row, col)
    maps: rows z = 2·j + zoff; columns x ≡ xoff + (j mod 2) (mod 2)."""
    j = torch.div(grow - zoff, 2, rounding_mode="floor")
    row_active = (grow % 2) == (zoff % 2)
    col_parity = (xoff + j) % 2
    return ((gcol % 2) == col_parity) & row_active


def _border_maps(shape, grow=None, gcol=None, res: int = None, *, device=None):
    """Cells on the grid's border in each direction (the neighbour there
    is the cell itself).  Without ``grow``/``gcol`` the map is the whole
    (rows, cols) grid; with them, the cells' global coordinates on a
    ``res``² grid."""
    if grow is None:
        grow = torch.arange(shape[0], device=device)[:, None].expand(shape)
        gcol = torch.arange(shape[1], device=device)[None, :].expand(shape)
        res_r, res_c = shape
    else:
        res_r = res_c = res
    return {
        (1, 0): grow == res_r - 1,
        (-1, 0): grow == 0,
        (0, 1): gcol == res_c - 1,
        (0, -1): gcol == 0,
    }


def _scatter_dir(acc, delta, dr: int, dc: int, border_map):
    acc = acc + _shift_zero(delta, -dr, -dc)
    return acc + torch.where(border_map, delta, 0.0)


def _spread_phase(height, pool, mask, drain_particles: bool, border=None):
    """One phase over the whole grid (masked).  ``border``: the border
    maps of ``_border_maps`` (None: the map is the whole grid)."""
    if border is None:
        border = _border_maps(height.shape, device=height.device)
    n_height = [shift_clamped(height, dr, dc) for (dr, dc) in _DIRS]
    n_water = [shift_clamped(pool, dr, dc) for (dr, dc) in _DIRS]
    new_pool, deltas, drain_out = _phase_core(
        n_height, n_water, height, pool, mask, drain_particles)
    drain_map = torch.zeros_like(pool)
    for d, (dr, dc) in enumerate(_DIRS):
        new_pool = _scatter_dir(new_pool, deltas[d], dr, dc, border[(dr, dc)])
        if drain_particles:
            drain_map = _scatter_dir(drain_map, drain_out[d], dr, dc,
                                     border[(dr, dc)])
    return new_pool, drain_map


def _pool_automata_fullgrid(height, pool, iterations: int,
                            drain_particles: bool):
    """The full-grid masked phases: the window that is the whole grid,
    with no drains carried in."""
    return _pool_automata_window(height, pool, torch.zeros_like(pool), iterations,
                                 drain_particles, (0, 0), height.shape[0])


def _check_window(shape, origin, res: int, name: str):
    """Refuse a window that leaves the ``res``² grid."""
    if origin[0] < 0 or origin[1] < 0 or origin[0] + shape[0] > res \
            or origin[1] + shape[1] > res or min(shape) < 1:
        raise ValueError(f"{name}: a {tuple(shape)} window at {tuple(origin)} leaves the "
                         f"{res}² grid")


def _pool_automata_window(height, pool, drains, iterations: int, drain_particles: bool,
                          origin, res: int):
    """The full-grid masked phases of a ``res``² grid on a window of it
    (the plain version of K5's window entry, ``pool_cuda.
    pool_automata_window``): ``height``, ``pool`` and ``drains`` are rows ×
    cols cells from ``origin`` = (row, col) on; the phase lattice and the
    border self-returns come from global coordinates, and each phase's
    drain map is added onto ``drains`` in phase order, as the sharded
    pool adds them onto a block's running sum.  Cells within 2 a phase of
    a window edge that is not the grid's edge are not exact; the caller
    crops them.  The window lies in the grid, so no cell is a ghost beyond
    its border (the reference's ``reclamp_ghosts`` has nothing to do)."""
    _check_window(height.shape, origin, res, "pool_automata_window")
    rows, cols = height.shape
    grow = (torch.arange(rows, device=height.device) + int(origin[0]))[:, None].expand(rows, cols)
    gcol = (torch.arange(cols, device=height.device) + int(origin[1]))[None, :].expand(rows, cols)
    border = _border_maps(height.shape, grow, gcol, res)
    masks = [_phase_mask_from_coords(grow, gcol, xo, zo) for xo, zo in _PHASE_ORDER]
    for _ in range(iterations):
        for m in masks:
            pool, dm = _spread_phase(height, pool, m, drain_particles, border=border)
            drains = drains + dm
    return pool, drains
