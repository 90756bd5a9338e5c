"""The full erosion cycle on one grid sharded over a 2-D (``x``, ``y``)
mesh; port of ``noize_tpu.parallel.sharded_erosion``.

Each rank holds its block of every map (a ``DTensor`` placed ``Shard(0)``,
``Shard(1)``); the PRNG key is replicated.  Per phase:

* thermal — ``sharded_ops.sharded_thermal_erosion`` (K3 on a window).
* spawn — the fresh particles are the same on every rank (one key).  The
  drain particles need the global top-K of the drain map: each rank
  top-Ks its block, the (value, global index) candidates are gathered,
  and every rank picks the same K by value descending, then index
  ascending — two stable sorts, the ties ``lax.top_k`` gives.
* descent — particles are replicated; each chunk of ``chunk`` steps the
  rank whose block holds a particle's cell owns it.  The maps are read
  only, so one exchange of width ``chunk`` before the loop suffices, and
  each chunk is one ``descend_steps_window`` call (K7 on the card) on the
  extended block as a windowed table.  Every rank steps every particle;
  non-owned ones read clamped window cells and their events are zeroed.
  After each chunk one ``all_reduce`` of the 8 particle fields packed as
  an (8, N) f32 stack merges the owners' results.  Every chunk's events
  scatter once, at the end, into extended accumulators (as the
  single-device descent scatters its events: on one rank the same events
  in the same order, so the same bits on the card too), folded back onto
  their owners (``halo.fold_2d``).  A fixed
  ``ceil((MAXAGE + 1) / chunk)`` chunks run: an early exit taken by one
  rank alone would leave the others waiting in a collective.
* sediment — the clamped-scatter dispersal as a zero-padded correlation
  over a zero-border exchange, with the edge folds on the global-border
  blocks only; ``EXACT_PILES`` gathers the ≤ K piles' slot values into a
  table every rank holds and solves it there (K6's table entry), each rank
  then committing to its own block.
* flow — the deposit's adds and the track/flow decay are per cell:
  ``erosion.world.deposit_and_decay`` on the blocks (K12 on the card).
* pool automata — one exchange a group of ``POOL_GROUP`` water steps (all
  of a cycle's at the default ``WATER_STEPS``): the pool extended 8 cells
  a step of the group toward the neighbours (through as many neighbour
  blocks as that reaches), one K5 window call for the group's steps
  (global-coordinate masks and borders, the drains carried in, each step
  computing only the cells that can still be exact), the block cropped
  back.  The reference exchanges 8 cells once a step; the results are the
  same.

Equality with the port's single-device cycle (D8 in the reference's
words): spawn, thermal, the pool phases (pool and drains), the tent and
exact pile sediment paths and the keys are bit-equal on every mesh, and
so is the whole cycle on a mesh of one rank.  The descent's per-cell
event sums reassociate where particles of two ranks touch one cell near a
block border (each rank sums its own particles' events, the fold adds the
neighbour's strip after), so the track, pool and sediment sums, and what
follows from them, differ by float rounding there.  Measured on 4 gloo
ranks (``tests/test_torch_sharded_erosion.py``, a 32² grid, 48 particles
of age ≤ 12): after one cycle the largest difference is 7.5e-9 (flow) on
the 2×2 mesh and 3.7e-9 on the 4×1 mesh, every other map equal; after
two cycles, none.  The tests hold it to the reference's 2e-6.  The
reference's single-TPU ``approx_max_k`` drain shortcut is not used: the
top-K is exact.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.tiles import TileSetMeta
from ..erosion.params import ErosionMode, ErosionSettings
from ..erosion.descent_cuda import descend_steps_window, descent_table
from ..erosion.particles import Particles, scatter_events, spawn
from ..erosion.pile_cuda import solve_pile_table
from ..erosion.pool_cuda import pool_automata_window
from ..erosion.sediment import KERNEL5, _pile_tables, _triangle_taps, pile_increment
from ..erosion.sim import ErosionSim as _ErosionSimBase, SimState, init_state
from ..erosion.world import WorldState, deposit_and_decay
from ..prng import PRNGKey, split
from .halo import (_as_field, _axis, _extend_2d, _local_block, _mesh_device, exchange_2d,
                   exchange_axis, fold_2d)

_F32 = torch.float32
_WORLD = ("height", "pool", "flow", "track", "plants")


def _origin(mesh, block_shape):
    lr, lc = block_shape
    return mesh.get_local_rank("x") * lr, mesh.get_local_rank("y") * lc


def _psum(t, mesh):
    """Sum ``t`` in place over the mesh's ``x`` and ``y`` axes."""
    for name in ("x", "y"):
        _, n, group = _axis(mesh, name)
        if n > 1:
            dist.all_reduce(t, group=group)
    return t


def _gather(t, mesh):
    """The 1-D ``t`` of every rank of the ``x``-``y`` mesh, concatenated
    (over ``x``, then over ``y``)."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    for name in ("x", "y"):
        _, n, group = _axis(mesh, name)
        if n > 1:
            out = t.new_empty((n * t.numel(),))
            gather(out, t.contiguous(), group=group)
            t = out
    return t


def _top_candidates(flat, k: int, lc: int, row0: int, col0: int, res_c: int, mesh):
    """The global top ``k`` of a field from each rank's block ``flat``
    (row-major, ``lc`` columns, its cell (0, 0) at (row0, col0) of a grid
    of ``res_c`` columns): (values, global flat indices), value descending
    and index ascending on ties — every rank gets the same."""
    neg, lidx = torch.sort(-flat, stable=True)
    kloc = min(k, flat.numel())
    vals, lidx = -neg[:kloc], lidx[:kloc]
    gidx = (torch.div(lidx, lc, rounding_mode="floor") + row0) * res_c + (lidx % lc + col0)
    vals, gidx = _gather(vals, mesh), _gather(gidx, mesh)
    by_index = torch.sort(gidx, stable=True).indices
    vals, gidx = vals[by_index], gidx[by_index]
    order = torch.sort(-vals, stable=True).indices[:k]
    return vals[order], gidx[order]


# --- spawn -------------------------------------------------------------------

def _spawn_block(mesh, drain, k1, n: int, res: int):
    """``_spawn_with_drains`` on this rank's drain block: (particles,
    leftover drain block)."""
    lr, lc = drain.shape
    row0, col0 = _origin(mesh, (lr, lc))
    fresh = spawn(k1, n, res)
    flat = drain.reshape(-1)
    vals, idxs = _top_candidates(flat, n, lc, row0, col0, res, mesh)
    has_drain = vals > 0.0
    rows_i = torch.div(idxs, res, rounding_mode="floor")
    cols_i = idxs % res
    parts = fresh._replace(
        row=torch.where(has_drain, rows_i.to(_F32), fresh.row),
        col=torch.where(has_drain, cols_i.to(_F32), fresh.col),
        water=torch.where(has_drain, vals, fresh.water),
    )
    own = (has_drain & (rows_i >= row0) & (rows_i < row0 + lr)
           & (cols_i >= col0) & (cols_i < col0 + lc))
    li = (torch.clamp(rows_i - row0, 0, lr - 1) * lc + torch.clamp(cols_i - col0, 0, lc - 1))
    taken = torch.zeros_like(flat).index_put_((li,), torch.where(own, vals, 0.0),
                                              accumulate=True)
    return parts, torch.clamp_min(flat - taken, 0.0).reshape(lr, lc)


def _sharded_spawn(mesh, drain_water, key, n: int, res: int):
    """``_spawn_with_drains`` (erosion.sim) over a sharded drain map.
    Returns (particles, replicated; leftover drain, sharded; next key).
    The drain path runs whatever the drain map holds: with no drains every
    candidate is 0 and the result is the fresh spawn, as the single-device
    test of ``any(drain > 0)`` gives."""
    k1, k2 = split(key)
    block, shape = _local_block(drain_water, mesh)
    parts, leftover = _spawn_block(mesh, block, k1, n, res)
    return parts, _as_field(leftover, mesh, shape), k2


# --- descent -----------------------------------------------------------------

def _descent_block(mesh, world: WorldState, parts: Particles, params, height_scale,
                   patch_res, res: int, chunk: int = 8):
    """``descend_all`` on this rank's blocks of ``world`` with replicated
    particles: (particles, track, pool and sediment accumulator blocks)."""
    steps = params.MAXAGE + 1
    n_chunks = -(-steps // chunk)
    h = chunk
    lr, lc = world.height.shape
    if h > lr or h > lc:
        raise ValueError(f"descent halo {h} exceeds shard block {(lr, lc)}; use a smaller "
                         "chunk, fewer shards, or a larger field")
    row0, col0 = _origin(mesh, (lr, lc))
    er, ec = lr + 2 * h, lc + 2 * h
    with_plants = getattr(params, "VEGETATION_FRICTION", 0.0) > 0.0
    maps = [world.height, world.pool, world.flow] + ([world.plants] if with_plants else [])
    ext = exchange_2d(torch.stack(maps, -1), h, mesh=mesh)  # one exchange for all
    # the extended block's table (step_maps on the CPU, K7's records on the
    # card): each cell's values from its own maps, as on the whole grid
    ext_world = WorldState(height=ext[..., 0], pool=ext[..., 1], flow=ext[..., 2], track=None,
                           plants=ext[..., 3] if with_plants else None)
    combo = descent_table(ext_world, params, height_scale)
    origin = (row0 - h, col0 - h)
    events = []
    for _ in range(n_chunks):
        row_i = torch.clamp(torch.round(parts.row).to(torch.int32), 0, res - 1)
        col_i = torch.clamp(torch.round(parts.col).to(torch.int32), 0, res - 1)
        owned = ((row_i >= row0) & (row_i < row0 + lr) & (col_i >= col0) & (col_i < col0 + lc))
        # one K7 launch a chunk; a particle another rank owns may be outside
        # the window: its cell clamps into it and its events are 0
        parts, *ev = descend_steps_window(parts, combo, params, height_scale, patch_res, res,
                                          chunk, origin, (er, ec), owned)
        events.append(ev)
        # the owners' results: one rank holds each particle, the others add 0
        stack = torch.stack([parts.row, parts.col, parts.heading.to(_F32), parts.vel,
                             parts.water, parts.sediment, parts.age.to(_F32),
                             parts.alive.to(_F32)])
        stack = _psum(torch.where(owned[None, :], stack, 0.0), mesh)
        parts = Particles(row=stack[0], col=stack[1], heading=stack[2].to(torch.int32),
                          vel=stack[3], water=stack[4], sediment=stack[5],
                          age=stack[6].to(torch.int32), alive=stack[7] > 0.5)
    # one scatter of every chunk's events, step-major then particle slot,
    # as the single-device descent scatters its events
    cells, *deltas = (torch.cat(e) for e in zip(*events))
    acc = scatter_events(cells, deltas, er * ec)
    folded = fold_2d(torch.stack(acc, -1).reshape(er, ec, 3), h, mesh=mesh)
    return parts, folded[..., 0], folded[..., 1], folded[..., 2]


def _sharded_descent(mesh, world: WorldState, parts: Particles, params, height_scale,
                     patch_res, res: int, chunk: int = 8):
    """``descend_all`` over sharded maps with replicated particles.  Fixed
    ``ceil((MAXAGE + 1) / chunk)`` chunks (the single-device early exit
    skips only no-op steps).  Returns (particles, track, pool, sediment),
    the accumulators sharded like the maps."""
    blocks = {}
    for name in _WORLD:
        blocks[name], shape = _local_block(getattr(world, name), mesh)
    out = _descent_block(mesh, WorldState(**blocks), parts, params, height_scale, patch_res,
                         res, chunk)
    return (out[0],) + tuple(_as_field(a.contiguous(), mesh, shape) for a in out[1:])


# --- sediment ----------------------------------------------------------------

def _disperse_axis_sharded(s, taps, axis_name: str, dim: int, *, mesh):
    """``erosion.sediment._disperse_axis`` on one block: the zero-padded
    correlation over a zero-border exchange, plus the edge folds on the
    blocks at the grid's border only.  Each cell's op order is the
    single-device one: bit-equal."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    if off > s.shape[dim]:
        raise ValueError(
            f"disperse kernel half-width {off} exceeds the shard block ({s.shape[dim]} cells "
            f"along {axis_name!r}); the edge folds would need neighbor-of-neighbor strips — "
            "use fewer shards or a smaller PILING_RADIUS")
    ext = exchange_axis(s, off, axis_name, dim, border="zero", mesh=mesh)
    ext = torch.movedim(ext, dim, -1)
    s_m = torch.movedim(s, dim, -1)
    n = s_m.shape[-1]
    out = None
    for i in range(k):
        piece = ext[..., i:i + n] * float(taps[k - 1 - i])
        out = piece if out is None else out + piece
    if off > 0:
        i0, size, _ = _axis(mesh, axis_name)
        t_lo = np.cumsum(taps)
        for j in range(off):
            w_lo = float(t_lo[off - j - 1])
            if i0 == 0:
                out[..., 0] = out[..., 0] + s_m[..., j] * w_lo
            if i0 == size - 1:
                out[..., n - 1] = out[..., n - 1] + s_m[..., n - 1 - j] * w_lo
    return torch.movedim(out, -1, dim)


def _disperse_2d(s, taps, mesh):
    return _disperse_axis_sharded(_disperse_axis_sharded(s, taps, "x", 0, mesh=mesh),
                                  taps, "y", 1, mesh=mesh)


def _write_sediment_exact_block(mesh, h, sed, params, height_scale, max_piles: int = 64):
    """``EXACT_PILES`` on this rank's blocks, without gathering the map:
    the ≤ K piles (the exact global top-K, then ascending index, as
    ``sediment.select_piles`` orders them) and their slot values (a masked
    sum: the owner gives each value, the others 0) form a table every rank
    holds; every rank solves it (``solve_pile_table``: K6's table entry on
    the card), then writes the effective commits on its own cells, in pile
    order."""
    thresh = params.PILE_THRESHOLD / height_scale
    radius = params.PILING_RADIUS
    t = _pile_tables(radius)
    dev = h.device
    off_r = torch.from_numpy(t["off_r"]).to(dev).long()
    off_c = torch.from_numpy(t["off_c"]).to(dev).long()
    lr, lc = h.shape
    row0, col0 = _origin(mesh, (lr, lc))
    res_r = lr * _axis(mesh, "x")[1]
    res_c = lc * _axis(mesh, "y")[1]

    disperse_part = torch.where(sed <= thresh, sed, 0.0)
    pile_part = torch.where(sed > thresh, sed, 0.0)
    new_h = h + _disperse_2d(disperse_part, KERNEL5, mesh)
    ok = (new_h >= 0.0) & (new_h <= 1.0)
    new_h = torch.where(ok, new_h, h)

    # 1. the piles: exact global top-K, then ascending index
    svols, sidx = _top_candidates(pile_part.reshape(-1), max_piles, lc, row0, col0, res_c,
                                  mesh)
    big = torch.full_like(sidx, res_r * res_c)
    order = torch.sort(torch.where(svols > 0.0, sidx, big), stable=True).indices
    vols, idxs = svols[order], sidx[order]

    # 2. each pile's slots and their values, from the ranks that own them
    rows = torch.div(idxs, res_c, rounding_mode="floor")[:, None] + off_r[None, :]
    cols = (idxs % res_c)[:, None] + off_c[None, :]
    valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
    cr = torch.clamp(rows, 0, res_r - 1)
    cc = torch.clamp(cols, 0, res_c - 1)
    owned = (cr >= row0) & (cr < row0 + lr) & (cc >= col0) & (cc < col0 + lc)
    local = torch.clamp(cr - row0, 0, lr - 1) * lc + torch.clamp(cc - col0, 0, lc - 1)
    vals0 = _psum(torch.where(owned, new_h.reshape(-1)[local], 0.0), mesh)

    # 3. the serial solve on the table, the same on every rank
    com_vals, com_eff = solve_pile_table(vals0, valid, vols, cr * res_c + cc,
                                         pile_increment(params, height_scale), radius)

    # 4. this rank's commits: the last pile to write a cell wins
    live = (com_eff & owned).reshape(-1)
    trash = lr * lc
    cells = torch.where(live, local.reshape(-1), trash)
    pos = torch.arange(cells.numel(), device=dev)
    last = torch.full((trash + 1,), -1, dtype=pos.dtype, device=dev)
    last.scatter_reduce_(0, cells, pos, "amax")
    keep = live & (last[cells] == pos)
    out = torch.cat([new_h.reshape(-1), new_h.new_zeros(1)])
    out[torch.where(keep, cells, trash)] = com_vals.reshape(-1)
    return out[:trash].reshape(lr, lc)


def _write_sediment_block(mesh, h, sed, params, height_scale):
    if params.EXACT_PILES:
        return _write_sediment_exact_block(mesh, h, sed, params, height_scale)
    thresh = params.PILE_THRESHOLD / height_scale
    disperse_part = torch.where(sed <= thresh, sed, 0.0)
    pile_part = torch.where(sed > thresh, sed, 0.0)
    # the pile deposit of an all-zero map is zero: running it on every
    # rank equals the single-device test of any(pile > 0)
    delta = (_disperse_2d(disperse_part, KERNEL5, mesh)
             + _disperse_2d(pile_part, _triangle_taps(params.PILING_RADIUS), mesh))
    new_h = h + delta
    ok = (new_h >= 0.0) & (new_h <= 1.0)
    return torch.where(ok, new_h, h)


def _sharded_write_sediment_exact(mesh, height, sed_acc, params, height_scale,
                                  max_piles: int = 64):
    """``EXACT_PILES`` over sharded blocks (``_write_sediment_exact_block``):
    bit-equal to the single-device solve, cross-border and chained
    overlaps included."""
    h, shape = _local_block(height, mesh)
    sed, _ = _local_block(sed_acc, mesh)
    return _as_field(_write_sediment_exact_block(mesh, h, sed, params, height_scale,
                                                 max_piles), mesh, shape)


def _sharded_write_sediment(mesh, height, sed_acc, params, height_scale):
    """``erosion.sediment.write_sediment_map`` over sharded blocks: the
    tent pile profile fully sharded, ``EXACT_PILES`` through the table
    solve."""
    h, shape = _local_block(height, mesh)
    sed, _ = _local_block(sed_acc, mesh)
    return _as_field(_write_sediment_block(mesh, h, sed, params, height_scale).contiguous(),
                     mesh, shape)


# --- pool automata -----------------------------------------------------------

#: water steps a K5 window call runs between two exchanges of the pool: all
#: of a cycle's at the default WATER_STEPS (10).  A step needs 8 cells of
#: halo, so a group of k steps exchanges once at 8k cells; what a step costs
#: is the exchange rounds and the call's host work, not the wider ring (each
#: step computes only the tiles that can still be exact): on four cards
#: (2×2 at 2048²) the sharded step ran faster at 10 steps a call than at 1
#: (PERF.md, scripts/sharded_cards.py --pool-group).
POOL_GROUP = 10


def _pool_block(mesh, h, p, res: int, iterations: int, drain_particles: bool):
    """``pool_automata`` on this rank's blocks: each group of up to
    ``POOL_GROUP`` water steps extends the pool 8 cells a step toward the
    neighbours (one exchange), runs the steps' phases on the window
    (``pool_automata_window``: K5 on the card, one call) with the block's
    running drains, and crops the block back."""
    group = max(1, min(POOL_GROUP, iterations))
    halo = 8 * group  # 2 cells of exactness a phase, 4 phases a step
    lr, lc = h.shape
    row0, col0 = _origin(mesh, (lr, lc))
    ext_h, top, left = _extend_2d(h, halo, mesh=mesh)
    core = (slice(top, top + lr), slice(left, left + lc))
    origin = (row0 - top, col0 - left)
    drains = torch.zeros_like(p)
    for done in range(0, iterations, group):
        ext_p, _, _ = _extend_2d(p, halo, mesh=mesh)
        ext_d = torch.zeros_like(ext_p)
        if done:
            ext_d[core] = drains
        ext_p, ext_d = pool_automata_window(ext_h, ext_p, ext_d, min(group, iterations - done),
                                            drain_particles, origin, res)
        p, drains = ext_p[core].contiguous(), ext_d[core].contiguous()
    return p, drains


def _sharded_pool_automata(mesh, height, pool, res: int, iterations: int,
                           drain_particles: bool):
    """``erosion.pool.pool_automata`` over sharded blocks, one exchange a
    group of water steps (``_pool_block``); bit-equal to the single-device
    op.
    Returns (pool, drains), sharded."""
    h, shape = _local_block(height, mesh)
    p, _ = _local_block(pool, mesh)
    p, drains = _pool_block(mesh, h, p, res, iterations, drain_particles)
    return _as_field(p, mesh, shape), _as_field(drains, mesh, shape)


# --- the cycle ---------------------------------------------------------------

def sharded_erosion_cycle(mesh, state: SimState, settings: ErosionSettings,
                          meta: TileSetMeta, chunk: int = 8, tuned=None) -> SimState:
    """One erosion cycle (``erosion.sim.erosion_cycle``) on a sharded world:
    every map of ``state`` a ``DTensor`` placed ``Shard(0)``, ``Shard(1)``
    (or the whole grid as a plain tensor, the same on every rank), the key
    replicated.  Every rank of the mesh calls it.  ``tuned``: the
    ``TUNABLE_FIELDS`` overrides, each rounded to float32 as in the
    single-device cycle."""
    from .sharded_ops import sharded_thermal_erosion

    params = settings.as_parameters()
    if tuned is not None:
        params = replace(params, **{k: float(np.float32(v)) for k, v in tuned.items()})
    res = meta.generator_res
    height_scale = float(meta.height)
    behavior = settings.BEHAVIOR
    blocks = {}
    for name in _WORLD:
        blocks[name], shape = _local_block(getattr(state.world, name), mesh)
    world = WorldState(**blocks)
    drain, _ = _local_block(state.drain_water, mesh)
    key = state.key

    if settings.ENABLE_THERMAL and behavior != ErosionMode.ONLY_FLOW_WATER:
        hw_ratio = float(meta.tile_size) / float(meta.height)
        height = sharded_thermal_erosion(mesh, _as_field(world.height, mesh, shape),
                                         settings.TALUS, settings.THERMAL_STEP, hw_ratio,
                                         iterations=settings.THERMAL_CYCLES)
        world = replace(world, height=height.to_local())

    track_acc = pool_acc = None
    if behavior != ErosionMode.ONLY_FLOW_WATER:
        k1, key = split(key)
        parts, drain = _spawn_block(mesh, drain, k1, settings.PARTICLES_PER_CYCLE, res)
        world = replace(world, pool=world.pool + drain)
        drain = torch.zeros_like(drain)
        _, track_acc, pool_acc, sed_acc = _descent_block(
            mesh, world, parts, params, height_scale, meta.patch_res, res, chunk)
        track_acc, pool_acc = track_acc.contiguous(), pool_acc.contiguous()
        world = replace(world, height=_write_sediment_block(mesh, world.height, sed_acc,
                                                            params, height_scale))

    # the deposit's adds and the decay: K12 on the card
    world = deposit_and_decay(world, track_acc, pool_acc, params, height_scale)
    pool, drains = _pool_block(mesh, world.height, world.pool, res, settings.WATER_STEPS,
                               behavior != ErosionMode.ONLY_FLOW_WATER)
    world = replace(world, pool=pool)
    field = {name: _as_field(getattr(world, name).contiguous(), mesh, shape)
             for name in _WORLD}
    return SimState(world=WorldState(**field),
                    drain_water=_as_field((drain + drains).contiguous(), mesh, shape),
                    key=key)


def sharded_tile_step(mesh, meta: TileSetMeta, settings: ErosionSettings, xpos, zpos, key,
                      *, noise_type: str = "Simplex", octaves: int = 13, hurst: float = 0.4,
                      noise_size: float = 1700.0, blur_width: int = 5,
                      blur_sigma: float = 1.0, blur_iterations: int = 17,
                      flow_iterations: int = 8, erosion_cycles: int = None, chunk: int = 8,
                      emit_mesh: bool = False, mesh_layout: str = "arrays"):
    """The flagship tile step (``app.flagship.make_tile_step``) on one grid
    sharded over the mesh: ``sharded_fractal`` → ``sharded_gauss_blur`` (K1)
    → ``sharded_flow_map`` (K2) → the erosion cycles (K3, the descent, K6's
    table with ``EXACT_PILES``, K5 windows).  Returns (final ``SimState``,
    flow velocity) and, with ``emit_mesh``, the sharded mesh fields; all
    sharded.  ``key``: the port's threefry key (``prng.PRNGKey``)."""
    from .sharded_ops import sharded_flow_map, sharded_fractal, sharded_gauss_blur

    res = meta.generator_res
    cycles = settings.CYCLES if erosion_cycles is None else erosion_cycles
    h = sharded_fractal(mesh, res, xpos, zpos, noise_type=noise_type, octaves=octaves,
                        hurst=hurst, noise_size=noise_size)
    h = sharded_gauss_blur(mesh, h, blur_width, blur_sigma, iterations=blur_iterations)
    flow_v = sharded_flow_map(mesh, h, iterations=flow_iterations)
    state = init_state(h, key.to(_mesh_device(mesh)))
    for _ in range(cycles):
        state = sharded_erosion_cycle(mesh, state, settings, meta, chunk=chunk)
    if emit_mesh:
        from .sharded_mesh import sharded_heightmap_mesh

        fields = sharded_heightmap_mesh(mesh, state.world.height, meta.tile_res, res,
                                        float(meta.height), float(meta.tile_size),
                                        layout=mesh_layout)
        return state, flow_v, fields
    return state, flow_v


def make_sharded_tile_step(mesh, meta: TileSetMeta, settings: ErosionSettings = None,
                           **kwargs):
    """The sharded flagship step: (xpos, zpos, key) → ``sharded_tile_step``'s
    outputs, ``app.flagship.make_tile_step``'s sp counterpart; ``kwargs``
    pass through.  Returns (step, meta, settings)."""
    settings = settings or ErosionSettings()

    def step(xpos, zpos, key):
        return sharded_tile_step(mesh, meta, settings, xpos, zpos, key, **kwargs)

    return step, meta, settings


class ShardedErosionSim(_ErosionSimBase):
    """``ErosionSim``'s surface (step, trigger and update, map views,
    curvature, resets) for a world sharded over ``mesh``: the maps are
    ``DTensor``s placed ``Shard(0)``, ``Shard(1)``, the key replicated.
    Only the cycles (``_run_cycles``) and the persistence differ.

    Every rank of the mesh builds the sim with the same arguments and
    drives it in step.  Each rank addresses only its own blocks, so with
    more than one rank (``dist.get_world_size() > 1``) the checkpoint is
    per shard (``parallel.sharded_checkpoint``, next to the store's save
    root), where the reference switches on ``jax.process_count() > 1``;
    with one rank it goes through the store, as ``ErosionSim``'s does."""

    def __init__(self, mesh, height, settings: ErosionSettings = None,
                 meta: TileSetMeta = None, seed: int = 0, chunk: int = 8,
                 state_manager=None, tile_pos=(0, 0)):
        self.mesh = mesh
        self.chunk = chunk
        self.settings = settings or ErosionSettings()
        self.state_manager = state_manager
        self.tile_pos = tuple(tile_pos)
        res = int(height.shape[0])
        self.meta = meta or TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                                        height=1000, margin=0)
        self.original_height = self._field(height)
        self.state = init_state(self.original_height,
                                PRNGKey(seed, device=_mesh_device(mesh)))
        self.cycle_count = 0
        self.syncs: list = []
        self._job = None

    def _field(self, data):
        """``data`` (a NumPy array, a tensor holding the whole grid, or a
        field ``DTensor``) as this mesh's field."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.array(data, np.float32))
        block, shape = _local_block(data.to(_F32), self.mesh)
        return _as_field(block, self.mesh, shape)

    def _run_cycles(self, n: int):
        """``n`` sharded cycles with the current settings, retuned live as
        the single-device sim's are."""
        self.syncs = []
        for _ in range(n):
            self.state = sharded_erosion_cycle(self.mesh, self.state,
                                               self.settings.canonical(), self.meta,
                                               chunk=self.chunk,
                                               tuned=self.settings.tunable_values())
            self.cycle_count += 1

    def step(self, cycles: Optional[int] = None):
        """Run CYCLES sharded cycles (the single-device sim's ``fresh``
        spawn hook has no sharded counterpart)."""
        self._run_cycles(self.settings.CYCLES if cycles is None else cycles)
        return self.state

    def curvature(self):
        from ..erosion.world import curvature_map

        height = self.state.world.height.full_tensor()
        return curvature_map(height, float(self.meta.height), self.meta.patch_res)

    def mesh_fields(self, variant: str = "overshoot", layout: str = "arrays"):
        """Per-vertex mesh channels of the current height, sharded like the
        world (``parallel.sharded_mesh.sharded_heightmap_mesh``)."""
        from .sharded_mesh import sharded_heightmap_mesh

        return sharded_heightmap_mesh(
            self.mesh, self.state.world.height, self.meta.tile_res, self.meta.generator_res,
            float(self.meta.height), float(self.meta.tile_size), variant=variant,
            layout=layout)

    # --- persistence ------------------------------------------------------

    # height, stream and pool as the reference's LiveErosion saves them, and
    # the track, plants and drain queue too, so a resumed sim is bit-exact
    _SAVE_ALIASES = (
        ("TERRAIN_HEIGHT", ("world", "height")),
        ("PARTERO_WATERMAP_STREAM", ("world", "flow")),
        ("PARTERO_WATERMAP_POOL", ("world", "pool")),
        ("PARTERO_WATERMAP_TRACK", ("world", "track")),
        ("PARTERO_PLANTMAP", ("world", "plants")),
        ("PARTERO_DRAIN_QUEUE", ("drain_water",)),
    )

    def _buffer_name(self, alias: str) -> str:
        return self.meta.buffer_name(self.tile_pos, alias)

    def _state_arrays(self):
        for alias, path in self._SAVE_ALIASES:
            obj = self.state
            for attr in path:
                obj = getattr(obj, attr)
            yield alias, path, obj

    def _sharded_ckpt(self):
        from .sharded_checkpoint import ShardedCheckpoint

        sm = self.state_manager
        if sm is None or sm.serde is None:
            raise RuntimeError("no state manager with a save path attached")
        return ShardedCheckpoint(sm.serde.root)

    @staticmethod
    def _per_shard() -> bool:
        return dist.is_initialized() and dist.get_world_size() > 1

    def save_erosion_state(self):
        """Checkpoint the whole sim state: through the store with one rank,
        per shard (each rank its own blocks, no gather) with more."""
        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        self.original_height = self.state.world.height
        if self._per_shard():
            ckpt = self._sharded_ckpt()
            for alias, _, arr in self._state_arrays():
                ckpt.save(self._buffer_name(alias), arr)
            ckpt.flush()
            return
        sm = self.state_manager
        for alias, _, arr in self._state_arrays():
            name = self._buffer_name(alias)
            sm.set_buffer(name, arr.full_tensor())
            sm.save_buffer_to_disk(name)

    def restore_erosion_state(self):
        """Rebuild the state from the checkpoint, every map placed on the
        mesh; the sim resumes bit-exact.  The PRNG key is not saved (the
        reference's stream restarts); set ``sim.state.key`` to continue
        one."""
        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        if self._per_shard():
            ckpt = self._sharded_ckpt()
            maps = {alias: ckpt.load(self._buffer_name(alias), self.mesh)
                    for alias, _ in self._SAVE_ALIASES}
            missing = [a for a, v in maps.items() if v is None]
            if missing:
                raise IOError(f"sharded checkpoint missing maps: {missing}")
        else:
            sm = self.state_manager
            maps = {alias: self._field(sm.get_buffer(self._buffer_name(alias)))
                    for alias, _ in self._SAVE_ALIASES}
        self.original_height = maps["TERRAIN_HEIGHT"]
        self.state = SimState(
            world=WorldState(height=maps["TERRAIN_HEIGHT"],
                             pool=maps["PARTERO_WATERMAP_POOL"],
                             flow=maps["PARTERO_WATERMAP_STREAM"],
                             track=maps["PARTERO_WATERMAP_TRACK"],
                             plants=maps["PARTERO_PLANTMAP"]),
            drain_water=maps["PARTERO_DRAIN_QUEUE"], key=self.state.key)
