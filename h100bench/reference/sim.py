"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.erosion.sim``'s
erosion cycle (``erosion_cycle``) on the plain versions (thermal, pool).

  thermal erosion (kernel K3 on the card)
  → spawn particles (queued drain particles first, then fresh ones)
  → simultaneous descent (scatter-add events)
  → per-cell event reduce: pool/track placement multipliers
  → sediment write-back (disperse / pile deposit + [0,1] breaker)
  → track→flow decay + pool surface evaporation
  → pool automata (kernel K4 on the card, K5 on odd grids), emitting
    drain water

Drain water accumulates in a map; the next cycle's spawn converts the
top-K wettest drain cells into particles (K = particle slots, ties to the
lower flat index as ``lax.top_k`` gives them) and returns the rest to the
pool map.

Host syncs: unlike the reference, whose gates are device-side
``lax.cond``/``while_loop``, the eager port reads a few flags on the host
each cycle (drains present, descent chunks alive, piles present).  Pass a
list as ``syncs`` to have each one recorded.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .tiles import TileSetMeta
from .thermal import thermal_erosion
from .params import ErosionMode, ErosionSettings
from .prng import PRNGKey, split
from .particles import Particles, descend_all, spawn
from .pool import pool_automata
from .sediment import write_sediment_map
from .world import WorldState, update_flow_from_track


@dataclass
class SimState:
    """Sim state carried across cycles."""

    world: WorldState
    drain_water: torch.Tensor        # f32[R,R] — queued drain emissions
    key: torch.Tensor                # threefry key (``prng.PRNGKey``)


def init_state(height, key=None) -> SimState:
    """The state a sim starts from; ``key=None`` is ``PRNGKey(0)`` on the
    height's device."""
    if key is None:
        key = PRNGKey(0, device=height.device)
    return SimState(
        world=WorldState.create(height),
        drain_water=torch.zeros_like(height),
        key=key,
    )


def _spawn_with_drains(key, n: int, res: int, drain_water, *,
                       fresh: Optional[Particles] = None, syncs: list = None):
    """Fill the particle buffer: drain particles first (top-K wettest
    drain cells), particles spawned from the first half of ``key`` (or
    ``fresh``) in the remaining slots.  Returns (particles, leftover drain
    water, the second half of ``key``), as the reference does."""
    k1, k2 = split(key)
    if fresh is None:
        fresh = spawn(k1, n, res)
    flat = drain_water.reshape(-1)
    if syncs is not None:
        syncs.append("spawn.drains")
    if not bool((flat > 0.0).any()):
        return fresh, drain_water, k2
    # exact top-k with ties to the lower index: a stable ascending sort of
    # -flat keeps equal values in index order
    neg, idxs = torch.sort(-flat, stable=True)
    vals = -neg[:n]
    idxs = idxs[:n]
    has_drain = vals > 0.0
    rows = torch.div(idxs, res, rounding_mode="floor").to(torch.float32)
    cols = (idxs % res).to(torch.float32)
    parts = fresh._replace(
        row=torch.where(has_drain, rows, fresh.row),
        col=torch.where(has_drain, cols, fresh.col),
        water=torch.where(has_drain, vals, fresh.water),
    )
    taken = torch.zeros_like(flat).index_put_(
        (idxs,), torch.where(has_drain, vals, 0.0), accumulate=True)
    leftover = torch.clamp_min(flat - taken, 0.0)
    return parts, leftover.reshape(drain_water.shape), k2


def erosion_cycle(state: SimState, settings: ErosionSettings, meta: TileSetMeta,
                  tuned: Optional[dict] = None, *, fresh: Optional[Particles] = None,
                  syncs: list = None) -> SimState:
    """One full cycle of TriggerQueuedBeyerMT's inner loop.

    ``tuned``: optional dict of ``params.TUNABLE_FIELDS`` values that
    override the settings' (the live-retuning hook; each value is rounded
    to float32 as the reference's traced scalars are).
    ``fresh``: particles that replace the cycle's random spawn (drain
    particles still take the first slots; the key advances as without
    them) — a test hook.
    ``syncs``: a list that records the cycle's host syncs."""
    params = settings.as_parameters()
    if tuned is not None:
        params = replace(params, **{k: float(np.float32(v)) for k, v in tuned.items()})
    res = meta.generator_res
    height_scale = float(meta.height)
    patch_res = meta.patch_res
    world = state.world
    behavior = settings.BEHAVIOR

    if settings.ENABLE_THERMAL and behavior != ErosionMode.ONLY_FLOW_WATER:
        hw_ratio = float(meta.tile_size) / float(meta.height)
        world = replace(world, height=thermal_erosion(
            world.height, settings.TALUS, settings.THERMAL_STEP, hw_ratio,
            iterations=settings.THERMAL_CYCLES))

    drain_water = state.drain_water
    key = state.key
    if behavior != ErosionMode.ONLY_FLOW_WATER:
        parts, drain_water, key = _spawn_with_drains(
            key, settings.PARTICLES_PER_CYCLE, res, drain_water,
            fresh=fresh, syncs=syncs)
        # unconverted drain water re-enters the pool map
        world = replace(world, pool=world.pool + drain_water)
        drain_water = torch.zeros_like(drain_water)

        _, track_acc, pool_acc, sed_acc = descend_all(
            parts, world, params, height_scale, patch_res, res, syncs=syncs)

        world = replace(
            world,
            pool=world.pool + pool_acc * params.POOL_PLACEMENT_MULTIPLIER,
            track=world.track + track_acc * params.TRACK_PLACEMENT_MULTIPLIER,
        )
        world = replace(world, height=write_sediment_map(
            world.height, sed_acc, params, height_scale, syncs=syncs))

    world = update_flow_from_track(world, params, height_scale)

    pool, drains = pool_automata(
        world.height, world.pool, settings.WATER_STEPS,
        behavior != ErosionMode.ONLY_FLOW_WATER)
    world = replace(world, pool=pool)
    return SimState(world=world, drain_water=drain_water + drains, key=key)
