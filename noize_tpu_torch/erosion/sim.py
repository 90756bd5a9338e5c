"""Live erosion — port of ``noize_tpu.erosion.sim``: one erosion cycle
(``erosion_cycle``), the loop of cycles all its callers share
(``erosion_cycles``) and the per-tile live simulation (``ErosionSim``).

  thermal erosion (kernel K3 on the card)
  → spawn particles (queued drain particles first, then fresh ones)
  → simultaneous descent (scatter-add events)
  → per-cell event reduce: pool/track placement multipliers
  → sediment write-back (disperse / pile deposit + [0,1] breaker; kernel
    K11 on the card)
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
list as ``syncs`` to have each one recorded.  On the card
``erosion_cycles`` replays a dry cycle's device work between those syncs as
CUDA graphs (``erosion.graphs``); ``erosion_cycle`` is the eager cycle.

Spans (``utils.tracking``): ``erosion.cycle`` around a cycle, and in an
eager one one span a phase: ``erosion.thermal``, ``erosion.spawn``,
``erosion.descent``, ``erosion.deposit``, ``erosion.flow``,
``erosion.pool``; each host sync is the span ``sync.<site>`` inside its
phase (a graph cycle's: inside ``erosion.cycle`` and ``erosion.graph``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.tiles import TileSetMeta
from ..ops.cuda.thermal import thermal_erosion_fused
from .params import ErosionMode, ErosionSettings
from ..prng import PRNGKey, split
from ..utils.tracking import StandAloneJobHandler, span, sync_bool
from .particles import Particles, descend_all, spawn
from .pool_cuda import pool_automata_cuda
from .sediment import write_sediment_map
from .world import WorldState, curvature_map, update_flow_from_track


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


def _draw(key, n: int, res: int, fresh: Optional[Particles] = None):
    """The spawn's particles from the first half of ``key`` (or ``fresh``),
    and the second half of ``key``."""
    k1, k2 = split(key)
    if fresh is None:
        fresh = spawn(k1, n, res)
    return fresh, k2


def _drains_flag(drain_water):
    """Whether any drain water is queued: the device bool the
    ``spawn.drains`` host sync reads."""
    return (drain_water.reshape(-1) > 0.0).any()


def _spawn_with_drains(key, n: int, res: int, drain_water, *,
                       fresh: Optional[Particles] = None, syncs: list = None,
                       wet: Optional[bool] = None):
    """Fill the particle buffer: drain particles first (top-K wettest
    drain cells), particles spawned from the first half of ``key`` (or
    ``fresh``) in the remaining slots.  Returns (particles, leftover drain
    water, the second half of ``key``), as the reference does.  ``wet``:
    the ``spawn.drains`` sync's answer when the caller has read it already."""
    fresh, k2 = _draw(key, n, res, fresh)
    if wet is None:
        wet = sync_bool("spawn.drains", _drains_flag(drain_water), syncs)
    if not wet:
        return fresh, drain_water, k2
    flat = drain_water.reshape(-1)
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


# --- the cycle's phases, shared by the eager cycle and its CUDA graphs
# (``erosion.graphs``) -------------------------------------------------------

def cycle_parameters(settings: ErosionSettings, tuned: Optional[dict] = None):
    """The cycle's ``ErosionParameters``: the settings', with ``tuned``'s
    values rounded to float32 as the reference's traced scalars are."""
    params = settings.as_parameters()
    if tuned is not None:
        params = replace(params, **{k: float(np.float32(v)) for k, v in tuned.items()})
    return params


def spawns(settings: ErosionSettings) -> bool:
    """The cycle spawns particles (and syncs twice): every mode but
    ONLY_FLOW_WATER."""
    return settings.BEHAVIOR != ErosionMode.ONLY_FLOW_WATER


def _thermal_on(settings: ErosionSettings) -> bool:
    return settings.ENABLE_THERMAL and spawns(settings)


def _thermal(world: WorldState, settings: ErosionSettings, meta: TileSetMeta):
    hw_ratio = float(meta.tile_size) / float(meta.height)
    return replace(world, height=thermal_erosion_fused(
        world.height, settings.TALUS, settings.THERMAL_STEP, hw_ratio,
        iterations=settings.THERMAL_CYCLES))


def _release_drains(world: WorldState, drain_water):
    """Unconverted drain water re-enters the pool map."""
    return replace(world, pool=world.pool + drain_water), torch.zeros_like(drain_water)


def _descend(parts, world: WorldState, params, meta: TileSetMeta, syncs=None):
    """(track_acc, pool_acc, sed_acc) of the particles' descent."""
    _, track_acc, pool_acc, sed_acc = descend_all(
        parts, world, params, float(meta.height), meta.patch_res, meta.generator_res,
        syncs=syncs)
    return track_acc, pool_acc, sed_acc


def _deposit(world: WorldState, track_acc, pool_acc, params):
    return replace(
        world,
        pool=world.pool + pool_acc * params.POOL_PLACEMENT_MULTIPLIER,
        track=world.track + track_acc * params.TRACK_PLACEMENT_MULTIPLIER,
    )


def _pool(world: WorldState, drain_water, settings: ErosionSettings, out=None):
    """The pool automata, and the drains added to ``drain_water``; ``out``:
    (pool, drain water) maps on the card to write them into."""
    pool_out, drain_out = (None, None) if out is None else out
    pool, drains = pool_automata_cuda(world.height, world.pool, settings.WATER_STEPS,
                                      spawns(settings), out=pool_out)
    return replace(world, pool=pool), torch.add(drain_water, drains, out=drain_out)


def erosion_cycle(state: SimState, settings: ErosionSettings, meta: TileSetMeta,
                  tuned: Optional[dict] = None, *, fresh: Optional[Particles] = None,
                  syncs: list = None) -> SimState:
    """One full cycle of TriggerQueuedBeyerMT's inner loop, every operation
    enqueued from Python (the eager cycle; ``erosion_cycles`` runs many).

    ``tuned``: optional dict of ``params.TUNABLE_FIELDS`` values that
    override the settings' (the live-retuning hook; each value is rounded
    to float32 as the reference's traced scalars are).
    ``fresh``: particles that replace the cycle's random spawn (drain
    particles still take the first slots; the key advances as without
    them) — a test hook.
    ``syncs``: a list that records the cycle's host syncs."""
    with span("erosion.cycle"):
        return _cycle(state, settings, meta, tuned, fresh, syncs)


def _cycle(state: SimState, settings: ErosionSettings, meta: TileSetMeta, tuned, fresh,
           syncs, wet: Optional[bool] = None) -> SimState:
    params = cycle_parameters(settings, tuned)
    height_scale = float(meta.height)
    world = state.world
    if _thermal_on(settings):
        with span("erosion.thermal"):
            world = _thermal(world, settings, meta)

    drain_water = state.drain_water
    key = state.key
    if spawns(settings):
        with span("erosion.spawn"):
            parts, drain_water, key = _spawn_with_drains(
                key, settings.PARTICLES_PER_CYCLE, meta.generator_res, drain_water,
                fresh=fresh, syncs=syncs, wet=wet)
            world, drain_water = _release_drains(world, drain_water)

        with span("erosion.descent"):
            track_acc, pool_acc, sed_acc = _descend(parts, world, params, meta, syncs)

        with span("erosion.deposit"):
            world = _deposit(world, track_acc, pool_acc, params)
            world = replace(world, height=write_sediment_map(
                world.height, sed_acc, params, height_scale, syncs=syncs))

    with span("erosion.flow"):
        world = update_flow_from_track(world, params, height_scale)

    with span("erosion.pool"):
        world, drain_water = _pool(world, drain_water, settings)
    return SimState(world=world, drain_water=drain_water, key=key)


def erosion_cycles(state: SimState, settings: ErosionSettings, meta: TileSetMeta, n: int, *,
                   tuned: Optional[dict] = None,
                   fresh: Optional[Sequence[Particles]] = None, syncs: list = None,
                   graphs=None) -> SimState:
    """``n`` erosion cycles from ``state``: the one loop of
    ``ErosionSim.step``/``trigger``, the flagship step and ``tile_batch``.

    ``tuned`` and ``syncs`` as ``erosion_cycle``'s; ``fresh``: None, or one
    ``Particles`` a cycle (the test hook).  Where ``graphs.graph_eligible``
    holds (a CUDA state, no ``fresh``, no ``EXACT_PILES``) the cycles go to
    ``graphs`` (an ``erosion.graphs.CycleGraphs``; None: the process's
    shared one), which replays each dry cycle's device work as CUDA graphs
    between its two host syncs, bit-equal to ``erosion_cycle``; every other
    cycle runs ``erosion_cycle``.  The state returned shares no tensor with
    the graphs' buffers, so no later call writes it.

    Counters: ``erosion_cycles.captures`` (graphs captured),
    ``.replays`` (cycles replayed as graphs), ``.eager_cycles`` (cycles on
    CUDA run by ``erosion_cycle``)."""
    from . import graphs as _graphs

    if _graphs.graph_eligible(state, settings, fresh):
        runner = _graphs.SHARED if graphs is None else graphs
        return runner.run(state, settings, meta, n, tuned, syncs)
    for c in range(n):
        state = erosion_cycle(state, settings, meta, tuned,
                              fresh=None if fresh is None else fresh[c], syncs=syncs)
    if state.world.height.device.type == "cuda":
        erosion_cycles.eager_cycles += n
    return state


erosion_cycles.captures = 0
erosion_cycles.replays = 0
erosion_cycles.eager_cycles = 0


class ErosionSim:
    """Host driver with the LiveErosion component surface (reset, step,
    save — LiveErosion.cs:203-372).

    The sim lives on ``height``'s device; a NumPy height goes to
    ``device`` (the card by default — no GPU raises).  The particle spawn
    draws from ``PRNGKey(seed)``, as the reference's does."""

    def __init__(self, height, settings: Optional[ErosionSettings] = None,
                 meta: Optional[TileSetMeta] = None, state_manager=None,
                 tile_pos=(0, 0), seed: int = 0, *, device="cuda"):
        self.settings = settings or ErosionSettings()
        res = int(height.shape[0])
        self.meta = meta or TileSetMeta(
            tile_res=res, tile_size=res, generator_res=res, height=1000, margin=0)
        self.state_manager = state_manager
        self.tile_pos = tuple(tile_pos)
        if isinstance(height, torch.Tensor):
            height = height.to(torch.float32)
        else:
            device = torch.device(device)
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("ErosionSim(device='cuda'): no CUDA device")
            height = torch.from_numpy(np.array(height, np.float32)).to(device)
        self.original_height = height
        self.state = init_state(self.original_height,
                                PRNGKey(seed, device=height.device))
        self.cycle_count = 0
        #: host syncs of the last ``step`` or ``trigger``
        self.syncs: list = []
        self._job: Optional[StandAloneJobHandler] = None
        from .graphs import CycleGraphs

        #: this sim's captured cycles (``erosion.graphs``)
        self._graphs = CycleGraphs()

    # --- map views (LiveErosion MapType, :118-154) --------------------------

    @property
    def height_map(self):
        return self.state.world.height

    @property
    def pool_map(self):
        return self.state.world.pool

    @property
    def stream_map(self):
        return self.state.world.flow

    @property
    def plant_map(self):
        return self.state.world.plants

    def curvature(self):
        return curvature_map(self.state.world.height, float(self.meta.height),
                             self.meta.patch_res)

    # --- stepping -----------------------------------------------------------

    def _run_cycles(self, n: int, fresh: Optional[Sequence[Particles]] = None):
        """``n`` erosion cycles with the current settings (retuned live
        between steps), their tunables rounded to float32 as the
        reference's traced scalars are."""
        self.syncs = []
        self.state = erosion_cycles(
            self.state, self.settings, self.meta, n, tuned=self.settings.tunable_values(),
            fresh=fresh, syncs=self.syncs, graphs=self._graphs)
        self.cycle_count += n

    def step(self, cycles: Optional[int] = None, *,
             fresh: Optional[Sequence[Particles]] = None):
        """Run CYCLES erosion cycles.  ``fresh``: optional list with one
        ``Particles`` per cycle replacing that cycle's random spawn (the
        test hook ``make_tile_step`` has too)."""
        n = self.settings.CYCLES if cycles is None else cycles
        with span("sim.step"):
            self._run_cycles(n, fresh)
        return self.state

    # --- continuous mode (LiveErosion.updateContinuous, :363-370) -----------

    def trigger(self):
        """Start one CYCLES batch; returns False while one is in flight
        (TriggerQueuedBeyerMT + erosionJobCtl.TrackJob).  A CUDA event
        recorded after the batch's work tracks it.

        Unlike the reference, whose dispatch returns at once, the eager
        port blocks here on each cycle's host syncs (``syncs``; h100bench's
        ``erosion.syncs_per_cycle.step`` counts them a cycle) and returns
        when the last cycle's work is enqueued; ``update`` then reports the
        states the reference reports for the same calls."""
        if self._job is None:
            self._job = StandAloneJobHandler()
        if self._job.is_running:
            return False
        self._run_cycles(self.settings.CYCLES)
        self._job.track_job(self.state)
        return True

    def update(self, continuous: bool = True):
        """One frame tick: complete a finished batch and (in continuous
        mode) trigger the next — the LiveErosion.Update state machine:
        "running", "completed", "triggered" or "idle"."""
        job = self._job
        if job is not None and job.is_running:
            if not job.job_complete():
                return "running"
            job.close_job()
            return "completed"
        if continuous:
            self.trigger()
            return "triggered"
        return "idle"

    # --- resets (LiveErosion.cs:267-294) ------------------------------------

    def reset_land(self):
        self.state = init_state(self.original_height, self.state.key)

    def reset_water(self):
        w = self.state.world
        z = torch.zeros_like(w.pool)
        self.state = replace(
            self.state, world=replace(w, pool=z, flow=z, track=z),
            drain_water=torch.zeros_like(self.state.drain_water))

    # --- persistence (SaveErosionState, LiveErosion.cs:111-116) -------------

    def _buffer_name(self, alias: str) -> str:
        return self.meta.buffer_name(self.tile_pos, alias)

    def save_erosion_state(self):
        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        self.original_height = self.state.world.height
        sm = self.state_manager
        sm.set_buffer(self._buffer_name("TERRAIN_HEIGHT"), self.state.world.height)
        sm.set_buffer(self._buffer_name("PARTERO_WATERMAP_STREAM"), self.state.world.flow)
        sm.set_buffer(self._buffer_name("PARTERO_WATERMAP_POOL"), self.state.world.pool)
        for alias in ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL"):
            sm.save_buffer_to_disk(self._buffer_name(alias))
