"""Live erosion — port of ``noize_tpu.erosion.sim``: one erosion cycle
(``erosion_cycle``), the loop of cycles all its callers share
(``erosion_cycles``) and the per-tile live simulation (``ErosionSim``).

A cycle is written once, as two halves around its two host syncs (the
reference's gates are device-side ``lax.cond``; the port reads them on the
host):

  ``spawn.drains`` sync: is drain water queued (``drains_flag``)?
  front half (``cycle_front``)
    thermal erosion (kernel K3 on the card)
    → spawn particles (with drain water: the top-K wettest drain cells
      first, K = particle slots, ties to the lower flat index as
      ``lax.top_k`` gives them; fresh ones in the other slots), the rest
      of the drain water back into the pool map
    → simultaneous descent (scatter-add events)
    → the piles flag (``sediment.piles_flag``)
  ``sediment.piles`` sync: does a cell pile?
  back half (``cycle_back``)
    sediment write-back (disperse, the pile tent when a cell piles, the
      [0,1] breaker: kernel K11 on the card; ``sediment.write_sediment_piles``)
    → the deposit's pool and track adds, the track→flow decay and the pool
      surface evaporation (kernel K12 on the card;
      ``world.deposit_and_decay``)
    → pool automata (kernel K4 on the card, K5 on odd grids), emitting
      drain water for the next cycle

``drive_cycle`` takes the two syncs between the halves.  ``erosion_cycle``
hands it the halves; on the card ``erosion_cycles`` hands it replays of
them captured as CUDA graphs (``erosion.graphs``).  ONLY_FLOW_WATER
neither spawns nor syncs: its cycle is the back half's flow update and
pool automata.  Pass a list as ``syncs`` to have each host sync recorded.

Spans (``utils.tracking``): ``erosion.cycle`` around a cycle, with the
syncs (``sync.<site>``) in it; inside the halves one span a phase,
``erosion.thermal``, ``erosion.spawn``, ``erosion.descent``,
``erosion.deposit`` (the front half's piles flag and the back half's
write-back), ``erosion.flow`` (the deposit's adds and the decay),
``erosion.pool``.  A replayed half records
none.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.tiles import TileSetMeta
from ..ops.cuda.thermal import thermal_erosion_fused
from .params import ErosionMode, ErosionSettings
from ..prng import PRNGKey, split
from ..utils.tracking import StandAloneJobHandler, span, sync_bool
from .particles import Particles, descend_all, spawn
from .pool_cuda import pool_automata_cuda
from .sediment import piles_flag, write_sediment_piles
from .world import WorldState, curvature_map, deposit_and_decay


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


def drains_flag(drain_water):
    """Whether any drain water is queued: the device bool the
    ``spawn.drains`` host sync reads."""
    return (drain_water.reshape(-1) > 0.0).any()


def _spawn_with_drains(key, n: int, res: int, drain_water, *,
                       fresh: Optional[Particles] = None, wet: bool = True):
    """Fill the particle buffer: drain particles first (top-K wettest
    drain cells), particles spawned from the first half of ``key`` (or
    ``fresh``) in the remaining slots.  Returns (particles, leftover drain
    water, the second half of ``key``), as the reference does.  ``wet``:
    the ``spawn.drains`` sync's answer; False skips the drain particles,
    which without drain water change nothing."""
    k1, k2 = split(key)
    if fresh is None:
        fresh = spawn(k1, n, res)
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


# --- the cycle: two halves and the driver of the syncs between them ---------

class Front(NamedTuple):
    """What the front half hands the back half.  The descent's accumulators
    (``track_acc``, ``pool_acc``, ``sed_acc``) and ``flag`` (the piles flag)
    are None where the cycle does not spawn."""

    world: WorldState
    drain_water: torch.Tensor
    key: torch.Tensor
    track_acc: Optional[torch.Tensor]
    pool_acc: Optional[torch.Tensor]
    sed_acc: Optional[torch.Tensor]
    flag: Optional[torch.Tensor]


def cycle_front(state: SimState, settings: ErosionSettings, meta: TileSetMeta, params,
                wet: bool, *, fresh: Optional[Particles] = None, syncs: list = None) -> Front:
    """The cycle's front half from ``state``, ``wet`` the ``spawn.drains``
    sync's answer: thermal, the spawn, the drain release, the descent and
    the piles flag.  A cycle that does not spawn hands ``state`` on."""
    if not spawns(settings):
        return Front(state.world, state.drain_water, state.key, None, None, None, None)
    height_scale = float(meta.height)
    world = state.world
    if settings.ENABLE_THERMAL:
        with span("erosion.thermal"):
            world = replace(world, height=thermal_erosion_fused(
                world.height, settings.TALUS, settings.THERMAL_STEP,
                float(meta.tile_size) / height_scale, iterations=settings.THERMAL_CYCLES))
    with span("erosion.spawn"):
        parts, drain_water, key = _spawn_with_drains(
            state.key, settings.PARTICLES_PER_CYCLE, meta.generator_res, state.drain_water,
            fresh=fresh, wet=wet)
        # unconverted drain water re-enters the pool map
        world = replace(world, pool=world.pool + drain_water)
        drain_water = torch.zeros_like(drain_water)
    with span("erosion.descent"):
        _, track_acc, pool_acc, sed_acc = descend_all(
            parts, world, params, height_scale, meta.patch_res, meta.generator_res,
            syncs=syncs)
    with span("erosion.deposit"):
        flag = piles_flag(sed_acc, params, height_scale)
    return Front(world, drain_water, key, track_acc, pool_acc, sed_acc, flag)


def cycle_back(front: Front, settings: ErosionSettings, meta: TileSetMeta, params,
               piles: bool, *, out: Optional[SimState] = None) -> SimState:
    """The cycle's back half from the front half's ``front``, ``piles`` the
    ``sediment.piles`` sync's answer: the sediment write-back, the
    deposit's adds and the flow update, and the pool automata.  ``out``: the
    static state of ``erosion.graphs`` to write the height, the flow, the
    track, the pool and the drain water into (None: new maps)."""
    height_scale = float(meta.height)
    world = front.world
    if front.sed_acc is not None:
        with span("erosion.deposit"):
            # the write-back cannot write the map it reads: without thermal
            # that is out's
            into = None if out is None or world.height is out.world.height \
                else out.world.height
            world = replace(world, height=write_sediment_piles(
                world.height, front.sed_acc, params, height_scale, piles, out=into))
    with span("erosion.flow"):
        world = deposit_and_decay(world, front.track_acc, front.pool_acc, params, height_scale,
                                  out=None if out is None else out.world)
    with span("erosion.pool"):
        pool, drains = pool_automata_cuda(world.height, world.pool, settings.WATER_STEPS,
                                          spawns(settings),
                                          out=None if out is None else out.world.pool)
        drain_water = torch.add(front.drain_water, drains,
                                out=None if out is None else out.drain_water)
    return SimState(world=replace(world, pool=pool), drain_water=drain_water, key=front.key)


def drive_cycle(spawning: bool, drains: Callable, front: Callable, back: Callable,
                syncs: list = None):
    """One cycle in the span ``erosion.cycle``: the ``spawn.drains`` sync
    reads ``drains()``, ``front(wet)`` runs the front half, the
    ``sediment.piles`` sync reads its flag and ``back(front, piles)`` runs
    the back half.  ``erosion_cycle`` hands in the halves,
    ``erosion.graphs`` their replays.  A cycle that does not spawn syncs
    neither."""
    with span("erosion.cycle"):
        wet = spawning and sync_bool("spawn.drains", drains(), syncs)
        half = front(wet)
        piles = spawning and sync_bool("sediment.piles", half.flag, syncs)
        return back(half, piles)


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
    params = cycle_parameters(settings, tuned)
    return drive_cycle(
        spawns(settings), lambda: drains_flag(state.drain_water),
        lambda wet: cycle_front(state, settings, meta, params, wet, fresh=fresh, syncs=syncs),
        lambda half, piles: cycle_back(half, settings, meta, params, piles), syncs)


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
    shared one), which replays each dry cycle's halves as CUDA graphs,
    bit-equal to ``erosion_cycle``; every other cycle runs
    ``erosion_cycle``.  The state returned shares no tensor with the
    graphs' buffers, so no later call writes it.

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
