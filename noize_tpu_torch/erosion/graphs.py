"""The erosion cycle's device work replayed as CUDA graphs between its two
host syncs.

Eagerly (``sim.erosion_cycle``) a dry cycle on the card enqueues some 64
device operations one at a time from Python, each costing the host far
more than the card, so the card waits on the host most of the cycle.  A
cycle's only host decisions are its two syncs, so the work between them
is captured once as CUDA graphs and replayed:

    sync.spawn.drains   (the drain water the previous cycle left)
    graph A             thermal (K3), the spawn (K8 and its fills), the
                        descent (K7's records, K7, K9), the deposit's pool
                        and track adds, the piles flag
    sync.sediment.piles
    graph B             K11 with the pile tent or without (one graph each,
                        captured when first needed), the flow update, the
                        pool automata (K4, K5 on odd grids), the carried
                        maps copied into the static state, the next
                        cycle's drains flag

Both syncs and both branches stay as the eager cycle has them, and so do
the kernels, their order and their launch parameters: a replay is
bit-equal to ``erosion_cycle``.  A cycle with drain water queued (the
stable sort and scatter of the drain particles) runs eagerly.

``CycleGraphs`` holds one set of graphs, static state buffers and one
memory pool for each configuration it meets (``graph_key``: the kernels
bake their parameters in at capture), at most ``CAPACITY`` of them, the
least recently used evicted first.  It captures a configuration only when
the call before used it too (``KeyCache``), so a slider dragged every step
never pays a capture; a configuration whose capture raises runs eagerly
from then on.  The state it hands back is copied out of its buffers once
a call, so a later replay never writes a tensor a caller holds.

Spans: ``erosion.graph`` around a graph cycle's replays, inside its
``erosion.cycle``; the six phase spans are recorded only on eager cycles.
Counters: ``sim.erosion_cycles.captures``, ``.replays``, ``.eager_cycles``;
a replay adds its kernels' launches to their wrappers' counters and its
pool gate flag to ``wet_calls``, as the eager cycle does.
"""

from __future__ import annotations

import functools
import logging
import threading
from collections import OrderedDict
from dataclasses import replace
from typing import Callable, Optional

import torch

from ..ops.cuda.thermal import thermal_erosion_fused
from ..prng import _randint_cuda, threefry2x32
from ..utils.tracking import span, sync_bool
from . import sim as _sim
from .descent_cuda import descend_steps, step_records
from .pool_cuda import add_wet, pool_automata_cuda, pool_automata_full_cuda
from .scatter_cuda import scatter_in_order
from .sediment_cuda import piles_flag, write_sediment_cuda, write_sediment_piles
from .world import WorldState, update_flow_from_track

log = logging.getLogger("noize_tpu_torch")

#: the launch counters a cycle's kernels add to, which a replay adds to as
#: the eager cycle would
COUNTERS = (
    (thermal_erosion_fused, "launches"), (threefry2x32, "launches"),
    (_randint_cuda, "launches"), (step_records, "launches"), (descend_steps, "launches"),
    (scatter_in_order, "launches"), (write_sediment_cuda, "launches"),
    (write_sediment_cuda, "tent_launches"), (pool_automata_cuda, "launches"),
    (pool_automata_full_cuda, "launches"),
)
#: the pool wrappers whose ``wet_calls`` a replay adds its gate flag to
WET = (pool_automata_cuda, pool_automata_full_cuda)

#: configurations a runner keeps captured
CAPACITY = 4


def graph_eligible(state, settings, fresh) -> bool:
    """Whether ``erosion_cycles`` takes the graph path: the state is on
    CUDA, no ``fresh`` particles replace the spawn, and ``EXACT_PILES`` is
    off (its pile path syncs and visits piles on the host).  Whether each
    cycle is dry is read at its drains sync."""
    return (state.world.height.device.type == "cuda" and fresh is None
            and not settings.EXACT_PILES)


def graph_key(state, settings, meta, tuned=None) -> tuple:
    """What a cycle's graphs bake in: the device and grid, the settings
    that are not tunable (the behaviour, the thermal switches, the
    particles, the water steps), the tile's meta and the cycle's parameters
    after ``tuned`` (rounded to float32, as the cycle rounds them)."""
    h = state.world.height
    tuned = None if tuned is None else tuple(sorted(tuned.items()))
    return (h.device, tuple(h.shape)) + _baked(settings, meta, tuned)


@functools.lru_cache(maxsize=64)
def _baked(settings, meta, tuned) -> tuple:
    """``graph_key``'s settings, meta and parameters: the same objects for
    the same inputs, so comparing keys costs the host little."""
    return (settings.canonical(), meta,
            _sim.cycle_parameters(settings, None if tuned is None else dict(tuned)))


class KeyCache:
    """A runner's captured configurations, least recently used first, and
    the rule that admits a new one: a key is captured only when the call
    before used it too, so it has run eagerly for a whole call first."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.entries: OrderedDict = OrderedDict()
        self.last = None

    def lookup(self, key, make: Callable):
        """The entry of ``key``; a new one from ``make()`` when the previous
        call used ``key`` too; else None (this call runs eagerly)."""
        repeat, self.last = key == self.last, key
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            return entry
        if not repeat:
            return None
        entry = self.entries[key] = make()
        while len(self.entries) > self.capacity:
            self.entries.popitem(last=False)
        return entry


class _Graph:
    """One captured graph, what it leaves for the host to read, and what a
    replay adds to the launch counters and the pool gates' ``wet_calls``."""

    def __init__(self, pool, body: Callable):
        before = [getattr(fn, attr) for fn, attr in COUNTERS]
        wet = [w.wet_calls for w in WET]
        for w in WET:
            w.wet_calls = None  # a flag raised in the graph lands in a tensor of its own
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.out = body()
        finally:
            self.wet = [(w, w.wet_calls) for w in WET if w.wet_calls is not None]
            self.counts = []
            for (fn, attr), b in zip(COUNTERS, before):
                self.counts.append(getattr(fn, attr) - b)
                setattr(fn, attr, b)
            for w, old in zip(WET, wet):
                w.wet_calls = old
        _sim.erosion_cycles.captures += 1

    def replay(self):
        self.graph.replay()
        for (fn, attr), d in zip(COUNTERS, self.counts):
            if d:
                setattr(fn, attr, getattr(fn, attr) + d)
        for w, flag in self.wet:
            add_wet(w, flag)
        return self.out


class _Cycles:
    """One configuration's static state, graphs and memory pool."""

    def __init__(self, state, settings, meta, params):
        self.settings, self.meta, self.params = settings, meta, params
        self.height_scale = float(meta.height)
        self.spawns = _sim.spawns(settings)
        w = state.world
        self.buf = _sim.SimState(
            world=WorldState(*(torch.empty_like(getattr(w, f)) for f in
                               ("height", "pool", "flow", "track", "plants"))),
            drain_water=torch.empty_like(state.drain_water),
            key=torch.empty_like(state.key))
        self.pool = torch.cuda.graph_pool_handle()
        self.a: Optional[_Graph] = None
        self.b: dict = {}
        self.flag = None   # the drains flag of the static state, after a replay
        self.broken = False

    # --- the static state ---------------------------------------------------

    def _fields(self, state):
        w = state.world
        return (w.height, w.pool, w.flow, w.track, w.plants, state.drain_water, state.key)

    def load(self, state):
        """Copy ``state`` into the static buffers (the graphs' input)."""
        for dst, src in zip(self._fields(self.buf), self._fields(state)):
            if src is not dst:
                dst.copy_(src)

    def detach(self, state):
        """``state`` with each tensor that is a static buffer cloned."""
        own = {id(t) for t in self._fields(self.buf)}

        def out(t):
            return t.clone() if id(t) in own else t

        w = state.world
        return _sim.SimState(
            world=WorldState(*(out(getattr(w, f)) for f in
                               ("height", "pool", "flow", "track", "plants"))),
            drain_water=out(state.drain_water), key=out(state.key))

    # --- the two segments ---------------------------------------------------

    def _body_a(self):
        """Thermal, spawn, descent, deposit and the piles flag on the static
        state, as ``sim._cycle`` runs them on a dry cycle."""
        s, buf = self.settings, self.buf
        world = buf.world
        if _sim._thermal_on(s):
            world = _sim._thermal(world, s, self.meta)
        parts, key = _sim._draw(buf.key, s.PARTICLES_PER_CYCLE, self.meta.generator_res)
        world, drain_water = _sim._release_drains(world, buf.drain_water)
        track_acc, pool_acc, sed_acc = _sim._descend(parts, world, self.params, self.meta)
        world = _sim._deposit(world, track_acc, pool_acc, self.params)
        return (world, drain_water, key, sed_acc,
                piles_flag(sed_acc, self.params, self.height_scale))

    def _body_b(self, piles: Optional[bool]):
        """K11 (after graph A), the flow update and the pool automata; the
        carried maps stored in the static state (the height, the pool and
        the drain water written there by the ops that make them, the rest
        copied).  Returns the next cycle's drains flag."""
        s, buf = self.settings, self.buf
        if self.spawns:
            world, drain_water, key, sed_acc, _ = self.a.out
            # K11 cannot write the map it reads: without thermal that is buf's
            out = None if world.height is buf.world.height else buf.world.height
            world = replace(world, height=write_sediment_piles(
                world.height, sed_acc, self.params, self.height_scale, piles, out=out))
        else:
            world, drain_water, key = buf.world, buf.drain_water, buf.key
        world = update_flow_from_track(world, self.params, self.height_scale)
        world, drain_water = _sim._pool(world, drain_water, s,
                                        out=(buf.world.pool, buf.drain_water))
        self.load(_sim.SimState(world=world, drain_water=drain_water, key=key))
        return _sim._drains_flag(buf.drain_water)

    def _capture(self, body: Callable) -> Optional[_Graph]:
        try:
            return _Graph(self.pool, body)
        except RuntimeError as err:
            log.warning("erosion cycle: capture failed (%s); this configuration runs "
                        "eagerly", err)
            self.broken = True
            return None

    def replay(self, syncs):
        """One dry cycle on the static state: graph A, the piles sync, graph
        B; each graph captured when first needed.  Leaves the drains flag of
        the new state in ``flag``."""
        piles = None
        if self.spawns:
            if self.a is None:
                self.a = self._capture(self._body_a)
                if self.a is None:
                    raise _Uncaptured
            _, _, _, _, flag = self.a.replay()
            piles = sync_bool("sediment.piles", flag, syncs)
        b = self.b.get(piles)
        if b is None:
            b = self.b[piles] = self._capture(lambda: self._body_b(piles))
            if b is None:  # A ran: finish the cycle eagerly
                self.flag = self._body_b(piles)
                return
        self.flag = b.replay()


class _Uncaptured(Exception):
    """Graph A could not be captured: the cycle runs eagerly."""


class CycleGraphs:
    """The erosion cycles of one owner (``ErosionSim``, a flagship step),
    or of every ``tile_batch`` (``SHARED``), on CUDA graphs: see the
    module's docstring.  Thread-safe: one call at a time uses the
    buffers."""

    def __init__(self):
        self._keys = KeyCache()
        self._lock = threading.Lock()

    def run(self, state, settings, meta, n: int, tuned=None, syncs=None):
        """``n`` cycles from ``state`` (``sim.erosion_cycles``' graph path)."""
        # graphs capture and replay on the current device: make it the state's
        with self._lock, torch.cuda.device(state.world.height.device):
            key = graph_key(state, settings, meta, tuned)
            entry = self._keys.lookup(key, lambda: _Cycles(state, settings, meta, key[-1]))
            if entry is None:
                for _ in range(n):
                    state = _sim.erosion_cycle(state, settings, meta, tuned, syncs=syncs)
                _sim.erosion_cycles.eager_cycles += n
                return state
            cur = state        # the eager state, or None where it lies in entry.buf
            flag = None        # the drains flag graph B left for entry.buf
            for _ in range(n):
                cur = self._cycle(entry, cur, flag, settings, meta, tuned, syncs)
                if cur is None:
                    flag = entry.flag
            out = entry.buf if cur is None else cur
            # a cycle never writes the plants: hand back the caller's
            out = replace(out, world=replace(out.world, plants=state.world.plants))
            return entry.detach(out)

    @staticmethod
    def _cycle(entry, cur, flag, settings, meta, tuned, syncs):
        """One cycle from ``cur`` (None: ``entry.buf``); returns the eager
        state it leaves, or None where it left ``entry.buf``."""
        counts = _sim.erosion_cycles
        if entry.broken:
            counts.eager_cycles += 1
            return _sim.erosion_cycle(entry.buf if cur is None else cur, settings, meta,
                                      tuned, syncs=syncs)
        with span("erosion.cycle"):
            wet = False
            if entry.spawns:
                wet = sync_bool("spawn.drains", flag if cur is None
                                else _sim._drains_flag(cur.drain_water), syncs)
            if not wet:
                if cur is not None:
                    entry.load(cur)
                try:
                    with span("erosion.graph"):
                        entry.replay(syncs)
                    counts.replays += 1
                    return None
                except _Uncaptured:
                    cur = None
            counts.eager_cycles += 1
            return _sim._cycle(entry.buf if cur is None else cur, settings, meta, tuned, None,
                               syncs, wet=wet)


#: the runner of ``erosion_cycles`` calls that bring none (``tile_batch``,
#: ``generate_tile``): one per process, shared by their threads
SHARED = CycleGraphs()
