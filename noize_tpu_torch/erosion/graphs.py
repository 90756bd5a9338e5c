"""The erosion cycle's halves replayed as CUDA graphs between its two host
syncs.

Eagerly (``sim.erosion_cycle``) a dry cycle on the card enqueues some 64
device operations one at a time from Python, each costing the host far
more than the card, so the card waits on the host most of the cycle.  A
cycle's only host decisions are its two syncs, and ``sim.drive_cycle``
takes them between the cycle's two halves, so each half is captured once
on static buffers and replayed:

    sync.spawn.drains   (the drain water the previous cycle left)
    graph A             ``sim.cycle_front``, dry: thermal (K3), the spawn
                        (K8 and its fills), the descent (K7's records, K7,
                        K9), the deposit's pool and track adds, the piles
                        flag
    sync.sediment.piles
    graph B             ``sim.cycle_back`` with the piles answer (one graph
                        each, captured when first needed): K11 with the
                        pile tent or without, the flow update, the pool
                        automata (K4, K5 on odd grids), written into the
                        static state; the rest of the state copied there,
                        and the next cycle's drains flag

The halves are the eager cycle's own code, so a replay launches its
kernels in its order with its launch parameters and is bit-equal to
``erosion_cycle``.  One rule covers every cycle that is not replayed: a
wet cycle (the drain particles' stable sort), a configuration not
admitted yet and one whose capture raised run the same halves uncaptured.

``CycleGraphs`` holds one set of graphs, static state buffers and one
memory pool for each configuration it meets (``graph_key``: the kernels
bake their parameters in at capture), at most ``CAPACITY`` of them, the
least recently used evicted first.  It captures a configuration only when
the call before used it too (``KeyCache``), so a slider dragged every step
never pays a capture.  The state it hands back is copied out of its
buffers once a call, so a later replay never writes a tensor a caller
holds.

Spans: ``erosion.graph`` around each replay, inside its ``erosion.cycle``;
a half records its phase spans while it is captured, and none when
replayed.  Counters: ``sim.erosion_cycles.captures``, ``.replays``,
``.eager_cycles``; a replay adds its kernels' launches to their wrappers'
counters and its pool gate flag to ``wet_calls``, as the eager cycle does.
"""

from __future__ import annotations

import functools
import logging
import threading
from collections import OrderedDict
from dataclasses import replace
from typing import Callable

import torch

from ..ops.cuda.thermal import thermal_erosion_fused
from ..prng import _randint_cuda, threefry2x32
from ..utils.tracking import span
from . import sim as _sim
from .descent_cuda import descend_steps, step_records
from .pool_cuda import add_wet, pool_automata_cuda, pool_automata_full_cuda
from .scatter_cuda import scatter_in_order
from .sediment_cuda import write_sediment_cuda
from .world import WorldState

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
        self.spawns = _sim.spawns(settings)
        w = state.world
        self.buf = _sim.SimState(
            world=WorldState(*(torch.empty_like(getattr(w, f)) for f in
                               ("height", "pool", "flow", "track", "plants"))),
            drain_water=torch.empty_like(state.drain_water),
            key=torch.empty_like(state.key))
        self.capture = state.world.height.device.type == "cuda"  # off once a capture fails
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.graphs: dict = {}  # "front", ("back", piles): their captured _Graph
        self.flag = None      # the drains flag of the static state, after a back half
        self.replayed = False  # whether the current cycle replayed a graph

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

    # --- one cycle ----------------------------------------------------------

    def _run(self, half, body: Callable):
        """``body`` (a half on the static state) as its graph: captured when
        first needed, then replayed; uncaptured where capture is off."""
        if half not in self.graphs and self.capture:
            try:
                self.graphs[half] = _Graph(self.pool, body)
            except RuntimeError as err:
                log.warning("erosion cycle: capture failed (%s); this configuration runs "
                            "uncaptured", err)
                self.capture = False
        graph = self.graphs.get(half)
        if graph is None:
            return body()
        self.replayed = True
        with span("erosion.graph"):
            return graph.replay()

    def _back(self, half, piles):
        """The back half into the static state; the next cycle's drains
        flag."""
        self.load(_sim.cycle_back(half, self.settings, self.meta, self.params, piles,
                                  out=self.buf))
        return _sim.drains_flag(self.buf.drain_water)

    def cycle(self, state, syncs):
        """One cycle from ``state`` (``buf``: the one the last back half
        left there) through ``sim.drive_cycle``: a dry one runs the halves
        on the static state as graphs and returns ``buf``, a wet one runs
        them uncaptured on ``state``."""
        s, meta, params, buf = self.settings, self.meta, self.params, self.buf
        self.replayed = False
        static = False  # whether this cycle runs on the static state

        def drains():
            return self.flag if state is buf else _sim.drains_flag(state.drain_water)

        def front(wet):
            nonlocal static
            if wet:
                return _sim.cycle_front(state, s, meta, params, True, syncs=syncs)
            static = True
            self.load(state)

            def body():
                return _sim.cycle_front(buf, s, meta, params, False, syncs=syncs)

            # without a spawn the front half hands the static state on: no graph
            return self._run("front", body) if self.spawns else body()

        def back(half, piles):
            if not static:
                return _sim.cycle_back(half, s, meta, params, piles)
            self.flag = self._run(("back", piles), lambda: self._back(half, piles))
            return buf

        state = _sim.drive_cycle(self.spawns, drains, front, back, syncs)
        counts = _sim.erosion_cycles
        if self.replayed:
            counts.replays += 1
        else:
            counts.eager_cycles += 1
        return state


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
            out = state
            for _ in range(n):
                out = entry.cycle(out, syncs)
            # a cycle never writes the plants: hand back the caller's
            out = replace(out, world=replace(out.world, plants=state.world.plants))
            return entry.detach(out)


#: the runner of ``erosion_cycles`` calls that bring none (``tile_batch``,
#: ``generate_tile``): one per process, shared by their threads
SHARED = CycleGraphs()
