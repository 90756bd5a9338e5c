"""The erosion cycle's graph path (``erosion.graphs``) on the CPU: its cache
key, when it engages, when it captures, the one loop of cycles
(``sim.erosion_cycles``) its callers share, against the loops of
``erosion_cycle`` each of them ran before, and the graph runner's cycle
itself (``sim.drive_cycle`` on the halves, dry cycles on the static state)
uncaptured, against ``erosion_cycle``.  The replays themselves run on the
card (``tests/test_torch_graphs_cuda.py``)."""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion import graphs as G
from noize_tpu_torch.erosion import sim as SIM
from noize_tpu_torch.erosion.params import ErosionMode, ErosionSettings
from noize_tpu_torch.erosion.particles import spawn
from noize_tpu_torch.prng import PRNGKey

RES = 40
SETTINGS = ErosionSettings(PARTICLES_PER_CYCLE=48, MAXAGE=20, CYCLES=2)
META = TileSetMeta(tile_res=RES, tile_size=RES, generator_res=RES, height=1000, margin=0)


def _height(seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:RES, 0:RES].astype(np.float32) / np.float32(RES)
    h = 0.5 + 0.3 * np.sin(6.283 * (2 * x + rng.uniform())) * np.cos(6.283 * y)
    return torch.from_numpy((h + rng.uniform(0, 0.01, (RES, RES))).astype(np.float32))


def _state(seed=0):
    return SIM.init_state(_height(seed), PRNGKey(seed, device="cpu"))


def _key(state=None, settings=SETTINGS, meta=META, tuned=None):
    return G.graph_key(_state() if state is None else state, settings, meta, tuned)


def _equal(a, b):
    for m in ("height", "pool", "flow", "track", "plants"):
        assert torch.equal(getattr(a.world, m), getattr(b.world, m)), m
    assert torch.equal(a.drain_water, b.drain_water)
    assert torch.equal(a.key, b.key)


def test_key_rounds_tuned_to_float32():
    base = SETTINGS.tunable_values()
    below = dict(base, EROSION=float(np.nextafter(np.float64(base["EROSION"]), 2.0)))
    above = dict(base, EROSION=float(np.nextafter(np.float32(base["EROSION"]),
                                                  np.float32(2.0))))
    assert _key(tuned=below) == _key(tuned=base)
    assert _key(tuned=above) != _key(tuned=base)
    # a retuned setting and the same value passed as ``tuned`` bake in alike
    retuned = replace(SETTINGS, EROSION=0.75)
    assert _key(settings=retuned, tuned=retuned.tunable_values()) == \
        _key(tuned=dict(base, EROSION=0.75))


@pytest.mark.parametrize("change", [
    dict(BEHAVIOR=ErosionMode.THERMAL_FLOW_WATER), dict(ENABLE_THERMAL=False),
    dict(TALUS=40.0), dict(THERMAL_CYCLES=2), dict(WATER_STEPS=4),
    dict(PARTICLES_PER_CYCLE=64), dict(PILING_RADIUS=8), dict(EROSION=0.5)])
def test_key_holds_what_the_graphs_bake_in(change):
    assert _key(settings=replace(SETTINGS, **change)) != _key()


def test_key_holds_the_grid_and_the_meta():
    small = SIM.init_state(_height()[:32, :32].contiguous())
    assert _key(small) != _key()
    assert _key(meta=replace(META, height=500)) != _key()
    assert _key(_state(1)) == _key(_state(2))  # the maps' values are not baked in


def test_eligible_only_on_cuda_without_fresh_or_exact_piles():
    def state(kind):
        return SimpleNamespace(world=SimpleNamespace(
            height=SimpleNamespace(device=torch.device(kind))))

    assert G.graph_eligible(state("cuda"), SETTINGS, None)
    assert not G.graph_eligible(state("cpu"), SETTINGS, None)
    assert not G.graph_eligible(state("cuda"), SETTINGS, [object()])
    assert not G.graph_eligible(state("cuda"), replace(SETTINGS, EXACT_PILES=True), None)
    assert G.graph_eligible(state("cuda"), replace(SETTINGS, VEGETATION_FRICTION=0.5), None)


def test_a_key_is_captured_on_its_second_call_in_a_row():
    cache = G.KeyCache(capacity=2)
    made = []

    def make(key):
        return lambda: made.append(key) or key

    steps = ["a", "a", "a", "b", "a", "b", "b", "c", "d", "e", "c", "c", "a", "a", "b"]
    got = [cache.lookup(k, make(k)) for k in steps]
    # at most ``capacity`` keys, the least recently used evicted first: "c"
    # evicts "a", which comes back on two calls in a row and evicts "b"
    assert got == [None, "a", "a", None, "a", None, "b", None, None, None, None, "c",
                   None, "a", None]
    assert made == ["a", "b", "c", "a"]
    assert list(cache.entries) == ["c", "a"]


def test_a_slider_dragged_every_step_never_captures():
    cache = G.KeyCache()
    assert all(cache.lookup(v, object) is None for v in np.linspace(0.1, 0.9, 50))
    assert not cache.entries


def _old_loop(state, n, settings=SETTINGS, tuned=None, fresh=None, syncs=None):
    for c in range(n):
        state = SIM.erosion_cycle(state, settings, META, tuned,
                                  fresh=None if fresh is None else fresh[c], syncs=syncs)
    return state


@pytest.mark.parametrize("with_fresh", [False, True])
def test_erosion_cycles_is_the_old_loop_on_the_cpu(with_fresh):
    fresh = [spawn(PRNGKey(9 + c, device="cpu"), 48, RES) for c in range(3)] \
        if with_fresh else None
    tuned = replace(SETTINGS, DEPOSITION=0.2).tunable_values()
    want_syncs, got_syncs = [], []
    want = _old_loop(_state(3), 3, tuned=tuned, fresh=fresh, syncs=want_syncs)
    before = (SIM.erosion_cycles.captures, SIM.erosion_cycles.replays,
              SIM.erosion_cycles.eager_cycles)
    last = G.SHARED._keys.last
    got = SIM.erosion_cycles(_state(3), SETTINGS, META, 3, tuned=tuned, fresh=fresh,
                             syncs=got_syncs)
    _equal(got, want)
    assert got_syncs == want_syncs and want_syncs
    # the CPU never reaches the graphs, nor counts its cycles as the card's
    assert (SIM.erosion_cycles.captures, SIM.erosion_cycles.replays,
            SIM.erosion_cycles.eager_cycles) == before
    assert G.SHARED._keys.last is last


def test_erosion_sim_step_and_trigger_are_the_old_loop():
    sim = SIM.ErosionSim(_height(4), settings=SETTINGS, seed=4, device="cpu")
    start = sim.state
    sim.step()
    want = _old_loop(start, 2, tuned=SETTINGS.tunable_values())
    _equal(sim.state, want)
    assert sim.cycle_count == 2 and sim.syncs
    assert sim.trigger()
    _equal(sim.state, _old_loop(want, 2, tuned=SETTINGS.tunable_values()))
    assert sim.cycle_count == 4
    assert not sim._graphs._keys.entries and sim._graphs._keys.last is None


def test_tile_step_and_tile_erode_are_the_old_loop():
    from noize_tpu_torch.app.flagship import make_tile_step
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.parallel import tiled as T

    meta = TileSetMeta(tile_res=32, tile_size=32, generator_res=RES, height=1000, margin=4)
    step, _, _ = make_tile_step(meta, SETTINGS, octaves=4, blur_iterations=2,
                                flow_iterations=2, erosion_cycles=2, emit_mesh=False,
                                device="cpu")
    key = PRNGKey(5, device="cpu")
    got = step(0.0, 0.0, key)
    h = fractal(RES, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=4,
                noise_size=1700.0, device="cpu")
    h = gauss_chain(h, 5, 1.0, 2)
    want = SIM.init_state(h, key)
    for _ in range(2):
        want = SIM.erosion_cycle(want, SETTINGS, meta)
    assert torch.equal(got["height"], want.world.height)
    assert torch.equal(got["pool"], want.world.pool)
    assert torch.equal(got["stream"], want.world.flow)
    assert torch.equal(got["flow_velocity"], flow_map_fused(h, iterations=2))

    cfg = T.TilePipelineConfig(meta=meta, erosion=SETTINGS, erosion_cycles=2)
    want = SIM.init_state(h, key)
    for _ in range(2):
        want = SIM.erosion_cycle(want, SETTINGS, meta)
    assert torch.equal(T._tile_erode(cfg, h, key), want.world.height)


#: the configurations whose halves the graph runner's cycle runs on the CPU
HALVES = {
    "thermal": {}, "no_thermal": dict(ENABLE_THERMAL=False),
    "only_flow_water": dict(BEHAVIOR=ErosionMode.ONLY_FLOW_WATER),
    "piles": dict(PILE_THRESHOLD=1e-6), "no_piles": dict(PILE_THRESHOLD=1e6),
    "exact_piles": dict(EXACT_PILES=True, PILE_THRESHOLD=1e-6),
    "vegetation": dict(VEGETATION_FRICTION=0.5), "wet": {},
}


@pytest.mark.parametrize("case", list(HALVES))
def test_the_graph_runners_cycle_is_erosion_cycle(case):
    """The cycle a configuration's graphs run (``graphs._Cycles.cycle``),
    uncaptured on CPU tensors: the same halves through the same sync
    driver, a dry cycle's on the static state with the back half writing
    into it and the drains flag it leaves there, a wet one's on the state.
    Three cycles bit-equal to three of ``erosion_cycle``, the syncs alike."""
    settings = replace(SETTINGS, **HALVES[case])
    state = _state(6)
    world = state.world
    if case == "only_flow_water":
        state = replace(state, world=replace(world, pool=world.pool + 2e-3))
    if case == "vegetation":
        plants = torch.rand((RES, RES), generator=torch.Generator().manual_seed(6)) * 3
        state = replace(state, world=replace(world, plants=plants))
    if case == "wet":
        drains = state.drain_water.clone()
        drains.view(-1)[torch.tensor([5, 700, 1203])] = torch.tensor([1e-3, 2.5e-3, 4e-4])
        state = replace(state, drain_water=drains)
    params = SIM.cycle_parameters(settings)
    front = SIM.cycle_front(state, settings, META, params, case == "wet")
    if case in ("piles", "no_piles", "exact_piles"):
        assert bool(front.flag) == (case != "no_piles")
    assert (front.flag is None) == (case == "only_flow_water")
    want, want_syncs, wet = state, [], []
    for _ in range(3):
        wet.append(bool(SIM.drains_flag(want.drain_water)))
        want = SIM.erosion_cycle(want, settings, META, syncs=want_syncs)
    assert wet[0] == (case == "wet") and not all(wet)
    entry = G._Cycles(state, settings, META, params)
    got, syncs = state, []
    for c in range(3):
        got = entry.cycle(got, syncs)
        # ONLY_FLOW_WATER never syncs on the drains: every cycle is static
        assert (got is entry.buf) == (case == "only_flow_water" or not wet[c])
    _equal(got, want)
    assert syncs == want_syncs
    assert not entry.graphs
