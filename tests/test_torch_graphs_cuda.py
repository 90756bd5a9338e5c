"""The erosion cycle's CUDA graphs (``erosion.graphs``) against the eager
cycle (``sim.erosion_cycle``) on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernels); on a
machine without one each test skips with a reason.  Run them on the card
with:

    python -m pytest --noconftest tests/test_torch_graphs_cuda.py -q

Tolerance: bit-equality.  A replay launches the eager cycle's kernels in
its order with its launch parameters.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion import graphs as G
from noize_tpu_torch.erosion import sim as SIM
from noize_tpu_torch.erosion.decay_cuda import deposit_and_decay_cuda
from noize_tpu_torch.erosion.params import ErosionMode, ErosionSettings
from noize_tpu_torch.erosion.pool_cuda import pool_automata_cuda
from noize_tpu_torch.erosion.sediment_cuda import write_sediment_cuda
from noize_tpu_torch.prng import PRNGKey

pytestmark = pytest.mark.card

MAPS = ("height", "pool", "flow", "track", "plants")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(res, seed=0):
    """The Quickstart's field at ``res``² on the card: fBm, Gauss-5, flow."""
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.fractal import fractal

    h = fractal(res, 97.0 * seed, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                noise_size=1700.0 * res / 2048, device="cuda")
    return flow_map_fused(gauss_chain(h, 5, 1.0, 17), iterations=8)


def _meta(res):
    return TileSetMeta(tile_res=res, tile_size=res, generator_res=res, height=1000, margin=0)


def _start(res, seed=0, plants=None):
    state = SIM.init_state(_field(res, seed), PRNGKey(seed + 11, device="cuda"))
    if plants is not None:
        state = replace(state, world=replace(state.world, plants=plants))
    return state


def _eager(state, settings, meta, n, tuned=None):
    """``n`` eager cycles; (state, syncs, whether each cycle began wet)."""
    syncs, wet = [], []
    for _ in range(n):
        wet.append(bool((state.drain_water > 0).any()))
        state = SIM.erosion_cycle(state, settings, meta, tuned, syncs=syncs)
    return state, syncs, wet


def _bits(got, want):
    torch.cuda.synchronize()
    a, b = got.cpu(), want.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _same_state(got, want):
    for m in MAPS:
        _bits(getattr(got.world, m), getattr(want.world, m))
    _bits(got.drain_water, want.drain_water)
    _bits(got.key, want.key)


def _snapshot(state):
    return [t.clone() for t in (*(getattr(state.world, m) for m in MAPS),
                                state.drain_water, state.key)]


def _unchanged(state, snap):
    for t, s in zip((*(getattr(state.world, m) for m in MAPS), state.drain_water, state.key),
                    snap):
        _bits(t, s)


def _counts():
    c = SIM.erosion_cycles
    return c.captures, c.replays, c.eager_cycles


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.parametrize("res", [2048, 1024, 1025])
@pytest.mark.parametrize("piles", [True, False])
def test_graph_cycles_bit_equal_eager(cuda, res, piles):
    """Three calls of two cycles: the first eager (the key's first call),
    the second captures graph A and the piles variant of graph B, the third
    replays; six cycles bit-equal to six eager ones, the syncs alike, and
    no state handed out written by a later call."""
    settings = ErosionSettings(PILE_THRESHOLD=1e-6 if piles else 1e6)
    meta = _meta(res)
    start = _start(res)
    want, want_syncs, wet = _eager(start, settings, meta, 6)
    dry = wet[2:].count(False)
    assert dry
    runner = G.CycleGraphs()
    before = _counts()
    tents = write_sediment_cuda.tent_launches
    k12 = deposit_and_decay_cuda.launches
    got, syncs, handed = start, [], []
    for _ in range(3):
        got = SIM.erosion_cycles(got, settings, meta, 2, syncs=syncs, graphs=runner)
        handed.append((got, _snapshot(got)))
    assert _delta(before) == (2, dry, 6 - dry)
    assert write_sediment_cuda.tent_launches - tents == (6 if piles else 0)
    # K12 once a cycle, replayed or not
    assert deposit_and_decay_cuda.launches - k12 == 6
    assert syncs == want_syncs == ["spawn.drains", "sediment.piles"] * 6
    _same_state(got, want)
    for state, snap in handed:
        _unchanged(state, snap)
    _unchanged(start, _snapshot(_start(res)))


def test_replays_count_as_eager_launches(cuda):
    """Every launch counter a cycle adds to, and the pool gate's
    ``wet_calls``, read after graph cycles what they read after as many
    eager ones."""
    settings, meta = ErosionSettings(), _meta(1024)
    start = _start(1024, 2)
    runner = G.CycleGraphs()
    SIM.erosion_cycles(start, settings, meta, 1, graphs=runner)  # the key's eager call

    def reading():
        wet = pool_automata_cuda.wet_calls
        return [getattr(fn, a) for fn, a in G.COUNTERS] + [0 if wet is None else int(wet)]

    r0 = reading()
    _eager(start, settings, meta, 3)
    r1 = reading()
    before = _counts()
    SIM.erosion_cycles(start, settings, meta, 3, graphs=runner)
    assert _delta(before) == (2, 3, 0)
    r2 = reading()
    assert [b - a for a, b in zip(r0, r1)] == [c - b for b, c in zip(r1, r2)]


def test_retune_between_steps(cuda):
    """An ``ErosionSim`` retuned between steps: a new value runs eagerly for
    one step and is captured on its second; a value met before replays
    with no capture; every step bit-equal to eager cycles with the same
    tunables, and every state taken unchanged by later steps."""
    start = _start(1024, 3)
    settings = ErosionSettings()
    sim = SIM.ErosionSim(start.world.height, settings=settings, seed=0)
    sim.state = start
    want = start
    plan = [0.9, 0.9, 0.9, 0.7, 0.7, 0.9, 0.7]
    # captures and replays each step adds: (0, 0) for a new value's first
    # step, (2, 3) for its second, (0, 3) for a value captured before
    expect = [(0, 0), (2, 3), (0, 3), (0, 0), (2, 3), (0, 3), (0, 3)]
    taken = []
    for erosion, (caps, reps) in zip(plan, expect):
        sim.settings = replace(settings, EROSION=erosion)
        before = _counts()
        got = sim.step()
        assert _delta(before)[:2] == (caps, reps)
        want, _, _ = _eager(want, sim.settings, sim.meta, 3, sim.settings.tunable_values())
        _same_state(got, want)
        taken.append((got, _snapshot(got)))
    for state, snap in taken:
        _unchanged(state, snap)
    assert len(sim._graphs._keys.entries) == 2


def test_wet_cycle_falls_back_then_replays(cuda):
    """Drain water queued before a call: that cycle runs eagerly (the
    drain particles' sort), the next dry cycle replays again; bit-equal to
    eager cycles throughout."""
    settings, meta = ErosionSettings(), _meta(1024)
    start = _start(1024, 4)
    runner = G.CycleGraphs()
    got = SIM.erosion_cycles(start, settings, meta, 2, graphs=runner)
    got = SIM.erosion_cycles(got, settings, meta, 2, graphs=runner)
    want, _, _ = _eager(start, settings, meta, 4)
    _same_state(got, want)
    cells = torch.tensor([5, 70_000, 512 * 1024 + 3], device=cuda)
    for s in (got, want):
        s.drain_water.view(-1)[cells] = torch.tensor([1e-3, 2.5e-3, 4e-4], device=cuda)
    syncs = []
    before = _counts()
    got = SIM.erosion_cycles(got, settings, meta, 3, syncs=syncs, graphs=runner)
    want, want_syncs, wet = _eager(want, settings, meta, 3)
    assert wet[0]
    n_wet = sum(wet)
    assert _delta(before) == (0, 3 - n_wet, n_wet) and n_wet < 3
    assert syncs == want_syncs
    _same_state(got, want)


@pytest.mark.parametrize("change", [dict(BEHAVIOR=ErosionMode.ONLY_FLOW_WATER),
                                    dict(BEHAVIOR=ErosionMode.THERMAL_FLOW_WATER),
                                    dict(ENABLE_THERMAL=False)])
def test_other_behaviours_bit_equal(cuda, change):
    """ONLY_FLOW_WATER has no spawn and no sync: its whole cycle is graph B;
    THERMAL_FLOW_WATER spawns without capacity; without thermal, K11 reads
    the static height and writes a map of its own.  All bit-equal."""
    settings, meta = ErosionSettings(**change), _meta(1024)
    start = _start(1024, 5)
    start = replace(start, world=replace(start.world, pool=start.world.pool + 2e-3))
    want, want_syncs, _ = _eager(start, settings, meta, 6)
    runner = G.CycleGraphs()
    got, syncs = start, []
    before, k12 = _counts(), deposit_and_decay_cuda.launches
    for _ in range(3):
        got = SIM.erosion_cycles(got, settings, meta, 2, syncs=syncs, graphs=runner)
    assert syncs == want_syncs
    assert _delta(before)[1] >= 1 and deposit_and_decay_cuda.launches - k12 == 6
    _same_state(got, want)


def test_vegetation_friction(cuda):
    """``VEGETATION_FRICTION`` reads the plant map in the descent: the
    graph path copies it in and hands the caller's plants back."""
    plants = torch.rand((1024, 1024), generator=torch.Generator().manual_seed(6)).to("cuda") * 3
    settings, meta = ErosionSettings(VEGETATION_FRICTION=0.5), _meta(1024)
    start = _start(1024, 6, plants=plants)
    want, _, _ = _eager(start, settings, meta, 6)
    runner = G.CycleGraphs()
    got = start
    for _ in range(3):
        got = SIM.erosion_cycles(got, settings, meta, 2, graphs=runner)
    assert got.world.plants is plants
    _same_state(got, want)


def test_fresh_exact_piles_never_capture(cuda):
    """``fresh`` particles and ``EXACT_PILES`` run every cycle eagerly."""
    from noize_tpu_torch.erosion.particles import spawn

    meta = _meta(256)
    start = _start(256, 7)
    runner = G.CycleGraphs()
    fresh = [spawn(PRNGKey(i, device="cuda"), 1000, 256) for i in range(2)]
    before = _counts()
    for _ in range(3):
        SIM.erosion_cycles(start, ErosionSettings(), meta, 2, fresh=fresh, graphs=runner)
        SIM.erosion_cycles(start, ErosionSettings(EXACT_PILES=True, PILE_THRESHOLD=1e-6),
                           meta, 2, graphs=runner)
    assert _delta(before) == (0, 0, 12)
    assert not runner._keys.entries


def test_tile_step_and_tile_batch(cuda):
    """The flagship step: its first call eager, its second captures, its
    third replays, all bit-equal, and the first call's outputs untouched by
    the later ones.  ``tile_batch`` with erosion: each tile bit-equal to
    its eager cycles."""
    from noize_tpu_torch.app.flagship import make_tile_step
    from noize_tpu_torch.parallel import tiled as T

    meta = TileSetMeta(tile_res=480, tile_size=480, generator_res=512, height=1000,
                       margin=16)
    step, _, _ = make_tile_step(meta, ErosionSettings(), erosion_cycles=3, emit_mesh=True,
                                device="cuda")
    key = PRNGKey(12, device="cuda")
    names = ("height", "pool", "stream", "flow_velocity")
    outs, snaps, deltas = [], [], []
    for _ in range(3):
        before = _counts()
        outs.append(step(0.0, 0.0, key))
        deltas.append(_delta(before))
        snaps.append([outs[-1][k].clone() for k in names])
    # this tile has wet cycles too: each runs eagerly
    assert deltas[0] == (0, 0, 3) and deltas[1][0] == 2 and deltas[2][0] == 0
    assert deltas[1][1:] == deltas[2][1:] and deltas[1][1] >= 1 and sum(deltas[1][1:]) == 3
    for out, snap in zip(outs, snaps):
        for k, v in zip(names, snap):
            _bits(out[k], outs[0][k])
            _bits(out[k], v)
        _bits(out["mesh"].positions, outs[0]["mesh"].positions)

    cfg = T.TilePipelineConfig(meta=meta, octaves=8, flow_iterations=8,
                               erosion=ErosionSettings(), erosion_cycles=2, emit_mesh=True)
    origins = np.asarray([meta.tile_origin((i, 0)) for i in range(4)], np.int32)
    got = T.tile_batch(cfg, origins, seed=3, device="cuda")
    got2 = T.tile_batch(cfg, origins, seed=3, device="cuda")
    xs, zs, keys = T._tile_inputs(origins, 3, torch.device("cuda"))
    h = T._tile_height(cfg, xs, zs, device=torch.device("cuda"))
    for i in range(4):
        want, _, _ = _eager(SIM.init_state(h[i], keys[i]), cfg.erosion, meta, 2)
        _bits(got["height"][i], want.world.height)
        _bits(got2["height"][i], want.world.height)


def test_capture_under_the_profiler(cuda):
    """A capture taken while ``torch.profiler`` runs (a new graph B variant
    inside a traced window) replays bit-equal too."""
    from torch.profiler import ProfilerActivity, profile

    settings, meta = ErosionSettings(), _meta(1024)
    start = _start(1024, 8)
    want, _, _ = _eager(start, settings, meta, 4)
    runner = G.CycleGraphs()
    got = SIM.erosion_cycles(start, settings, meta, 2, graphs=runner)
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = SIM.erosion_cycles(got, settings, meta, 2, graphs=runner)
        torch.cuda.synchronize()
    assert _delta(before) == (2, 2, 0)
    _same_state(got, want)


def test_wrappers_write_into_out(cuda):
    """K11's and K4/K5's ``out=``: the map they would have made, written
    into the one given; a map they read is refused."""
    from noize_tpu_torch.erosion.pool_cuda import pool_automata_full_cuda
    from noize_tpu_torch.erosion.sediment import write_sediment_piles

    params = ErosionSettings().as_parameters()
    for res, pool_fn in ((1024, pool_automata_cuda), (1025, pool_automata_full_cuda)):
        h = _field(res, 9)
        sed = torch.rand((res, res), generator=torch.Generator().manual_seed(res)).to(cuda)
        sed = (sed - 0.5) * 4e-3
        pool = torch.where(sed > 1e-3, sed, 0.0)
        for piles in (True, False):
            out = torch.full_like(h, float("nan"))
            got = write_sediment_piles(h, sed, params, 1000.0, piles, out=out)
            assert got is out
            _bits(out, write_sediment_piles(h, sed, params, 1000.0, piles))
        out = torch.full_like(h, float("nan"))
        got, drains = pool_fn(h, pool, 10, True, out=out)
        want, want_drains = pool_fn(h, pool, 10, True)
        assert got is out
        _bits(out, want)
        _bits(drains, want_drains)
        with pytest.raises(ValueError, match="apart"):
            write_sediment_piles(h, sed, params, 1000.0, True, out=h)
        with pytest.raises(ValueError, match="apart"):
            pool_fn(h, pool, 10, True, out=pool)
