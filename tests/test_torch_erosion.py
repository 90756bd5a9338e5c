"""noize_tpu_torch erosion (world, particles, sediment, sim) against
noize_tpu on the same inputs.

The reference here is the compiled JAX program, as the flagship runs it.
Tolerances:
  * particle trajectories (cell, heading, age, alive, water) and the track
    and pool event maps: exact — the port quantises neighbour heights and
    divides by constants exactly as the compiled program does;
  * sediment sums, velocities and everything downstream: 1e-4 relative
    (BASELINE.md's bar).  Measured gaps are ulp-scale: XLA's CPU backend
    contracts some multiply-adds into FMAs and its atan/sin differ from
    PyTorch's by an ulp (ROADMAP.md §3).
  * sediment dispersal and the world update: bit-exact against JAX
    evaluated one primitive at a time (``jax.disable_jit()``).
The port's spawn draws the reference's ``jax.random`` bits
(``noize_tpu_torch.prng``); the cycle tests still pass the JAX spawn in as
``fresh`` to hold the rest of the cycle apart from the PRNG.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion import particles as JPa
from noize_tpu.erosion import sediment as JSe
from noize_tpu.erosion import sim as JS
from noize_tpu.erosion import world as JW
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.ops import kernels as JK
from noize_tpu_torch import convert
from noize_tpu_torch.erosion import particles as TPa
from noize_tpu_torch.erosion import sediment as TSe
from noize_tpu_torch.erosion import sim as TS
from noize_tpu_torch.erosion import world as TW
from noize_tpu_torch.prng import PRNGKey

RES = 64


def _terrain(seed, res=RES):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    taps = JK.gaussian_taps(2.0, 9)
    for _ in range(4):
        h = np.array(JK.separable_series(jnp.asarray(h), taps, taps))
    return h


def _world(seed, res=RES):
    rng = np.random.default_rng(seed)
    z = np.zeros((res, res), np.float32)
    return dict(height=_terrain(seed, res),
                pool=rng.uniform(0, 1e-3, (res, res)).astype(np.float32),
                flow=rng.uniform(0, 0.2, (res, res)).astype(np.float32),
                track=z, plants=z)


def _jax_particles(key, n, res=RES):
    return JPa.spawn(key, n, res)


def _to_port(parts):
    return convert.particles_from_numpy({k: np.array(v) for k, v in parts._asdict().items()},
                                        device="cpu")


def _assert_close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def test_neighbor_offsets_and_constants():
    assert TW.NEIGHBOR_OFFSETS == JW.NEIGHBOR_OFFSETS
    assert TW.MINFLOWPOOL == JW.MINFLOWPOOL
    assert TPa.NONE_HEADING == int(JPa.NONE_HEADING)
    assert TPa.RING_DR == tuple(JPa.RING_DR) and TPa.RING_DC == tuple(JPa.RING_DC)


def test_spawn_shapes_and_ranges():
    p = TPa.spawn(PRNGKey(0, device="cpu"), 500, 32)
    want = _jax_particles(jax.random.PRNGKey(0), 500, 32)
    for k in TPa.Particles._fields:
        a, b = getattr(p, k), np.asarray(getattr(want, k))
        assert a.shape == b.shape and str(a.dtype).endswith(str(b.dtype)), k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)  # same threefry bits
    assert 0 <= float(p.row.min()) and float(p.row.max()) <= 31
    assert bool((p.heading == -1).all()) and bool(p.alive.all())


def test_quantize_matches_compiled_reference():
    v = np.random.default_rng(2).uniform(0, 3000, 100000).astype(np.float32)
    want = np.asarray(jax.jit(JPa._quantize)(v))
    np.testing.assert_array_equal(TPa._quantize(torch.from_numpy(v)).numpy(), want)


def test_descend_step_and_all_match_reference():
    world = _world(0)
    jw = JW.WorldState(**{k: jnp.asarray(v) for k, v in world.items()})
    tw = TW.WorldState(**{k: torch.tensor(v) for k, v in world.items()})
    params = ErosionSettings(MAXAGE=30).as_parameters()
    jp = _jax_particles(jax.random.PRNGKey(3), 200)
    tp = _to_port(jp)

    js, jev = jax.jit(lambda p, w: JPa.descend_step(p, w, params, 1000.0, 1.0, RES))(jp, jw)
    ts, tev = TPa.descend_step(tp, tw, params, 1000.0, 1.0, RES)
    for k in ("row", "col", "heading", "age", "alive", "water"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
    for k in ("row", "col", "d_track", "d_pool"):
        np.testing.assert_array_equal(tev[k].numpy(), np.asarray(jev[k]))
    _assert_close(ts.vel.numpy(), js.vel)
    _assert_close(tev["d_sed"].numpy(), jev["d_sed"])

    jout = jax.jit(lambda p, w: JPa.descend_all(p, w, params, 1000.0, 1.0, RES))(jp, jw)
    tout = TPa.descend_all(tp, tw, params, 1000.0, 1.0, RES)
    for k in ("row", "col", "heading", "age", "alive", "water"):
        np.testing.assert_array_equal(getattr(tout[0], k).numpy(),
                                      np.asarray(getattr(jout[0], k)))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))  # track
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))  # pool
    _assert_close(tout[3].numpy(), jout[3])                             # sediment
    assert (np.asarray(jout[1]) > 0).sum() > 100


def test_sediment_dispersal_bit_exact():
    rng = np.random.default_rng(4)
    sed = rng.normal(0, 1e-3, (48, 48)).astype(np.float32)
    piles = np.where(rng.uniform(0, 1, (48, 48)) > 0.995, 0.01, 0.0).astype(np.float32)
    with jax.disable_jit():
        wk = np.asarray(JSe.kernel_disperse(jnp.asarray(sed)))
        wp = np.asarray(JSe.pile_deposit(jnp.asarray(piles), 8))
    np.testing.assert_array_equal(TSe.kernel_disperse(torch.from_numpy(sed)).numpy(), wk)
    np.testing.assert_array_equal(TSe.pile_deposit(torch.from_numpy(piles), 8).numpy(), wp)
    np.testing.assert_array_equal(TSe._triangle_taps(15), JSe._triangle_taps(15))
    # dispersal conserves mass (edge folds)
    assert abs(float(TSe.kernel_disperse(torch.from_numpy(sed)).sum()) - sed.sum()) < 1e-6


@pytest.mark.parametrize("with_piles", [False, True])
def test_write_sediment_map_matches(with_piles):
    rng = np.random.default_rng(5)
    h = rng.uniform(0.2, 0.8, (48, 48)).astype(np.float32)
    sed = rng.normal(0, 1e-4, (48, 48)).astype(np.float32)
    if with_piles:
        sed[10, 10] = sed[40, 3] = 0.01  # > PILE_THRESHOLD / HEIGHT
    params = ErosionSettings(PILING_RADIUS=6).as_parameters()
    with jax.disable_jit():
        want = np.asarray(JSe.write_sediment_map(jnp.asarray(h), jnp.asarray(sed),
                                                 params, 1000.0))
    syncs = []
    got = TSe.write_sediment_map(torch.from_numpy(h), torch.from_numpy(sed), params,
                                 1000.0, syncs=syncs).numpy()
    np.testing.assert_array_equal(got, want)
    assert syncs == ["sediment.piles"]


def test_exact_piles_not_ported():
    """``EXACT_PILES`` (once refused here) runs the exact pile solver, equal
    to the compiled reference (tests/test_torch_piles.py holds it against
    eager JAX too)."""
    params = ErosionSettings(EXACT_PILES=True, PILING_RADIUS=3).as_parameters()
    h = np.full((8, 8), 0.5, np.float32)
    sed = np.zeros((8, 8), np.float32)
    sed[3, 4] = 0.005
    sed[0, 0] = 0.003
    want = jax.jit(lambda a, b: JSe.write_sediment_map(a, b, params, 1000.0))(
        jnp.asarray(h), jnp.asarray(sed))
    got = TSe.write_sediment_map(torch.from_numpy(h), torch.from_numpy(sed), params, 1000.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.max()) > 0.5


def test_update_flow_from_track_bit_exact():
    rng = np.random.default_rng(6)
    maps = {k: rng.uniform(0, 1e-3, (32, 32)).astype(np.float32)
            for k in ("height", "pool", "flow", "track", "plants")}
    maps["track"][::3] = 0.0
    params = ErosionSettings().as_parameters()
    with jax.disable_jit():
        want = JW.update_flow_from_track(
            JW.WorldState(**{k: jnp.asarray(v) for k, v in maps.items()}), params, 1000.0)
    got = TW.update_flow_from_track(
        TW.WorldState(**{k: torch.from_numpy(v) for k, v in maps.items()}), params, 1000.0)
    for k in ("height", "pool", "flow", "track", "plants"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def _decay_maps(seed, res=32):
    """World maps and descent accumulators for the deposit and decay: pools
    straddling MINFLOWPOOL (on it, an ulp either side, ±0), tracks and
    accumulators with rows of +0 and -0, and accumulators that carry a
    pool across MINFLOWPOOL."""
    rng = np.random.default_rng(seed)
    mfp = np.float32(TW.MINFLOWPOOL)
    m = {k: rng.uniform(0, 1e-3, (res, res)).astype(np.float32)
         for k in ("height", "flow", "plants")}
    m["pool"] = rng.uniform(0, 2 * mfp, (res, res)).astype(np.float32)
    m["pool"].flat[:6] = [mfp, np.nextafter(mfp, np.float32(0)), np.nextafter(mfp, np.float32(1)),
                          0.0, -0.0, 1e-3]
    m["track"] = rng.uniform(0, 1e-4, (res, res)).astype(np.float32)
    m["track"][::3] = 0.0
    m["track"][1::5] = -0.0
    acc = {k: rng.uniform(0, 1e-4, (res, res)).astype(np.float32) for k in ("track", "pool")}
    for a in acc.values():
        a[::4] = 0.0
        a[2::7] = -0.0
    return m, acc["track"], acc["pool"]


def _same_bits(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("case", ["defaults", "tuned", "no_spawn"])
def test_deposit_and_decay_bit_exact(case):
    """``world.deposit_and_decay``'s plain path (CPU tensors) against the
    reference's deposit adds followed by its ``update_flow_from_track``,
    one primitive at a time, bit for bit (signs of zero too); without
    accumulators it is ``update_flow_from_track`` alone.  ``out`` takes the
    new flow and track, here the world's own maps."""
    maps, track_acc, pool_acc = _decay_maps(7)
    params = ErosionSettings().as_parameters()
    if case == "tuned":
        params = dataclasses.replace(params, FLOW_LOSS_RATE=float(np.float32(0.37)),
                                     SURFACE_EVAPORATION_RATE=float(np.float32(0.023)))
    spawn = case != "no_spawn"
    with jax.disable_jit():
        jw = JW.WorldState(**{k: jnp.asarray(v) for k, v in maps.items()})
        if spawn:
            jw = dataclasses.replace(
                jw, pool=jw.pool + jnp.asarray(pool_acc) * params.POOL_PLACEMENT_MULTIPLIER,
                track=jw.track + jnp.asarray(track_acc) * params.TRACK_PLACEMENT_MULTIPLIER)
        want = JW.update_flow_from_track(jw, params, 1000.0)

    def world():
        return TW.WorldState(**{k: torch.from_numpy(v.copy()) for k, v in maps.items()})

    accs = (torch.from_numpy(track_acc), torch.from_numpy(pool_acc)) if spawn else (None, None)
    got = TW.deposit_and_decay(world(), *accs, params, 1000.0)
    for k in ("height", "pool", "flow", "track", "plants"):
        _same_bits(getattr(got, k).numpy(), getattr(want, k))
    if not spawn:
        alone = TW.update_flow_from_track(world(), params, 1000.0)
        for k in ("pool", "flow", "track"):
            _same_bits(getattr(got, k).numpy(), getattr(alone, k).numpy())
    w = world()
    into = TW.deposit_and_decay(w, *accs, params, 1000.0, out=w)
    assert into.flow is w.flow and into.track is w.track and into.pool is not w.pool
    for k in ("pool", "flow", "track"):
        _same_bits(getattr(into, k).numpy(), getattr(got, k).numpy())


def test_spawn_with_drains_top_k_ties_to_lower_index():
    res, n = 16, 6
    drain = np.zeros((res, res), np.float32)
    drain.flat[[200, 3, 77, 5, 140]] = 0.5          # five-way tie
    drain.flat[250] = 0.75
    key = jax.random.PRNGKey(7)
    jparts, jleft, _ = jax.jit(
        lambda k, d: JS._spawn_with_drains(k, n, res, d))(key, jnp.asarray(drain))
    k1, _ = jax.random.split(key)
    fresh = _to_port(JPa.spawn(k1, n, res))
    tkey = convert.key_from_jax(np.asarray(key), device="cpu")
    for hook in (fresh, None):  # the test hook and the port's own spawn
        tparts, tleft, tk2 = TS._spawn_with_drains(tkey, n, res, torch.from_numpy(drain),
                                                   fresh=hook)
        for k in TPa.Particles._fields:
            np.testing.assert_array_equal(getattr(tparts, k).numpy(),
                                          np.asarray(getattr(jparts, k)))
        np.testing.assert_array_equal(tleft.numpy(), np.asarray(jleft))
        np.testing.assert_array_equal(tk2.numpy(), np.asarray(jax.random.split(key)[1]))


def _cycle_inputs(res, seed):
    meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res, height=1000,
                       margin=0)
    settings = ErosionSettings(PARTICLES_PER_CYCLE=128, MAXAGE=24, WATER_STEPS=3,
                               PILING_RADIUS=6)
    return meta, settings, _terrain(seed, res)


def test_erosion_cycles_match_reference():
    meta, settings, h = _cycle_inputs(RES, 8)
    jstate = JS.init_state(jnp.asarray(h), jax.random.PRNGKey(1))
    tstate = TS.init_state(torch.from_numpy(h))
    for _ in range(2):
        k1, _ = jax.random.split(jstate.key)
        fresh = _to_port(JPa.spawn(k1, settings.PARTICLES_PER_CYCLE, RES))
        jstate = JS.erosion_cycle(jstate, settings, meta)
        syncs = []
        tstate = TS.erosion_cycle(tstate, convert.settings_from_jax(dataclasses.asdict(settings)),
                                  convert.meta_from_jax(dataclasses.asdict(meta)),
                                  fresh=fresh, syncs=syncs)
        assert syncs[0] == "spawn.drains" and syncs[-1] == "sediment.piles"
    world, drain = convert.sim_state_to_numpy(tstate)
    for k in ("height", "pool", "flow", "plants"):
        _assert_close(world[k], getattr(jstate.world, k))
    _assert_close(drain, jstate.drain_water)
    assert not np.array_equal(world["height"], h)


def test_convert_round_trip_and_dtypes():
    world = _world(9, 16)
    state = convert.sim_state_from_numpy(world, np.ones((16, 16), np.float32), device="cpu")
    back, drain = convert.sim_state_to_numpy(state)
    for k in convert.WORLD_MAPS:
        np.testing.assert_array_equal(back[k], world[k])
    np.testing.assert_array_equal(drain, 1.0)
    parts = {k: np.asarray(v) for k, v in
             _jax_particles(jax.random.PRNGKey(2), 10, 16)._asdict().items()}
    tp = convert.particles_from_numpy(parts, device="cpu")
    assert (tp.row.dtype, tp.heading.dtype, tp.alive.dtype) == (
        torch.float32, torch.int32, torch.bool)
    for k, v in convert.particles_to_numpy(tp).items():
        np.testing.assert_array_equal(v, parts[k])
    with pytest.raises(TypeError):
        convert.particles_from_numpy({**parts, "row": parts["row"].astype(np.float64)},
                                     device="cpu")
    assert dataclasses.is_dataclass(state.world)
