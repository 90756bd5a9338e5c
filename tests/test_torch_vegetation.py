"""The port's vegetation layer (``noize_tpu_torch.erosion.vegetation``) and
the ``VEGETATION_FRICTION`` descent against ``noize_tpu`` on the same
inputs and keys, on the CPU.

Tolerances:
  * ``can_survive``, ``root_plants``, ``splat_density``, ``grow``,
    ``grow_cycle`` and ``density_map``: bit-equal to JAX evaluated one
    primitive at a time (``jax.disable_jit()``): the same threefry bits,
    the same first-true pick, duplicates splatted in plant order;
  * the plant gather of a descent step: bit-equal to eager JAX;
  * descent with plants: trajectories, track and pool exact and sediment
    within 1e-4 relative of the compiled reference, as
    tests/test_torch_erosion.py holds descent without plants (the port
    multiplies by the float32 reciprocal where the compiled program does);
  * one ``ErosionSim.step()`` with plants: 1e-4 relative to each map's
    scale, as tests/test_torch_sim.py holds a step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.erosion import particles as JPa
from noize_tpu.erosion import sim as JS
from noize_tpu.erosion import vegetation as JV
from noize_tpu.erosion import world as JW
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.ops import kernels as JK
from noize_tpu_torch import convert
from noize_tpu_torch.erosion import particles as TPa
from noize_tpu_torch.erosion import sim as TS
from noize_tpu_torch.erosion import vegetation as TV
from noize_tpu_torch.erosion import world as TW

HS = 1000.0
PATCH = 0.5  # normal.y = 2·patch² = 0.5 passes the default max_angle of 1


def _world(res, seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    taps = JK.gaussian_taps(2.0, 9)
    for _ in range(3):
        h = np.array(JK.separable_series(jnp.asarray(h), taps, taps))
    pool = np.where(rng.uniform(0, 1, (res, res)) < 0.2,
                    rng.uniform(0, 1e-3, (res, res)), 0.0).astype(np.float32)
    flow = rng.uniform(0, 0.8, (res, res)).astype(np.float32)
    track = np.where(rng.uniform(0, 1, (res, res)) < 0.5, 1.0, 0.0).astype(np.float32)
    plants = rng.uniform(0, 1.6, (res, res)).astype(np.float32)
    return dict(height=h, pool=pool, flow=flow, track=track, plants=plants)


def _states(world):
    return (JW.WorldState(**{k: jnp.asarray(v) for k, v in world.items()}),
            TW.WorldState(**{k: torch.from_numpy(v.copy()) for k, v in world.items()}))


def _tkey(key):
    return convert.key_from_jax(np.asarray(key), device="cpu")


def _plants_equal(got, want):
    for k in TV.Plants._fields:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


PTYPE = dict(type_idx=2, density_modifier=0.7, max_angle=1.0, spawn_range=2.0,
             max_density=1.0, max_pool_survival=1e-4, max_stream_survival=0.5,
             max_spawn_attempts=8)


def test_plant_type_and_fields_match():
    assert [f.name for f in dataclasses.fields(TV.PlantType)] == \
        [f.name for f in dataclasses.fields(JV.PlantType)]
    assert dataclasses.asdict(TV.PlantType()) == dataclasses.asdict(JV.PlantType())
    assert TV.Plants._fields == JV.Plants._fields
    pt = convert.plant_type_from_jax(dataclasses.asdict(JV.PlantType(**PTYPE)))
    assert pt == TV.PlantType(**PTYPE)


@pytest.mark.parametrize("res,patch", [(32, PATCH), (64, PATCH), (64, 1.0)])
def test_can_survive_bit_equal(res, patch):
    jw, tw = _states(_world(res, 1))
    ptype = JV.PlantType(**PTYPE)
    with jax.disable_jit():
        want = np.asarray(JV.can_survive(ptype, jw, HS, patch))
    got = TV.can_survive(TV.PlantType(**PTYPE), tw, HS, patch).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() == (patch == PATCH)  # patch 1: normal.y = 2 fails every cell


@pytest.mark.parametrize("res,n", [(32, 300), (128, 1000)])
def test_root_plants_and_density_bit_equal(res, n):
    jw, tw = _states(_world(res, 2))
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        jp = JV.root_plants(key, JV.PlantType(**PTYPE), jw, n, HS, PATCH)
        jd = JV.density_map((res, res), jp, JV.PlantType(**PTYPE))
        js = JV.splat_density(jw.plants, jp, 0.25)
    tp = TV.root_plants(_tkey(key), TV.PlantType(**PTYPE), tw, n, HS, PATCH)
    _plants_equal(tp, jp)
    alive = np.asarray(jp.alive)
    assert 0 < alive.sum() < n  # some plants found no survivable cell
    cells = np.asarray(jp.row) * res + np.asarray(jp.col)
    assert len(np.unique(cells)) < n  # duplicates: splats add in plant order
    np.testing.assert_array_equal(
        TV.density_map((res, res), tp, TV.PlantType(**PTYPE)).numpy(), np.asarray(jd))
    np.testing.assert_array_equal(TV.splat_density(tw.plants, tp, 0.25).numpy(),
                                  np.asarray(js))


def test_splat_density_border_clamp():
    res = 16
    plants = TV.Plants(type_idx=torch.zeros(4, dtype=torch.int32),
                       growth=torch.tensor([100, 50, 20, 80], dtype=torch.int32),
                       row=torch.tensor([0, 15, 0, 7], dtype=torch.int32),
                       col=torch.tensor([0, 15, 9, 7], dtype=torch.int32),
                       height=torch.zeros(4), alive=torch.tensor([True, True, True, False]))
    jplants = JV.Plants(*[jnp.asarray(v.numpy()) for v in plants])
    with jax.disable_jit():
        want = np.asarray(JV.splat_density(jnp.zeros((res, res)), jplants))
    got = TV.splat_density(torch.zeros((res, res)), plants).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[7, 7] == 0.0  # a dead plant splats nothing


@pytest.mark.parametrize("seed", [0, 1])
def test_splat_density_per_plant_magnitude_in_plant_order(seed):
    """40,000 plants on a 64² map (about ten a cell, and a stamp has nine
    cells) with a per-plant magnitude from N(0, 1): every sum bit-equal to
    JAX's one primitive at a time, whose scatters add each cell's values
    in plant order.  One CPU ``index_put_`` of 32768 values or more adds
    with atomics across threads in no fixed order (ROADMAP.md §3), so the
    stamps go through ``particles.scatter_events`` (pieces of 32767), here
    with four threads."""
    res, n = 64, 40_000
    rng = np.random.default_rng(seed)
    plants = TV.Plants(type_idx=torch.zeros(n, dtype=torch.int32),
                       growth=torch.full((n,), 20, dtype=torch.int32),
                       row=torch.from_numpy(rng.integers(0, res, n).astype(np.int32)),
                       col=torch.from_numpy(rng.integers(0, res, n).astype(np.int32)),
                       height=torch.zeros(n),
                       alive=torch.from_numpy(rng.uniform(0, 1, n) < 0.9))
    mag = rng.normal(0, 1, n).astype(np.float32)
    base = rng.uniform(0, 1.6, (res, res)).astype(np.float32)
    jplants = JV.Plants(*[jnp.asarray(v.numpy()) for v in plants])
    with jax.disable_jit():
        want = np.asarray(JV.splat_density(jnp.asarray(base), jplants, jnp.asarray(mag)))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = TV.splat_density(torch.from_numpy(base), plants, torch.from_numpy(mag)).numpy()
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got, want)


def test_grow_and_grow_cycles_bit_equal():
    res, n = 64, 400
    world = _world(res, 3)
    jw, tw = _states(world)
    pt = TV.PlantType(**PTYPE)
    jpt = JV.PlantType(**PTYPE)
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        jp = JV.root_plants(key, jpt, jw, n, HS, PATCH)
    tp = TV.root_plants(_tkey(key), pt, tw, n, HS, PATCH)
    # ground moves under some plants; some grow to maturity
    rng = np.random.default_rng(4)
    moved = world["height"] + np.where(rng.uniform(0, 1, (res, res)) < 0.3, 2e-3,
                                       0.0).astype(np.float32)
    world2 = dict(world, height=moved.astype(np.float32))
    jw2, tw2 = _states(world2)
    with jax.disable_jit():
        jg = JV.grow(jp, jw2)
    _plants_equal(TV.grow(tp, tw2), jg)
    growth = rng.integers(0, 101, n).astype(np.int32)
    jp = jp._replace(growth=jnp.asarray(growth))
    tp = tp._replace(growth=torch.from_numpy(growth.copy()))
    for cycle in range(3):
        ck = jax.random.fold_in(key, cycle)
        with jax.disable_jit():
            jp = JV.grow_cycle(ck, jp, jw2, jpt, HS, PATCH, mature_at=60)
        tp = TV.grow_cycle(_tkey(ck), tp, tw2, pt, HS, PATCH, mature_at=60)
        _plants_equal(tp, jp)
        assert tp.growth.dtype == torch.int32
    with jax.disable_jit():
        jd = JV.density_map((res, res), jp, jpt)
    np.testing.assert_array_equal(TV.density_map((res, res), tp, pt).numpy(), np.asarray(jd))
    assert int(np.asarray(jp.alive).sum()) > 0


def test_plants_from_jax_round_trip():
    jw, _ = _states(_world(32, 6))
    with jax.disable_jit():
        jp = JV.root_plants(jax.random.PRNGKey(2), JV.PlantType(**PTYPE), jw, 50, HS, PATCH)
    _plants_equal(convert.plants_from_jax(jp, device="cpu"), jp)


def _dense_plants(res, seed):
    """A world whose plant map carries up to 4 canopies a cell, so the
    min(plants, 2) cap is exercised."""
    world = _world(res, seed)
    world["plants"] = np.random.default_rng(seed).uniform(0, 4, (res, res)).astype(np.float32)
    return world


def test_gather_with_plants_bit_equal_to_eager():
    res = 64
    world = _dense_plants(res, 7)
    jw, tw = _states(world)
    params = ErosionSettings(VEGETATION_FRICTION=5.0).as_parameters()
    rng = np.random.default_rng(8)
    row = rng.integers(0, res, 64).astype(np.int32)
    col = rng.integers(0, res, 64).astype(np.int32)
    maps = TPa.step_maps(tw, params, HS)
    assert maps.numel() == 4 * res * res
    with jax.disable_jit():
        wih = HS * (jw.height + jw.pool)
        combo = jnp.concatenate([wih.reshape(-1),
                                 (wih + params.FLOW_HEIGHT_CONTRIBUTION * jw.flow).reshape(-1),
                                 jw.flow.reshape(-1), jw.plants.reshape(-1)])
        want = JPa._gather_step_values(combo, jnp.asarray(row), jnp.asarray(col), res,
                                       with_plants=True)
    np.testing.assert_array_equal(maps.numpy(), np.asarray(combo))
    got = TPa._gather_step_values(maps, torch.from_numpy(row), torch.from_numpy(col), res,
                                  with_plants=True)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[3].max()) > 2.0  # the min(plants, 2) cap is exercised


def _assert_close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def test_descent_with_vegetation_friction_matches_reference():
    res = 64
    world = _dense_plants(res, 9)
    jw, tw = _states(world)
    params = ErosionSettings(MAXAGE=16, VEGETATION_FRICTION=5.0).as_parameters()
    jp = JPa.spawn(jax.random.PRNGKey(4), 64, res)
    tp = convert.particles_from_numpy({k: np.array(v) for k, v in jp._asdict().items()},
                                      device="cpu")
    jout = jax.jit(lambda p, w: JPa.descend_all(p, w, params, HS, PATCH, res))(jp, jw)
    tout = TPa.descend_all(tp, tw, params, HS, PATCH, res)
    for k in ("row", "col", "heading", "age", "alive", "water"):
        np.testing.assert_array_equal(getattr(tout[0], k).numpy(),
                                      np.asarray(getattr(jout[0], k)), err_msg=k)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))  # track
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))  # pool
    _assert_close(tout[3].numpy(), jout[3])                             # sediment
    # the friction changes the descent: without plants the velocities differ
    bare = TPa.descend_all(tp, tw, ErosionSettings(MAXAGE=16).as_parameters(), HS, PATCH,
                           res)
    assert not torch.equal(bare[0].vel, tout[0].vel)


def test_sim_step_with_plants_matches_reference():
    res = 64
    world = _dense_plants(res, 10)
    settings = ErosionSettings(CYCLES=2, PARTICLES_PER_CYCLE=128, MAXAGE=24, WATER_STEPS=3,
                               PILING_RADIUS=6, VEGETATION_FRICTION=5.0)
    h = world["height"]
    jsim = JS.ErosionSim(jnp.asarray(h), settings=settings, seed=3)
    jsim.state.world.plants = jnp.asarray(world["plants"])
    jsim.step()
    tsim = TS.ErosionSim(h, settings=convert.settings_from_jax(dataclasses.asdict(settings)),
                         seed=3, device="cpu")
    tsim.state.world.plants = torch.from_numpy(world["plants"].copy())
    tsim.step()
    for m in ("height_map", "pool_map", "stream_map", "plant_map"):
        _assert_close(getattr(tsim, m).numpy(), getattr(jsim, m))
    _assert_close(tsim.state.drain_water.numpy(), jsim.state.drain_water)
    assert not np.array_equal(tsim.height_map.numpy(), h)
