"""The port's ``ErosionSim`` (``noize_tpu_torch.erosion.sim``) against
``noize_tpu.erosion.sim.ErosionSim`` at 64², on the CPU.

The port's spawn draws ``jax.random``'s threefry bits
(``noize_tpu_torch.prng``), so ``ErosionSim(seed=s).step()`` runs from the
seed alone.  Most tests also replay the reference's chain (``PRNGKey(seed)``,
split per cycle, spawn from the first half, as ``sim._spawn_with_drains``
does) into ``Particles`` and hand them to the port's ``step(fresh=...)``
test hook.

Tolerance: 1e-4 relative to each map's scale (BASELINE.md's bar), as
tests/test_torch_erosion.py holds ``erosion_cycle``: the reference runs
its compiled program, whose multiply-adds XLA contracts into FMAs, and
its tunables enter as float32 scalars (ROADMAP.md §3).  The normal map is
bit-exact and the curvature map within 1e-4 relative against the
reference on the same heights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.core.store import PipelineStateManager as JStore
from noize_tpu.erosion import sim as JS
from noize_tpu.erosion import world as JW
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.erosion.particles import spawn as jax_spawn
from noize_tpu.ops import kernels as JK
from noize_tpu_torch import convert
from noize_tpu_torch.core.store import PipelineStateManager
from noize_tpu_torch.erosion import sim as TS
from noize_tpu_torch.erosion import world as TW

RES = 64
SETTINGS = ErosionSettings(CYCLES=2, PARTICLES_PER_CYCLE=128, MAXAGE=24, WATER_STEPS=3,
                           PILING_RADIUS=6)
MAPS = ("height_map", "pool_map", "stream_map")


def _terrain(seed=8, res=RES):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    taps = JK.gaussian_taps(2.0, 9)
    for _ in range(4):
        h = np.array(JK.separable_series(jnp.asarray(h), taps, taps))
    return h


def replay_spawn(key, cycles, n, res):
    """The reference ErosionSim's spawn chain as port Particles, one per
    cycle; returns (particles, the key after the last cycle)."""
    out = []
    for _ in range(cycles):
        k1, key = jax.random.split(key)
        parts = jax_spawn(k1, n, res)
        out.append(convert.particles_from_numpy(
            {k: np.asarray(v) for k, v in parts._asdict().items()}, device="cpu"))
    return out, key


def _port_settings(s):
    return convert.settings_from_jax(dataclasses.asdict(s))


def _close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= rtol * max(np.abs(want).max(), 1e-30), gap


def _assert_sims_close(tsim, jsim):
    for m in MAPS:
        _close(getattr(tsim, m).numpy(), getattr(jsim, m))
    _close(tsim.state.drain_water.numpy(), jsim.state.drain_water)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    h = _terrain()
    jsim = JS.ErosionSim(jnp.asarray(h), settings=SETTINGS, state_manager=JStore(str(d / "j")),
                         seed=3)
    fresh, _ = replay_spawn(jax.random.PRNGKey(3), SETTINGS.CYCLES, 128, RES)
    jsim.step()
    sm = PipelineStateManager(str(d / "t"), device="cpu")
    tsim = TS.ErosionSim(h, settings=_port_settings(SETTINGS), state_manager=sm, seed=3,
                         device="cpu")
    tsim.step(fresh=fresh)
    return h, jsim, tsim


def test_step_matches_reference(sims):
    h, jsim, tsim = sims
    _assert_sims_close(tsim, jsim)
    assert tsim.cycle_count == jsim.cycle_count == SETTINGS.CYCLES
    assert not np.array_equal(tsim.height_map.numpy(), h)
    assert np.count_nonzero(tsim.stream_map.numpy()) > 50
    # 15 host syncs per cycle at most (PERF.md): drains, descent chunks, piles
    assert 0 < len(tsim.syncs) <= 15 * SETTINGS.CYCLES


def test_seeded_step_matches_reference_without_fresh(sims):
    h, jsim, tsim = sims
    seeded = TS.ErosionSim(h, settings=_port_settings(SETTINGS), seed=3, device="cpu")
    seeded.step()
    _assert_sims_close(seeded, jsim)
    np.testing.assert_array_equal(seeded.state.key.numpy(), np.asarray(jsim.state.key))
    for m in MAPS:
        np.testing.assert_array_equal(getattr(seeded, m).numpy(), getattr(tsim, m).numpy())


def test_live_retuning_matches_reference():
    h = _terrain(9)
    jsim = JS.ErosionSim(jnp.asarray(h), settings=SETTINGS, seed=4)
    tsim = TS.ErosionSim(torch.from_numpy(h), settings=_port_settings(SETTINGS), seed=4)
    key = jax.random.PRNGKey(4)
    for erosion in (1.0, 0.6):
        jsim.settings = dataclasses.replace(jsim.settings, EROSION=erosion, EVAP=0.02)
        tsim.settings = dataclasses.replace(tsim.settings, EROSION=erosion, EVAP=0.02)
        fresh, key = replay_spawn(key, 1, 128, RES)
        jsim.step(cycles=1)
        tsim.step(cycles=1, fresh=fresh)
        _assert_sims_close(tsim, jsim)


def test_resets_match_reference(sims):
    h, _, _ = sims
    jsim = JS.ErosionSim(jnp.asarray(h), settings=SETTINGS, seed=5)
    tsim = TS.ErosionSim(h, settings=_port_settings(SETTINGS), seed=5, device="cpu")
    fresh, key = replay_spawn(jax.random.PRNGKey(5), 1, 128, RES)
    jsim.step(cycles=1)
    tsim.step(cycles=1, fresh=fresh)
    jsim.reset_water()
    tsim.reset_water()
    for m in ("pool_map", "stream_map"):
        assert not getattr(tsim, m).any() and not np.asarray(getattr(jsim, m)).any()
    assert not tsim.state.world.track.any() and not tsim.state.drain_water.any()
    fresh, key = replay_spawn(key, 1, 128, RES)
    jsim.step(cycles=1)
    tsim.step(cycles=1, fresh=fresh)
    _assert_sims_close(tsim, jsim)
    jsim.reset_land()
    tsim.reset_land()
    np.testing.assert_array_equal(tsim.height_map.numpy(), h)
    np.testing.assert_array_equal(np.asarray(jsim.height_map), h)
    assert not tsim.pool_map.any()


def test_save_erosion_state(sims):
    _, jsim, tsim = sims
    names = [tsim._buffer_name(a) for a in
             ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL")]
    assert names == [jsim._buffer_name(a) for a in
                     ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL")]
    assert names[0] == "0_0__64__TERRAIN_HEIGHT"
    tsim.save_erosion_state()
    jsim.save_erosion_state()
    assert tsim.original_height is tsim.height_map
    fresh = PipelineStateManager(tsim.state_manager.serde.root.rsplit("/save__", 1)[0],
                                 device="cpu")
    for n, m in zip(names, ("height_map", "stream_map", "pool_map")):
        back = fresh.get_buffer(n)
        assert back.dtype == torch.float32
        assert torch.equal(back, getattr(tsim, m))
        _close(back.numpy(), jsim.state_manager.get_buffer(n))
    with pytest.raises(RuntimeError, match="state manager"):
        TS.ErosionSim(torch.zeros(8, 8)).save_erosion_state()


def test_curvature_and_normal_maps_match_reference(sims):
    """On the same maps (the sims' heights differ at the 1e-5 level, which
    second differences amplify)."""
    _, jsim, tsim = sims
    w = tsim.state.world
    jcurv = np.asarray(JW.curvature_map(jnp.asarray(w.height.numpy()), 1000.0, 1.0))
    np.testing.assert_array_equal(tsim.curvature().numpy(),
                                  TW.curvature_map(w.height, 1000.0, 1.0).numpy())
    _close(tsim.curvature().numpy(), jcurv)
    jw = JW.WorldState(*(jnp.asarray(getattr(w, k).numpy()) for k in
                         ("height", "pool", "flow", "track", "plants")))
    with jax.disable_jit():
        want_n = np.asarray(JW.normal_map(jw, 1000.0, 1.0))
        want_c = np.asarray(JW.curvature_map(jw.height, 1000.0, 1.0))
    np.testing.assert_array_equal(TW.normal_map(w, 1000.0, 1.0).numpy(), want_n)
    _close(TW.curvature_map(w.height, 1000.0, 1.0).numpy(), want_c)


def test_sim_defaults_and_device():
    assert dataclasses.asdict(TS.ErosionSim(torch.zeros(4, 4)).settings) == dataclasses.asdict(
        _port_settings(ErosionSettings()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.ErosionSim(np.zeros((4, 4), np.float32))
