"""The port's whole flagship slice against noize_tpu's, on the CPU, at the
``__graft_entry__.entry()`` configuration (256² generator, 8 octaves,
blur ×5, flow ×4, one erosion cycle of 256 particles, mesh on).

The port's spawn draws ``jax.random``'s threefry bits from the same key
(``noize_tpu_torch.prng``), so the step runs from the seed alone; the
``fresh`` test hook (the JAX spawn handed in, as ``sim._spawn_with_drains``
builds it) is held to the same result.

Tolerance: 1e-4 relative to each map's scale (BASELINE.md's bar) for
height, pool, stream, flow velocity and the mesh positions, tangents and
uvs.  Measured on this configuration: ≤ 2e-5.  The gap is ulp drift from
the reference's compiled CPU program (XLA contracts multiply-adds into
FMAs in the noise and blur, ROADMAP.md §3); the particles take the same
cells and the pool map comes out identical.  Normals are a ratio of
height differences to |n|, which is small on flat ground and amplifies
that drift, so the flagship's normals are held to 5e-3 absolute, and the
mesh math itself is checked at 1e-5 on the port's own heights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.app import flagship as JF
from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.erosion.particles import spawn as jax_spawn
from noize_tpu.ops import mesh as JM
from noize_tpu_torch import convert
from noize_tpu_torch.app import flagship as TF
from noize_tpu_torch.prng import PRNGKey


def entry_config():
    meta = TileSetMeta(tile_res=240, tile_size=240, generator_res=256, height=1000,
                       margin=8).validate()
    settings = ErosionSettings(PARTICLES_PER_CYCLE=256, MAXAGE=16, WATER_STEPS=4,
                               CYCLES=1, PILING_RADIUS=8)
    kw = dict(octaves=8, blur_iterations=5, flow_iterations=4, erosion_cycles=1)
    return meta, settings, kw


@pytest.fixture(scope="module")
def outputs():
    meta, settings, kw = entry_config()
    key = jax.random.PRNGKey(0)
    jstep, _, _ = JF.make_tile_step(meta, settings, **kw)
    want = jax.device_get(jstep(np.float32(0), np.float32(0), key))
    k1, _ = jax.random.split(key)
    parts = jax_spawn(k1, settings.PARTICLES_PER_CYCLE, meta.generator_res)
    fresh = [convert.particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()}, device="cpu")]
    tstep, tmeta, tsettings = TF.make_tile_step(
        convert.meta_from_jax(dataclasses.asdict(meta)),
        convert.settings_from_jax(dataclasses.asdict(settings)), device="cpu", **kw)
    got = tstep(0.0, 0.0, PRNGKey(0, device="cpu"), fresh=fresh)
    return meta, want, got, tstep


def _close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= rtol * max(np.abs(want).max(), 1e-30), gap


@pytest.mark.parametrize("key", ["height", "pool", "stream", "flow_velocity"])
def test_maps_match_reference(outputs, key):
    _, want, got, _ = outputs
    _close(got[key].numpy(), want[key])


def test_seeded_step_matches_reference_without_fresh(outputs):
    meta, want, fresh_got, tstep = outputs
    got = tstep(0.0, 0.0, PRNGKey(0, device="cpu"))
    for k in ("height", "pool", "stream", "flow_velocity"):
        _close(got[k].numpy(), want[k])
        np.testing.assert_array_equal(got[k].numpy(), fresh_got[k].numpy())


def test_erosion_really_ran(outputs):
    _, want, got, tstep = outputs
    assert np.count_nonzero(got["stream"].numpy()) > 100
    assert np.count_nonzero(got["pool"].numpy()) > 10
    assert tstep.syncs[0] == "spawn.drains" and "descent.alive" in tstep.syncs


def test_mesh_matches_reference(outputs):
    meta, want, got, _ = outputs
    m, w = got["mesh"], want["mesh"]
    for f in ("positions", "tangents", "uvs"):
        _close(getattr(m, f).numpy(), getattr(w, f))
    np.testing.assert_allclose(m.normals.numpy(), np.asarray(w.normals), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(m.indices.numpy().astype(np.int64),
                                  np.asarray(w.indices).astype(np.int64))
    # the mesh math alone, on the port's own eroded heights
    own = JM.heightmap_mesh_overshoot(jnp.asarray(got["height"].numpy()), meta.tile_res,
                                      meta.generator_res, float(meta.height),
                                      float(meta.tile_size))
    np.testing.assert_allclose(m.normals.numpy(), np.asarray(own.normals), rtol=0, atol=1e-5)


def test_step_keys_and_planes_layout():
    meta, settings, kw = entry_config()
    small = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=1000,
                        margin=4).validate()
    step, _, _ = TF.make_tile_step(small, ErosionSettings(PARTICLES_PER_CYCLE=16,
                                                          MAXAGE=4, WATER_STEPS=1),
                                   device="cpu", octaves=3, blur_iterations=2,
                                   flow_iterations=2, erosion_cycles=2,
                                   mesh_layout="planes")
    out = step(5.0, 7.0, PRNGKey(1, device="cpu"))
    assert set(out) == {"height", "flow_velocity", "pool", "stream", "mesh"}
    assert out["mesh"].planes.shape == (12, 25, 25)
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("height", "pool", "stream"))
    with pytest.raises(ValueError):
        TF.make_tile_step(small, device="cpu", mesh_layout="bogus")


def test_cuda_step_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.make_tile_step(device="cuda")


def test_defaults_mirror_reference():
    # the port keeps its own copies of the dataclasses: compare field by field
    assert dataclasses.asdict(TF.default_meta()) == dataclasses.asdict(JF.default_meta())
    got = dataclasses.asdict(TF.default_settings())
    want = dataclasses.asdict(JF.default_settings())
    assert got.pop("BEHAVIOR").name == want.pop("BEHAVIOR").name
    assert got == want
