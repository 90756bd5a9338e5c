"""The port's user journeys (``examples/*_torch.py``) at their
NOIZE_EXAMPLE_FAST sizes on the CPU, held against the JAX examples.

Each port example runs once (a module fixture) with ``device="cpu"`` and
its outputs must exist, as ``tests/test_examples.py`` asserts for the JAX
ones.  Then:

* full_tile: the JAX example and the port example write ``saves/`` into
  two directories; both are read through the port's ``core.serde`` and
  every tile's height, pool and stream map holds BASELINE.md's bar.
* serving: ``tile_1_0.obj`` of both runs, vertex positions at the same
  bar; the served heights too.  The normals of the two OBJs are not held
  to each other: the JAX example runs compiled XLA, whose contracted
  multiply-adds move the eroded heights by ~3e-7 of their scale, and with
  a height of 1000 over one unit a cell the normals move ~2e-4.  The mesh
  stage is held instead on equal inputs: the port's planes of the JAX
  run's served heights against the JAX OBJ's normals, at the mesh tests'
  1e-5.
* multichip: the port example on 4 gloo ranks as subprocesses
  (``tests/torch_ranks.py``, suite ``examples``; the JAX multichip example
  is not run: its sharded compiles take ~85 s here).  Its sp field against
  the JAX single-device fractal → Gauss blur ×3 → thermal → flow map, its
  sharded checkpoint restored bit-equal, and its dp tiles against the
  port's ``generate_tile`` of each origin.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from torch_ranks import launch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

#: BASELINE.md's bar for maps and positions, relative to the reference's
#: largest magnitude
RTOL = 1e-4
#: mesh normals, absolute (the mesh tests' bar)
NORMAL_ATOL = 1e-5


def _load(name):
    """The example module, with FAST set before it is executed (FAST is
    read at import)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NOIZE_EXAMPLE_FAST", "1")
        spec = importlib.util.spec_from_file_location(
            f"examples_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert mod.FAST
    return mod


def _rel_gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _recording(server_cls, served):
    """``server_cls`` whose orders also hand each served tile to
    ``served`` (by tile id)."""

    class Recording(server_cls):
        def submit(self, tile_id, pos, on_complete=None):
            def done(st):
                served[tile_id] = st
                if on_complete is not None:
                    on_complete(st)
            super().submit(tile_id, pos, on_complete=done)

    return Recording


@pytest.mark.parametrize("name", ["full_tile_workflow_torch", "serving_tiles_torch",
                                  "multichip_field_torch"])
def test_torch_example_defaults_to_the_card(name, tmp_path):
    """``main()`` runs on the card unless told otherwise: without one it
    raises, and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the example runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _load(name).main(str(tmp_path / "out"))


# --- full_tile ---------------------------------------------------------------


@pytest.fixture(scope="module")
def full_tile(tmp_path_factory):
    out = tmp_path_factory.mktemp("full_tile")
    _load("full_tile_workflow_torch").main(str(out / "torch"), device="cpu")
    _load("full_tile_workflow").main(str(out / "jax"))
    return out


def _saves(root):
    from noize_tpu_torch.core.serde import SerdeManager

    sm = SerdeManager(str(root / "saves"), "island", "v1")
    names = sorted(p.name[:-len(".data")]
                   for p in (root / "saves" / "save__island_v1" / "data").glob("*.data"))
    return {n: sm.load(n) for n in names}


def test_full_tile_workflow_torch_writes_its_outputs(full_tile):
    out = full_tile / "torch"
    assert (out / "saves").is_dir()
    assert list(out.glob("*.png")), "drawers exported no images"
    assert (out / "restored_00_height.png").is_file()
    assert (out / "restored_00_water.png").is_file()


def test_full_tile_saves_match_jax(full_tile):
    got, want = _saves(full_tile / "torch"), _saves(full_tile / "jax")
    assert sorted(got) == sorted(want)
    maps = [n for n in want if n.endswith(("TERRAIN_HEIGHT", "WATERMAP_POOL",
                                           "WATERMAP_STREAM"))]
    assert len(maps) == 12, maps  # 4 tiles × height, pool, stream
    for n in maps:
        assert _rel_gap(got[n], want[n]) <= RTOL, n
    np.testing.assert_array_equal(got["__G_TileSetMeta"], want["__G_TileSetMeta"])


# --- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    out = tmp_path_factory.mktemp("serving")
    runs = {}
    for side, name in (("torch", "serving_tiles_torch"), ("jax", "serving_tiles")):
        mod = _load(name)
        served = {}
        mod.TileServer = _recording(mod.TileServer, served)
        if side == "torch":
            mod.main(str(out / side), device="cpu")
        else:
            mod.main(str(out / side))
        runs[side] = served
    return out, runs


def _obj(path):
    v, vn = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                v.append([float(x) for x in line.split()[1:]])
            elif line.startswith("vn "):
                vn.append([float(x) for x in line.split()[1:]])
    return np.asarray(v), np.asarray(vn)


def test_serving_tiles_torch_serves_both_waves_and_exports(serving):
    out, runs = serving
    obj = out / "torch" / "tile_1_0.obj"
    assert obj.is_file() and obj.stat().st_size > 0
    served = runs["torch"]
    assert sorted(served) == sorted(f"tile_{x}_{z}_{w}" for w in ("cold", "warm")
                                    for z in range(2) for x in range(4))
    assert all(st.error is None for st in served.values())


def test_served_heights_match_jax(serving):
    _, runs = serving
    for tid, st in runs["jax"].items():
        got = runs["torch"][tid].heights.cpu().numpy()
        assert _rel_gap(got, np.asarray(st.heights)) <= RTOL, tid


def test_served_obj_positions_match_jax(serving):
    out, _ = serving
    pos, _ = _obj(out / "torch" / "tile_1_0.obj")
    want, _ = _obj(out / "jax" / "tile_1_0.obj")
    assert pos.shape == want.shape == (49 * 49, 3)
    assert _rel_gap(pos, want) <= RTOL


def test_port_mesh_of_jax_heights_matches_jax_obj_normals(serving):
    from noize_tpu_torch.ops.mesh import heightmap_mesh_overshoot_planes

    out, runs = serving
    heights = torch.from_numpy(np.array(runs["jax"]["tile_1_0_warm"].heights))
    mesh = heightmap_mesh_overshoot_planes(heights, 48, 64, 1000.0, 48.0)
    pos, nrm = _obj(out / "jax" / "tile_1_0.obj")
    assert _rel_gap(mesh.positions.numpy(), pos) <= RTOL
    assert float(np.abs(mesh.normals.numpy() - nrm).max()) <= NORMAL_ATOL


# --- multichip ---------------------------------------------------------------

#: the dp path's FAST tile configuration in examples/multichip_field_torch.py
DP_META = dict(tile_res=48, tile_size=48, generator_res=64, height=1000, margin=8)
DP_EROSION = dict(PARTICLES_PER_CYCLE=64, MAXAGE=8, CYCLES=1, WATER_STEPS=2, PILING_RADIUS=4)


@pytest.fixture(scope="module")
def multichip(tmp_path_factory):
    out = tmp_path_factory.mktemp("multichip")
    return launch("examples", 4, out), out


def test_multichip_field_torch_on_four_ranks(multichip):
    res, out = multichip
    assert res["velocity"].shape == res["height"].shape == (256, 256)
    assert res["tiles"].shape == (4, 64, 64)
    assert np.isfinite(res["velocity"]).all() and np.isfinite(res["tiles"]).all()
    # four ranks: the checkpoint is per shard, one directory a rank
    assert len(list((out / "sharded_ckpt").glob("*/save__proc*_0"))) == 4


def test_multichip_checkpoint_restores_bit_equal(multichip):
    res, _ = multichip
    np.testing.assert_array_equal(res["restored"], res["eroded"])


def test_multichip_sp_field_matches_jax_single_device(multichip):
    from noize_tpu.ops.blur import gauss_blur
    from noize_tpu.ops.flow import flow_map
    from noize_tpu.ops.fractal import fractal
    from noize_tpu.ops.thermal import thermal_erosion

    res, _ = multichip
    h = fractal(256, 0, 0, noise_type="Simplex", octaves=4, hurst=0.4, noise_size=1700.0)
    for _ in range(3):
        h = gauss_blur(h, 5, 1.0)
    h = thermal_erosion(h, 45.0, 0.5, 1.0, iterations=2)
    v = flow_map(h, iterations=4)
    assert _rel_gap(res["height"], jax.device_get(h)) <= RTOL
    assert _rel_gap(res["velocity"], jax.device_get(v)) <= RTOL


def test_multichip_dp_tiles_equal_generate_tile(multichip):
    from noize_tpu_torch.core.tiles import TileSetMeta
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel import tiled as TL
    from noize_tpu_torch.prng import PRNGKey, fold_in

    res, _ = multichip
    cfg = TL.TilePipelineConfig(meta=TileSetMeta(**DP_META), octaves=4, noise_size=900.0,
                                blur_iterations=2, erosion=ErosionSettings(**DP_EROSION),
                                erosion_cycles=1)
    origins = res["origins"]
    np.testing.assert_array_equal(origins, TL.grid_origins(cfg.meta, 4, 1))
    for i, (x, z) in enumerate(origins):
        key = fold_in(fold_in(PRNGKey(0, device="cpu"), int(x)), int(z))
        want = TL.generate_tile(cfg, np.float32(x), np.float32(z), key)
        np.testing.assert_array_equal(res["tiles"][i], want.numpy())
