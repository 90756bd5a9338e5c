"""The port's app layer (``noize_tpu_torch.app``: tile generator, bakery,
visualize, drawers, server, CLI) against ``noize_tpu.app`` on the CPU, at
32² tiles.

Tolerances:
  * textures, PNG/RAW16 bytes and CLI loaders: byte for byte on the same
    arrays; the terrain texture's curvature channel within one byte (the
    port's curvature is within 1e-4 relative of the reference's,
    tests/test_torch_sim.py, and a quantization step may flip);
  * maps made by a pipeline, a sim or a mesh: 1e-4 of each map's scale
    (BASELINE.md's bar; the reference runs compiled XLA programs whose
    multiply-adds are contracted, ROADMAP §3); the CLI's demo output, a
    flow map normalised by 0.2 (×5), within 1e-4 of its scale too;
  * the TileServer: its tiles equal ``tile_batch``'s bit for bit.

Every threaded test bounds its waits (``drain(timeout=...)``) and stops
its server in a ``finally``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.app import bakery as JB
from noize_tpu.app import cli as JC
from noize_tpu.app import drawers as JD
from noize_tpu.app import tile_generator as JG
from noize_tpu.app import visualize as JV
from noize_tpu.core.store import PipelineStateManager as JStore
from noize_tpu.core.tiles import TileSetMeta as JMeta
from noize_tpu.erosion.params import ErosionSettings as JSettings
from noize_tpu.erosion.sim import ErosionSim as JSim
from noize_tpu.ops import mesh as JM
from noize_tpu.pipeline import stages as JS
from noize_tpu.pipeline.driver import Pipeline as JPipeline
from noize_tpu_torch import convert
from noize_tpu_torch.app import bakery as TB
from noize_tpu_torch.app import cli as TC
from noize_tpu_torch.app import drawers as TD
from noize_tpu_torch.app import server as TSV
from noize_tpu_torch.app import tile_generator as TG
from noize_tpu_torch.app import visualize as TV
from noize_tpu_torch.core.store import PipelineStateManager
from noize_tpu_torch.erosion.sim import ErosionSim
from noize_tpu_torch.ops import mesh as TM
from noize_tpu_torch.parallel import tiled as TT
from noize_tpu_torch.pipeline import stages as TS
from noize_tpu_torch.pipeline.driver import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMETA = JMeta(tile_res=24, tile_size=24, generator_res=32, height=100, margin=4)
META = convert.meta_from_jax(dataclasses.asdict(JMETA))
JEROSION = JSettings(PARTICLES_PER_CYCLE=32, MAXAGE=6, CYCLES=1, WATER_STEPS=2,
                     PILING_RADIUS=4)
EROSION = convert.settings_from_jax(dataclasses.asdict(JEROSION))
RNG = np.random.default_rng(23)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= rtol * max(np.abs(want).max(), 1e-30), gap


def _sources(sm=None, jsm=None):
    port = Pipeline([TS.NoiseStage(noiseType="Perlin", octaves=3, noiseSize=64),
                     TS.WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT")],
                    state_manager=sm, device="cpu")
    ref = JPipeline([JS.NoiseStage(noiseType="Perlin", octaves=3, noiseSize=64),
                     JS.WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT")],
                    state_manager=jsm)
    return port, ref


# --- tile generator ----------------------------------------------------------

@pytest.fixture(scope="module")
def generators():
    """The reference's and the port's DemoTileGenerator over a 2 x 2 grid,
    one erosion step each."""
    port_src, ref_src = _sources()
    tgen = TG.DemoTileGenerator(port_src, meta=META, erosion_settings=EROSION,
                                device="cpu")
    jgen = JG.DemoTileGenerator(ref_src, meta=JMETA, erosion_settings=JEROSION)
    tgen.start(1, 1)
    jgen.start(1, 1)
    before = {k: c.mesh.positions.clone() for k, c in tgen.children.items()}
    tgen.step_erosion(cycles=1)
    jgen.step_erosion(cycles=1)
    return tgen, jgen, before


def test_demo_generator_matches_reference(generators):
    tgen, jgen, _ = generators
    assert sorted(tgen.children) == sorted(jgen.children) and len(tgen.children) == 4
    for key, tc in tgen.children.items():
        jc = jgen.children[key]
        assert tc.position_ws == jc.position_ws and tc.request == TG.TileRequest(
            uuid=jc.request.uuid, pos=jc.request.pos)
        assert tc.erosion.tile_pos == jc.erosion.tile_pos
        _close(tc.erosion.original_height, jc.erosion.original_height)
        for m in ("height_map", "pool_map", "stream_map"):
            _close(getattr(tc.erosion, m), getattr(jc.erosion, m))
        for f in ("positions", "tangents", "uvs"):
            _close(getattr(tc.mesh, f), getattr(jc.mesh, f))
        np.testing.assert_array_equal(_np(tc.mesh.indices).astype(np.int64),
                                      np.asarray(jc.mesh.indices).astype(np.int64))


def test_generator_remeshes_after_erosion(generators):
    tgen, _, before = generators
    child = tgen.children["(0, 0)"]
    assert child.mesh.vertex_count == (META.tile_res + 1) ** 2
    assert float((child.mesh.positions - before["(0, 0)"]).abs().max()) > 0
    assert torch.equal(child.mesh.positions, tgen.mesh_for(child.erosion.height_map).positions)


def test_generator_queue_and_store():
    sm = PipelineStateManager(device="cpu")
    src, _ = _sources(sm)
    gen = TG.MeshTileGenerator(src, meta=META, state_manager=sm, erosion_settings=EROSION,
                               gen_tile_offset=(1, 0), device="cpu")
    assert sm.get_buffer("__G_TileSetMeta") == META
    gen.enqueue("a", (0, 1))
    assert gen.update() is True and gen.update() is False
    assert list(gen.children) == ["(1, 1)"] and not gen.active_tiles
    assert torch.equal(gen.children["(1, 1)"].erosion.original_height,
                       sm.get_buffer(META.buffer_name((1, 1), "TERRAIN_HEIGHT")))
    with pytest.raises(ValueError):
        gen.enqueue("b", (0, 1))
    gen.remove((1, 1))
    with pytest.raises(KeyError):
        gen.remove((1, 1))


def test_generator_publishes_meta_to_disk(tmp_path):
    sm = PipelineStateManager(str(tmp_path), "w", "1", device="cpu")
    jsm = JStore(str(tmp_path / "ref"), "w", "1")
    src, ref_src = _sources(sm, jsm)
    TG.MeshTileGenerator(src, meta=META, state_manager=sm, device="cpu")
    JG.MeshTileGenerator(ref_src, meta=JMETA, state_manager=jsm)
    np.testing.assert_array_equal(sm.serde.load("__G_TileSetMeta"),
                                  jsm.serde.load("__G_TileSetMeta"))


def test_generator_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path cannot be exercised")
    src, _ = _sources()
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.MeshTileGenerator(src, meta=META)


# --- bakery ------------------------------------------------------------------

def test_bakery_matches_reference():
    h = RNG.uniform(0, 1, (12, 12)).astype(np.float32)
    tmesh = TM.heightmap_mesh(torch.from_numpy(h), 8, 12, 10.0, 10.0)
    jmesh = JM.heightmap_mesh(jnp.asarray(h), 8, 12, 10.0, 10.0)
    tb, jb = TB.MeshBakery(max_batch=2), JB.MeshBakery(max_batch=2)
    tdone, jdone = [], []
    for bak, mesh, done, order in ((tb, tmesh, tdone, TB.MeshBakeOrder),
                                   (jb, jmesh, jdone, JB.MeshBakeOrder)):
        assert bak.enqueue(order("m1", mesh, done.append))
        assert not bak.enqueue(order("m1", mesh))  # in flight
        assert bak.enqueue(order("m2", mesh, done.append))
        assert bak.enqueue(order("m3", mesh, done.append))
        n, ms = bak.service()
        assert n == 2 and ms >= 0 and len(bak.queue) == 1
        bak.drain()
        assert not bak.enqueue(order("m1", mesh))  # baked
    assert tdone == jdone == ["m1", "m2", "m3"]
    for f in ("positions", "normals", "tangents", "uvs", "indices"):
        got, want = getattr(tb.known["m2"], f), getattr(jb.known["m2"], f)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        _close(got, want)


# --- visualize ---------------------------------------------------------------

def test_byte_channels_and_textures_match_reference():
    res, tile = 32, 24
    pool = RNG.uniform(0, 0.002, (res, res)).astype(np.float32)
    stream = RNG.uniform(0, 0.8, (res, res)).astype(np.float32)
    height = RNG.uniform(0, 1, (res, res)).astype(np.float32)
    for scale in (1.0, 3.0, 1000.0):
        np.testing.assert_array_equal(
            TV.to_byte_channel(torch.from_numpy(stream), tile, scale).numpy(),
            np.asarray(JV.to_byte_channel(jnp.asarray(stream), tile, scale)))
    np.testing.assert_array_equal(
        TV.water_control_texture(torch.from_numpy(pool), torch.from_numpy(stream), tile),
        JV.water_control_texture(jnp.asarray(pool), jnp.asarray(stream), tile))
    got = TV.terrain_control_texture(torch.from_numpy(height), torch.from_numpy(stream), tile,
                                     100.0, 1.0)
    want = JV.terrain_control_texture(jnp.asarray(height), jnp.asarray(stream), tile,
                                      100.0, 1.0)
    assert got.dtype == np.uint8 and got.shape == (tile, tile, 4)
    np.testing.assert_array_equal(got[..., [0, 2, 3]], want[..., [0, 2, 3]])
    assert np.abs(got[..., 1].astype(int) - want[..., 1].astype(int)).max() <= 1
    np.testing.assert_array_equal(TV.black_texture(8), JV.black_texture(8))


@pytest.mark.parametrize("kind", ["png", "png_scaled", "rgba", "png16", "png16_scaled",
                                  "raw16", "raw16_noflip"])
def test_file_bytes_match_reference(tmp_path, kind):
    gray = RNG.uniform(-3, 900, (16, 16)).astype(np.float32)
    rgba = RNG.integers(0, 256, (8, 8, 4)).astype(np.uint8)
    call = {
        "png": ("to_png", gray, {}), "png_scaled": ("to_png", gray, {"scale": 0.001}),
        "rgba": ("to_png", rgba, {}), "png16": ("to_png16", gray, {}),
        "png16_scaled": ("to_png16", gray, {"scale": 0.002}),
        "raw16": ("to_raw16", gray, {}),
        "raw16_noflip": ("to_raw16", gray, {"scale": 0.001, "flip_vertical": False}),
    }[kind]
    fn, arr, kw = call
    got = getattr(TV, fn)(str(tmp_path / "port"), torch.from_numpy(arr), **kw)
    want = getattr(JV, fn)(str(tmp_path / "ref"), arr, **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_render_pipeline_matches_reference():
    got = TV.render_pipeline(Pipeline([TS.NoiseStage(octaves=2)], device="cpu"), 16,
                             xpos=10, zpos=20)
    want = JV.render_pipeline(JPipeline([JS.NoiseStage(octaves=2)]), 16, xpos=10, zpos=20)
    _close(got, want)
    with pytest.raises(ValueError):
        TV.to_png("unused.png", np.zeros((2, 2, 2)))


# --- drawers -----------------------------------------------------------------

class _Maps:
    """An IProvideGeodata source: three maps."""

    def __init__(self, height, pool, stream):
        self.height_map, self.pool_map, self.stream_map = height, pool, stream


@pytest.fixture(scope="module")
def sims():
    h = RNG.uniform(0, 1, (32, 32)).astype(np.float32)
    jsim = JSim(jnp.asarray(h), settings=JEROSION, meta=JMETA)
    jsim.step(1)
    tsim = ErosionSim(h, settings=EROSION, meta=META, device="cpu")
    tsim.step(1)
    return h, jsim, tsim


def test_stream_drawer_matches_reference(sims, tmp_path):
    _, jsim, tsim = sims
    maps = [np.asarray(getattr(jsim, m)) for m in ("height_map", "pool_map", "stream_map")]
    tdraw = TD.StreamDrawer(_Maps(*(torch.from_numpy(np.array(m)) for m in maps)), META)
    jdraw = JD.StreamDrawer(_Maps(*(jnp.asarray(m) for m in maps)), JMETA)
    (tw, tt), (jw, jt) = tdraw.refresh(), jdraw.refresh()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tt[..., [0, 2, 3]], jt[..., [0, 2, 3]])
    assert np.abs(tt[..., 1].astype(int) - jt[..., 1].astype(int)).max() <= 1
    live = TD.StreamDrawer(tsim, META)
    paths = live.export(str(tmp_path / "live"))
    assert [os.path.basename(p) for p in paths] == ["tile_water.png", "tile_terrain.png"]
    assert live.water_control.shape == (META.tile_res, META.tile_res, 4)


def test_tile_drawer_from_checkpoint(sims, tmp_path):
    h, _, _ = sims
    sm = PipelineStateManager(str(tmp_path / "saves"), "d", "1", device="cpu")
    sim = ErosionSim(h, settings=EROSION, meta=META, state_manager=sm, tile_pos=(1, 2),
                     device="cpu")
    sim.step(1)
    sim.save_erosion_state()
    fresh = PipelineStateManager(str(tmp_path / "saves"), "d", "1", device="cpu")
    paths = TD.TileDrawer(fresh, META, tile_pos=(1, 2)).draw(str(tmp_path / "out"))
    assert [os.path.basename(p) for p in paths] == ["tile_1_2_height.png",
                                                    "tile_1_2_water.png"]
    JV.to_png(str(tmp_path / "want.png"), sim.height_map.numpy())
    with open(paths[0], "rb") as a, open(tmp_path / "want.png", "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(FileNotFoundError):
        TD.TileDrawer(PipelineStateManager(device="cpu"), META, (9, 9)).draw(str(tmp_path))


# --- TileServer --------------------------------------------------------------

def _serve(cfg, n, batch_size, seed=0, on_complete=None):
    """Submit ``n`` tiles (i, 0); wait at most 120 s; return (server, served
    tiles by uuid)."""
    srv = TSV.TileServer(cfg, batch_size=batch_size, max_wait_ms=50.0, seed=seed,
                         device="cpu")
    done, lock = {}, threading.Lock()

    def collect(st):
        with lock:
            done[st.request.uuid] = st
        if on_complete is not None:
            on_complete(st)
    try:
        srv.start()
        for i in range(n):
            srv.submit(f"t{i}", (i, 0), on_complete=collect)
        assert srv.drain(timeout=120)
    finally:
        srv.stop()
    return srv, done


def _cfg(**kw):
    kw = {"noise_type": "Perlin", **kw}
    return TT.TilePipelineConfig(meta=META, octaves=2, noise_size=64.0, blur_iterations=1,
                                 **kw)


def test_server_batches_equal_tile_batch():
    cfg = _cfg(erosion=EROSION, erosion_cycles=1)
    srv, done = _serve(cfg, 6, 4, seed=5)
    assert len(done) == 6 and srv.served == 6 and srv.batches >= 2 and not srv.errors
    want = TT.tile_batch(cfg, TT.grid_origins(META, 6, 1), seed=5, device="cpu")
    for i in range(6):
        st = done[f"t{i}"]
        assert st.error is None and st.mesh_planes is None and st.latency_ms > 0
        assert torch.equal(st.heights, want[i])


def test_server_delivers_mesh_planes():
    cfg = _cfg(emit_mesh=True)
    srv, done = _serve(cfg, 3, 2)
    assert len(done) == 3 and srv.batches == 2 and not srv.errors
    want = TT.tile_batch(cfg, TT.grid_origins(META, 3, 1), device="cpu")
    tr = META.tile_res
    for i in range(3):
        st = done[f"t{i}"]
        assert tuple(st.mesh_planes.shape) == (12, tr + 1, tr + 1)
        assert torch.equal(st.mesh_planes, want["mesh_planes"][i])
        assert torch.equal(st.heights, want["height"][i])
    # seams across the batch boundary (tiles 1 and 2): away from the blur's
    # clamped borders the overlap agrees
    overlap, b = META.generator_res - META.tile_res, 2
    np.testing.assert_allclose(done["t1"].heights[b:-b, META.tile_res + b:-b].numpy(),
                               done["t2"].heights[b:-b, b:overlap - b].numpy(), atol=1e-5)


def test_server_delivers_errors_per_order():
    srv, done = _serve(_cfg(noise_type="NoSuchNoise"), 5, 4)
    assert len(done) == 5 and srv.served == 0 and srv.batches == 0
    assert all(isinstance(st.error, ValueError) and st.heights is None for st in done.values())
    assert len(srv.errors) == 2  # one per failed batch

    def boom(st):
        if st.request.uuid == "t0":
            raise RuntimeError("client callback failed")
    srv, done = _serve(_cfg(), 2, 2, on_complete=boom)
    assert len(done) == 2 and srv.served == 2 and len(srv.errors) == 1
    assert all(st.error is None for st in done.values())


def test_server_refusals_and_idle_drain():
    with pytest.raises(ValueError, match="'batch' axis"):
        TSV.TileServer(_cfg(), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TSV.TileServer(_cfg())
    srv = TSV.TileServer(_cfg(), device="cpu")
    assert srv.drain(timeout=1.0)  # nothing submitted
    srv.submit("x", (0, 0))
    assert not srv.drain(timeout=0.2)  # not started: the order waits
    try:
        srv.start()
        assert srv.drain(timeout=60)
    finally:
        srv.stop()
    assert srv.served == 1


# --- CLI ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """The demo, a run config and erode through both CLIs (``--device cpu``
    for the port)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = {"name": "t", "resolution": 16, "stages": [
        {"stage": "NoiseStage", "noiseType": "Cellular", "octaves": 2},
        {"stage": "ConstantStage", "operation": "BINARIZE", "value": 0.4}]}
    (root / "cfg.json").write_text(json.dumps(cfg))
    erode = ["erode", "--resolution", "32", "--cycles", "1", "--mesh", "--heightmap16"]
    for pkg, main, extra in (("port", TC.main, ["--device", "cpu"]), ("ref", JC.main, [])):
        out = str(root / pkg)
        main(["demo", "-o", out, "--resolution", "32"] + extra)
        main(["run", str(root / "cfg.json"), "-o", out] + extra)
        main(erode + ["-o", out + "_erode"] + extra)
    return root


@pytest.mark.parametrize("name", ["demo.npy", "t.npy"])
def test_cli_outputs_match_reference(cli_outputs, name):
    got = np.load(cli_outputs / "port" / name)
    want = np.load(cli_outputs / "ref" / name)
    assert got.dtype == want.dtype == np.float32
    _close(got, want)
    png = name.replace(".npy", ".png")
    assert os.path.getsize(cli_outputs / "port" / png) > 0


def test_cli_erode_matches_reference(cli_outputs):
    port, ref = cli_outputs / "port_erode", cli_outputs / "ref_erode"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == sorted([
        "terrain.npy", "terrain.png", "eroded_height.png", "pool.png", "stream.png",
        "eroded_height.png16.png", "eroded_height.raw", "tile.obj", "tile.npz"])
    _close(np.load(port / "terrain.npy"), np.load(ref / "terrain.npy"))
    # the eroded heights, min-max normalised to uint16: within 1e-4 of the range
    got = np.fromfile(port / "eroded_height.raw", "<u2").astype(np.int64)
    want = np.fromfile(ref / "eroded_height.raw", "<u2").astype(np.int64)
    assert got.shape == want.shape == (32 * 32,)
    assert np.abs(got - want).max() <= 1e-4 * 65535
    tmesh, jmesh = np.load(port / "tile.npz"), np.load(ref / "tile.npz")
    assert sorted(tmesh.files) == sorted(jmesh.files)
    _close(tmesh["positions"], jmesh["positions"])


def test_cli_loaders_and_errors(tmp_path):
    a = RNG.uniform(100, 900, (20, 26)).astype(np.float32)
    np.save(tmp_path / "dem.npy", a)
    np.savez(tmp_path / "dem.npz", height=a)
    TV.to_raw16(str(tmp_path / "dem.raw"), a[:, :20], scale=0.001)
    for f in ("dem.npy", "dem.npz", "dem.raw"):
        np.testing.assert_array_equal(TC._load_heightmap(str(tmp_path / f)),
                                      JC._load_heightmap(str(tmp_path / f)))
    (tmp_path / "bad.raw").write_bytes(b"\x00" * 10)
    for mod in (TC, JC):
        with pytest.raises(SystemExit):
            mod._load_heightmap(str(tmp_path / "bad.raw"))
    with pytest.raises(SystemExit) as te:
        TC.build_pipeline({"stages": [{"stage": "Nope"}]}, device="cpu")
    with pytest.raises(SystemExit) as je:
        JC.build_pipeline({"stages": [{"stage": "Nope"}]})
    assert str(te.value) == str(je.value)
    assert sorted(TC.STAGE_TYPES) == sorted(JC.STAGE_TYPES)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            TC.main(["demo", "-o", str(tmp_path)])  # --device defaults to cuda


def test_cli_runs_as_a_module(tmp_path):
    """``python -m noize_tpu_torch.app.cli erode --input`` on an odd grid."""
    np.save(tmp_path / "dem.npy", RNG.uniform(0, 1, (17, 17)).astype(np.float32))
    proc = subprocess.run(
        [sys.executable, "-m", "noize_tpu_torch.app.cli", "erode", "--input",
         str(tmp_path / "dem.npy"), "--cycles", "1", "-o", str(tmp_path / "out"),
         "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loaded from" in proc.stdout and "erosion: 1 cycles" in proc.stdout
    assert os.path.exists(tmp_path / "out" / "eroded_height.png")
