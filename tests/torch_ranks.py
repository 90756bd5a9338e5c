"""The ranks of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_distributed.py``), on the CPU with gloo.  ``launch``
starts them; one rank is

    python tests/torch_ranks.py SUITE RANK WORLD INIT_FILE OUT_DIR

Every rank builds the same inputs from seeds with numpy, runs every case of
the suite, and rank 0 writes the results to ``OUT_DIR/SUITE.npz`` for the
tests to read.  The group starts from ``file://INIT_FILE`` (no port to
race for) with a 60 s timeout.  No JAX here: the tests compare with it.
"""

from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from noize_tpu_torch.ops import kernels as _k  # noqa: E402
from noize_tpu_torch.parallel import device_mesh as DM  # noqa: E402
from noize_tpu_torch.parallel import distributed as D  # noqa: E402
from noize_tpu_torch.parallel import halo as HA  # noqa: E402
from noize_tpu_torch.parallel import sharded_ops as SO  # noqa: E402

TIMEOUT = timedelta(seconds=60)

#: the sharded field cases: name → (op, grid side, kwargs), inputs from
#: ``field_input(name)``
FIELD_CASES = {
    "fractal": ("fractal", 64, dict(xpos=100.0, zpos=-37.0, noise_type="Simplex",
                                    octaves=4, hurst=0.4, noise_size=90.0)),
    # a hurst whose gain PyTorch's exp2 and XLA's constant folder both round
    # an ulp away from XLA's runtime exp2
    "fractal-h0.123": ("fractal", 64, dict(xpos=31.0, zpos=-17.0, noise_type="Perlin",
                                           octaves=6, hurst=0.123, noise_size=90.0)),
    "blur-g5x17": ("blur", 64, dict(width=5, sigma=1.0, iterations=17)),
    "blur-g9x2": ("blur", 128, dict(width=9, sigma=2.0, iterations=2)),
    "filter-Sobel3_2D": ("filter", 64, dict(filter_type="Sobel3_2D", iterations=2)),
    "filter-Smooth3": ("filter", 64, dict(filter_type="Smooth3", iterations=3)),
    "filter-Prewitt3Vertical": ("filter", 64, dict(filter_type="Prewitt3Vertical",
                                                   iterations=1)),
    "thermal-45x2": ("thermal", 64, dict(talus=45.0, increment_ratio=0.5,
                                         height_width_ratio=1.0, iterations=2)),
    "thermal-30x1": ("thermal", 128, dict(talus=30.0, increment_ratio=0.6,
                                          height_width_ratio=1.0, iterations=1)),
    "flow-x8": ("flow", 64, dict(iterations=8)),
    "flow-x3": ("flow", 128, dict(iterations=3, norm_min=-0.2, norm_max=0.3)),
}

#: meshes of the field suite: name → (rows, cols) of ranks
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def field_input(name: str) -> np.ndarray:
    """The case's input field: smooth noise in [0, 1] (seeded by the name)."""
    res = FIELD_CASES[name][1]
    rng = np.random.default_rng(sum(map(ord, name)))
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(3):  # a little smoothing: slopes thermal and flow act on
        h = np.apply_along_axis(lambda v: np.convolve(np.pad(v, 1, mode="edge"), k, "valid"),
                                0, h)
        h = np.apply_along_axis(lambda v: np.convolve(np.pad(v, 1, mode="edge"), k, "valid"),
                                1, h)
    return h.astype(np.float32)


def run_field(mesh, name: str):
    op, res, kw = FIELD_CASES[name]
    if op == "fractal":
        kw = dict(kw)
        return SO.sharded_fractal(mesh, res, kw.pop("xpos"), kw.pop("zpos"), **kw)
    data = torch.from_numpy(field_input(name))
    if op == "blur":
        return SO.sharded_gauss_blur(mesh, data, **kw)
    if op == "filter":
        return SO.sharded_kernel_filter(mesh, data, **kw)
    if op == "thermal":
        return SO.sharded_thermal_erosion(mesh, data, **kw)
    return SO.sharded_flow_map(mesh, data, **kw)


def _fields(rank: int, out: dict):
    for mname, shape in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("x", "y"))
        for name in FIELD_CASES:
            got = run_field(mesh, name)
            out[f"{mname}/{name}"] = got.full_tensor().numpy()
            out[f"{mname}/{name}/local_shape"] = np.asarray(got.to_local().shape)
        # a DTensor input takes the same path as the whole grid
        src = SO.sharded_fractal(mesh, 64, 3.0, 5.0, octaves=2)
        out[f"{mname}/blur-of-dtensor"] = SO.sharded_gauss_blur(
            mesh, src, 5, 1.0, 4).full_tensor().numpy()
        out[f"{mname}/blur-of-dtensor/input"] = src.full_tensor().numpy()
        # halo.exchange_2d (clamp) against the padded global grid, and
        # fold_2d as its adjoint (border "zero"): <E x, y> = <x, F y>
        g = torch.from_numpy(field_input("blur-g5x17"))
        block, _ = HA._local_block(g, mesh)
        ext = HA.exchange_2d(block, 3, mesh=mesh)
        row0, col0, lr, lc = HA._block_shape(mesh, tuple(g.shape))
        padded = torch.nn.functional.pad(g[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
        ok = torch.equal(ext, padded[row0:row0 + lr + 6, col0:col0 + lc + 6])
        rng = np.random.default_rng(100 + rank)
        x = torch.from_numpy(rng.normal(size=(lr, lc)))
        y = torch.from_numpy(rng.normal(size=(lr + 6, lc + 6)))
        ex = HA.exchange_2d(x, 3, border="zero", mesh=mesh)
        fy = HA.fold_2d(y, 3, mesh=mesh)
        sums = torch.tensor([float((ex * y).sum()), float((x * fy).sum()), float(ok)],
                            dtype=torch.float64)
        dist.all_reduce(sums)
        out[f"{mname}/adjoint"] = sums.numpy()
        # sharded_stencil: a one-pass Gauss-3 series (receptive field 1)
        taps = np.array([0.25, 0.5, 0.25], np.float32)
        box = HA.sharded_stencil(lambda e: _k.separable_series(e, taps, taps), 1, mesh)
        out[f"{mname}/stencil"] = box(g).full_tensor().numpy()
    out["split2"] = np.asarray([DM._split2(n) for n in range(1, 13)])
    mesh = DM.spatial_mesh(device="cpu")
    out["spatial_mesh"] = np.asarray(mesh.shape)
    out["hybrid_mesh"] = np.asarray(DM.hybrid_mesh(2, device="cpu").shape)
    out["batch_mesh"] = np.asarray(DM.batch_mesh(device="cpu").shape)


def tile_config(erosion: bool, emit_mesh: bool):
    from noize_tpu_torch.core.tiles import TileSetMeta
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel.tiled import TilePipelineConfig

    meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=100, margin=4)
    settings = ErosionSettings(PARTICLES_PER_CYCLE=8, MAXAGE=4, WATER_STEPS=1, CYCLES=1,
                               PILING_RADIUS=4)
    return TilePipelineConfig(meta=meta, noise_type="Perlin", octaves=3, noise_size=100.0,
                              blur_iterations=2, flow_iterations=0 if erosion else 2,
                              erosion=settings if erosion else None,
                              erosion_cycles=1 if erosion else 0, emit_mesh=emit_mesh)


def tile_origins():
    from noize_tpu_torch.parallel.tiled import grid_origins

    return grid_origins(tile_config(False, False).meta, 2, 2)


def _batch(out: dict):
    from noize_tpu_torch.parallel.tiled import tile_batch

    out["primary"] = np.asarray([D.is_primary()])
    out["multihost_tile_mesh"] = np.asarray(D.multihost_tile_mesh().shape)
    out["multihost_spatial_mesh"] = np.asarray(D.multihost_spatial_mesh().shape)
    total = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(total)  # psum across the processes
    out["psum"] = total.numpy()
    mesh = DM.batch_mesh(device="cpu")
    origins = tile_origins()
    for erosion, emit in ((False, False), (True, True)):
        got = tile_batch(tile_config(erosion, emit), origins, mesh=mesh, seed=5)
        parts = got if isinstance(got, dict) else {"height": got}
        for k, v in parts.items():
            out[f"tiles/{int(erosion)}{int(emit)}/{k}"] = v.full_tensor().numpy()
            out[f"tiles/{int(erosion)}{int(emit)}/{k}/local"] = np.asarray(v.to_local().shape)
    try:
        tile_batch(tile_config(False, False), origins[:3], mesh=mesh)
        out["refusal"] = np.asarray(["no error"])
    except ValueError as e:
        out["refusal"] = np.asarray([str(e)])


# --- the sharded erosion cycle (tests/test_torch_sharded_erosion.py) --------

#: the small cycle of tests/test_parallel.py's sharded-erosion tests
EROSION_SETTINGS = dict(PARTICLES_PER_CYCLE=48, MAXAGE=12, WATER_STEPS=3, CYCLES=1,
                        PILING_RADIUS=4)
SIM_SETTINGS = dict(PARTICLES_PER_CYCLE=16, MAXAGE=4, WATER_STEPS=2, CYCLES=1,
                    PILING_RADIUS=4)
EXACT_CASES = ("scattered", "chained", "border_clip", "overflow")
#: (case, seed, cycles) of the cycle comparisons
CYCLE_CASES = (("cycle1", 6, 1), ("cycle2", 13, 2))


def erosion_height(seed: int, res: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.2, 0.8, (res, res)).astype(np.float32)


def erosion_meta(res: int = 32):
    from noize_tpu_torch.core.tiles import TileSetMeta

    return TileSetMeta(tile_res=res, tile_size=res, generator_res=res, height=500, margin=0)


def spawn_drains(res: int = 32) -> np.ndarray:
    """A drain map with 80 wet cells in 4 tied levels (more than the 48
    particle slots) and one cell on each block corner of the meshes."""
    rng = np.random.default_rng(5)
    d = np.zeros((res, res), np.float32)
    d.reshape(-1)[rng.choice(res * res, 80, replace=False)] = \
        np.float32(0.01) * rng.integers(1, 5, 80).astype(np.float32)
    for r, c in ((7, 7), (8, 8), (15, 16), (16, 15), (23, 24)):
        d[r, c] = np.float32(0.04)
    return d


def pool_inputs(res: int = 32):
    rng = np.random.default_rng(17)
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    p = rng.uniform(-0.3, 0.1, (res, res)).clip(0).astype(np.float32)
    return h, p


def sediment_inputs(case: str, res: int = 32):
    """(height, sediment) of tests/test_parallel.py's sediment cases."""
    rng = np.random.default_rng(19 if case == "tent" else 43)
    h = rng.uniform(0.3, 0.7, (res, res)).astype(np.float32)
    sed = rng.uniform(-0.01, 0.012, (res, res)).astype(np.float32)
    if case in ("tent", "scattered"):
        sed[5, 7] = 0.5
        sed[20, 25] = 0.4
    elif case == "chained":  # supports overlap in a chain across block borders
        sed[14, 14], sed[17, 17], sed[20, 14], sed[15, 18] = 0.6, 0.5, 0.45, 0.3
    elif case == "border_clip":
        sed[0, 0], sed[2, 31], sed[31, 16] = 0.5, 0.4, 0.35
    else:  # more piles than the 64 solved
        rr = np.random.default_rng(7)
        cells = rr.choice(res * res, size=100, replace=False)
        sed.reshape(-1)[cells] = rr.uniform(0.2, 0.9, 100).astype(np.float32)
    return h, sed


def _state(seed: int, key_seed: int = 9):
    from noize_tpu_torch.erosion.sim import init_state
    from noize_tpu_torch.prng import PRNGKey

    return init_state(torch.from_numpy(erosion_height(seed)), PRNGKey(key_seed, device="cpu"))


def _put(a, mesh):
    block, shape = HA._local_block(torch.from_numpy(np.asarray(a)), mesh)
    return HA._as_field(block, mesh, shape)


def _world_out(out, prefix, state):
    for k in ("height", "pool", "flow", "track", "plants"):
        out[f"{prefix}/{k}"] = getattr(state.world, k).full_tensor().numpy()
    out[f"{prefix}/drain"] = state.drain_water.full_tensor().numpy()
    out[f"{prefix}/key"] = state.key.numpy()


def _erosion(rank: int, out: dict, out_dir: str):
    from dataclasses import replace

    from noize_tpu_torch.convert import sharded_state_from_numpy, sim_state_to_numpy
    from noize_tpu_torch.core.store import PipelineStateManager
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel import sharded_erosion as SE
    from noize_tpu_torch.parallel.sharded_checkpoint import ShardedCheckpoint
    from noize_tpu_torch.prng import PRNGKey

    meshes = {m: init_device_mesh("cpu", shape, mesh_dim_names=("x", "y"))
              for m, shape in MESHES.items()}
    settings = ErosionSettings(**EROSION_SETTINGS)
    meta = erosion_meta()
    for mname, mesh in meshes.items():
        def sharded(state):  # the JAX tests' numpy state, placed on the mesh
            world, drain = sim_state_to_numpy(state)
            return sharded_state_from_numpy(world, drain, mesh, key=state.key.numpy())

        parts, left, key = SE._sharded_spawn(mesh, _put(spawn_drains(), mesh),
                                             PRNGKey(3, device="cpu"), 48, 32)
        for f in parts._fields:
            out[f"{mname}/spawn/{f}"] = getattr(parts, f).numpy()
        out[f"{mname}/spawn/leftover"] = left.full_tensor().numpy()
        out[f"{mname}/spawn/key"] = key.numpy()
        # the descent alone, on cycle1's world with 48 fresh particles
        from noize_tpu_torch.erosion.particles import spawn

        st = sharded(_state(6))
        parts = spawn(PRNGKey(4, device="cpu"), 48, 32)
        got = SE._sharded_descent(mesh, st.world, parts, settings.as_parameters(), 500.0, 1, 32,
                                  chunk=4)
        for f in got[0]._fields:
            out[f"{mname}/descent/{f}"] = getattr(got[0], f).numpy()
        for k, acc in zip(("track", "pool", "sed"), got[1:]):
            out[f"{mname}/descent/{k}"] = acc.full_tensor().numpy()
        h, p = pool_inputs()
        for dp in (True, False):
            gp, gd = SE._sharded_pool_automata(mesh, _put(h, mesh), _put(p, mesh), 32, 3, dp)
            out[f"{mname}/pool/{int(dp)}/pool"] = gp.full_tensor().numpy()
            out[f"{mname}/pool/{int(dp)}/drains"] = gd.full_tensor().numpy()
        for case in ("tent",) + EXACT_CASES:
            hh, sed = sediment_inputs(case)
            params = ErosionSettings(PILING_RADIUS=4,
                                     EXACT_PILES=case != "tent").as_parameters()
            got = SE._sharded_write_sediment(mesh, _put(hh, mesh), _put(sed, mesh), params,
                                             500.0)
            out[f"{mname}/sediment/{case}"] = got.full_tensor().numpy()
        for case, seed, cycles in CYCLE_CASES:
            state = sharded(_state(seed))
            for _ in range(cycles):
                state = SE.sharded_erosion_cycle(mesh, state, settings, meta, chunk=4)
            _world_out(out, f"{mname}/{case}", state)
        state = sharded(_state(31))
        _world_out(out, f"{mname}/tuned/static",
                   SE.sharded_erosion_cycle(mesh, state, settings, meta, chunk=4))
        _world_out(out, f"{mname}/tuned/traced",
                   SE.sharded_erosion_cycle(mesh, state, settings.canonical(), meta, chunk=4,
                                            tuned=settings.tunable_values()))
        # an EXACT_PILES cycle, on the same inputs as cycle1
        state = SE.sharded_erosion_cycle(mesh, sharded(_state(6)),
                                         replace(settings, EXACT_PILES=True), meta, chunk=4)
        _world_out(out, f"{mname}/exact_cycle", state)

        # the sim: per-shard checkpoint, resume bit-exact
        store = os.path.join(out_dir, f"store_{mname}")
        sim_settings = ErosionSettings(**SIM_SETTINGS)
        a = SE.ShardedErosionSim(mesh, erosion_height(31), settings=sim_settings, chunk=4,
                                 state_manager=PipelineStateManager(store, device="cpu"))
        a.step(1)
        a.save_erosion_state()
        key_at_save = a.state.key
        b = SE.ShardedErosionSim(mesh, np.zeros((32, 32), np.float32), settings=sim_settings,
                                 chunk=4, state_manager=PipelineStateManager(store, device="cpu"))
        b.restore_erosion_state()
        b.state = replace(b.state, key=key_at_save)
        _world_out(out, f"{mname}/sim/saved", a.state)
        _world_out(out, f"{mname}/sim/restored", b.state)
        a.step(1)
        b.step(1)
        _world_out(out, f"{mname}/sim/a", a.state)
        _world_out(out, f"{mname}/sim/b", b.state)
        out[f"{mname}/sim/cycles"] = np.asarray([a.cycle_count, b.cycle_count])
        # the inherited surface: resets, the continuous mode, curvature, maps
        b.reset_water()
        pool_sum = float(b.pool_map.full_tensor().sum())
        b.reset_land()
        land = torch.equal(b.height_map.full_tensor(), b.original_height.full_tensor())
        states = [b.update()]
        while states[-1] != "completed":
            states.append(b.update(continuous=False))
        out[f"{mname}/sim/surface"] = np.asarray(
            [pool_sum == 0.0, land, states[0] == "triggered", b.cycle_count == 2,
             bool(torch.isfinite(b.curvature()).all()), tuple(b.plant_map.shape) == (32, 32)])
        files = os.listdir(os.path.join(store, "save__default_0", f"save__proc{rank}_0", "data"))
        out[f"{mname}/sim/files"] = np.asarray([len(files)])
        # a replicated array: one block, loaded on (mesh, placements)
        from torch.distributed.tensor import Replicate

        ck = ShardedCheckpoint(os.path.join(out_dir, f"rep_{mname}"))
        ck.save("key", torch.arange(4, dtype=torch.int32))
        ck.flush()
        back = ck.load("key", (mesh, [Replicate(), Replicate()]))
        out[f"{mname}/ckpt/replicated"] = np.asarray(
            [ck.exists("key"), torch.equal(back.to_local(), torch.arange(4, dtype=torch.int32)),
             ck.load("absent", mesh) is None])
        other = meshes["4x1" if mname == "2x2" else "2x2"]
        try:
            ShardedCheckpoint(a.state_manager.serde.root).load(
                a._buffer_name("TERRAIN_HEIGHT"), other)
            out[f"{mname}/sim/mismatch"] = np.asarray(["no error"])
        except IOError as e:
            out[f"{mname}/sim/mismatch"] = np.asarray([str(e)])


def _sim_one_rank(out: dict, out_dir: str):
    """World size 1: the sim checkpoints through the store."""
    from dataclasses import replace

    from noize_tpu_torch.core.store import PipelineStateManager
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel import sharded_erosion as SE

    mesh = DM.spatial_mesh(device="cpu")
    store = os.path.join(out_dir, "store")
    st = ErosionSettings(**SIM_SETTINGS)
    a = SE.ShardedErosionSim(mesh, erosion_height(31), settings=st, chunk=4,
                             state_manager=PipelineStateManager(store, device="cpu"))
    a.step(1)
    a.save_erosion_state()
    b = SE.ShardedErosionSim(mesh, np.zeros((32, 32), np.float32), settings=st, chunk=4,
                             state_manager=PipelineStateManager(store, device="cpu"))
    b.restore_erosion_state()
    b.state = replace(b.state, key=a.state.key)
    a.step(1)
    b.step(1)
    _world_out(out, "sim1/a", a.state)
    _world_out(out, "sim1/b", b.state)
    out["sim1/manifest"] = np.asarray(sorted(
        a.state_manager.serde.directory.entries))


def launch(suite: str, world: int, tmp_path, timeout: float = 120.0):
    """Run ``world`` ranks of ``suite``; kill every rank if any outlives
    ``timeout``; return rank 0's results."""
    init = tmp_path / "init"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r), str(world), str(init),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return dict(np.load(tmp_path / f"{suite}.npz"))


# --- the sharded mesh (tests/test_torch_sharded_mesh.py) -------------------

MESH_MARGINS = (0, 1, 8)
MESH_VARIANTS = ("overshoot", "square")
MESH_LAYOUTS = ("arrays", "planes")


def mesh_height(inp: int = 64) -> np.ndarray:
    return np.random.default_rng(3).uniform(0, 1, (inp, inp)).astype(np.float32)


def _mesh_suite(rank: int, out: dict, out_dir: str):
    from noize_tpu_torch.parallel import sharded_mesh as SM

    inp = 64
    a = torch.from_numpy(mesh_height(inp))
    for mname, shape in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("x", "y"))
        ash = _put(a.numpy(), mesh)
        for margin in MESH_MARGINS:
            r = inp - 2 * margin
            for variant in MESH_VARIANTS:
                for layout in MESH_LAYOUTS:
                    key = f"{mname}/{margin}/{variant}/{layout}"
                    fields = SM.sharded_heightmap_mesh(mesh, ash, r, inp, 500.0, float(r),
                                                       variant=variant, layout=layout)
                    if layout == "planes":
                        got = SM.mesh_planes_from_fields(fields, r, inp, shape)
                        out[f"{key}/planes"] = got.planes.numpy()
                        out[f"{key}/field_shape"] = np.asarray(fields["planes"].shape)
                    else:
                        got = SM.mesh_arrays_from_fields(fields, r, inp, shape)
                        for f in ("positions", "normals", "tangents", "uvs"):
                            out[f"{key}/{f}"] = getattr(got, f).numpy()
                        out[f"{key}/field_shape"] = np.asarray(fields["positions"].shape)
                    out[f"{key}/indices"] = got.indices.numpy()
        # the sim's mesh fields
        from noize_tpu_torch.erosion.params import ErosionSettings
        from noize_tpu_torch.parallel.sharded_erosion import ShardedErosionSim

        sim = ShardedErosionSim(mesh, erosion_height(29),
                                settings=ErosionSettings(PARTICLES_PER_CYCLE=8, MAXAGE=4,
                                                         WATER_STEPS=1, CYCLES=1,
                                                         PILING_RADIUS=4), chunk=4)
        sim.step(1)
        f = sim.mesh_fields()
        out[f"{mname}/sim/positions"] = f["positions"].full_tensor().numpy()
        out[f"{mname}/sim/planes"] = sim.mesh_fields(layout="planes")["planes"].full_tensor().numpy()
        out[f"{mname}/sim/height"] = sim.height_map.full_tensor().numpy()


# --- TileServer(mesh=) (tests/test_torch_app.py) ----------------------------

SERVER_ORDERS = [(x, z) for z in range(2) for x in range(3)]


def _server(rank: int, out: dict, out_dir: str):
    from noize_tpu_torch.app.server import TileServer

    mesh = DM.batch_mesh(device="cpu")
    results = {}
    for erosion in (False, True):
        srv = TileServer(tile_config(erosion, False), batch_size=4, mesh=mesh, seed=5,
                         max_wait_ms=50.0)
        if srv.controller:
            for i, pos in enumerate(SERVER_ORDERS):
                srv.submit(f"t{i}", pos, on_complete=lambda st: results.__setitem__(
                    (erosion, st.request.uuid), st))
        try:
            srv.start()
            out[f"{int(erosion)}/drained/{rank}"] = np.asarray([srv.drain(timeout=90.0)])
        finally:
            srv.stop()
        out[f"{int(erosion)}/batches/{rank}"] = np.asarray([srv.batches])
        if srv.controller:
            for i in range(len(SERVER_ORDERS)):
                st = results[(erosion, f"t{i}")]
                assert st.error is None, st.error
                out[f"{int(erosion)}/t{i}"] = st.heights.numpy()
            out[f"{int(erosion)}/served"] = np.asarray([srv.served])
    flags = torch.tensor([1.0 if out[f"{e}/drained/{rank}"][0] else 0.0 for e in (0, 1)])
    dist.all_reduce(flags)
    out["drained"] = flags.numpy()
    # a batch the mesh does not divide: tile_batch's error, per order
    srv = TileServer(tile_config(False, False), batch_size=3, mesh=mesh, max_wait_ms=50.0)
    errors = []
    if srv.controller:
        srv.submit("odd", (0, 0), on_complete=lambda st: errors.append(str(st.error)))
    try:
        srv.start()
        srv.drain(timeout=60.0)
    finally:
        srv.stop()
    if srv.controller:
        out["uneven"] = np.asarray(errors)


def _examples(rank: int, out: dict, out_dir: str):
    """``examples/multichip_field_torch.py`` at its FAST sizes on this group
    (tests/test_torch_examples.py)."""
    import importlib.util

    os.environ["NOIZE_EXAMPLE_FAST"] = "1"  # the example reads it at import
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "multichip_field_torch.py")
    spec = importlib.util.spec_from_file_location("examples_multichip_field_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.FAST
    out.update(mod.main(os.path.join(out_dir, "sharded_ckpt"), device="cpu"))


SUITES = {
    "erosion": _erosion,
    "sim1": lambda rank, out, out_dir: _sim_one_rank(out, out_dir),
    "mesh": _mesh_suite,
    "server": _server,
    "examples": _examples,
}


def main():
    suite, rank, world, init_file, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    out = {}
    if suite == "batch":
        assert D.initialize(f"file://{init_file}", world, rank, device="cpu")
        _batch(out)
    elif suite in SUITES:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                                rank=rank, timeout=TIMEOUT)
        SUITES[suite](rank, out, out_dir)
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                                rank=rank, timeout=TIMEOUT)
        _fields(rank, out)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{suite}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
