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


def main():
    suite, rank, world, init_file, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    out = {}
    if suite == "batch":
        assert D.initialize(f"file://{init_file}", world, rank, device="cpu")
        _batch(out)
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
