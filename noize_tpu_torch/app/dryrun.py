"""The multi-device dry run; port of ``__graft_entry__.dryrun_multichip``.

    python -m noize_tpu_torch.app.dryrun N [--device cpu|cuda]

runs both production axes end to end on ``N`` ranks, at tiny shapes:

* sp — one field sharded over an (x, y) mesh: sharded fractal, Gauss blur
  (K1) and flow map (K2), one sharded erosion cycle (K3, descent, pool on
  K5 windows), one with ``EXACT_PILES`` (K6's table solve), and the
  sharded mesh of the eroded field;
* dp — whole tiles a rank: ``tile_batch`` with erosion on a ``batch``
  mesh.

Each rank is a process of its own (``N`` processes, a ``torch.distributed``
group over a file in a temporary directory): on the cards with NCCL, one
card a rank; on the CPU with gloo.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

#: seconds a dry run may take before its ranks are killed
TIMEOUT = 600.0


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Run the sp and dp paths on ``n_devices`` ranks (one card each on
    ``device="cuda"``, gloo processes on the CPU); raises if a rank fails
    or a check does not hold."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): only "
                               f"{torch.cuda.device_count()} CUDA devices")
    root = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as d:
        init = os.path.join(d, "init")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "noize_tpu_torch.app.dryrun", "--worker", str(r),
             str(n_devices), init, device.type],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, log[-2000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError(f"dryrun_multichip({n_devices}) ranks failed: {bad}")


def _finite(t) -> bool:
    return bool(torch.isfinite(t.full_tensor() if hasattr(t, "full_tensor") else t).all())


def _body(n_devices: int, device: str) -> None:
    """The dry run on this rank (every rank runs it)."""
    from dataclasses import replace

    from ..core.tiles import TileSetMeta
    from ..erosion.params import ErosionSettings
    from ..erosion.sim import init_state
    from ..parallel import device_mesh as DM
    from ..parallel import sharded_ops as SO
    from ..parallel import tiled as TL
    from ..parallel.sharded_erosion import sharded_erosion_cycle
    from ..parallel.sharded_mesh import mesh_arrays_from_fields, sharded_heightmap_mesh
    from ..prng import PRNGKey

    # sp: one field sharded over (x, y), halos exchanged between ranks
    mesh = DM.spatial_mesh(device=device)
    nx, ny = mesh.shape
    res = 16 * max(nx, ny)
    h = SO.sharded_fractal(mesh, res, 0.0, 0.0, noise_type="Simplex", octaves=3, hurst=0.4,
                           noise_size=100.0)
    h = SO.sharded_gauss_blur(mesh, h, 5, 1.0, iterations=2)
    v = SO.sharded_flow_map(mesh, h, iterations=3)
    assert tuple(v.shape) == (res, res) and _finite(v)

    # the full erosion cycle on the sharded field, then with EXACT_PILES
    h0 = torch.clamp(v * 0.5 + 0.25, 0.0, 1.0)
    emeta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res, height=500, margin=0)
    es = ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=6, WATER_STEPS=2, CYCLES=1,
                         PILING_RADIUS=4)
    dev = h0.to_local().device
    estate = sharded_erosion_cycle(mesh, init_state(h0, PRNGKey(3, device=dev)), es, emeta,
                                   chunk=4)
    assert tuple(estate.world.height.shape) == (res, res)
    assert _finite(estate.world.height) and _finite(estate.world.pool)
    ex = sharded_erosion_cycle(mesh, init_state(h0, PRNGKey(4, device=dev)),
                               replace(es, EXACT_PILES=True), emeta, chunk=4)
    assert _finite(ex.world.height)

    # the sharded mesh of the eroded field
    fields = sharded_heightmap_mesh(mesh, estate.world.height, emeta.tile_res, res,
                                    float(emeta.height), float(emeta.tile_size))
    assert tuple(fields["positions"].shape) == (res + nx, res + ny, 3)
    marr = mesh_arrays_from_fields(fields, emeta.tile_res, res, (nx, ny))
    assert tuple(marr.positions.shape) == ((emeta.tile_res + 1) ** 2, 3)
    assert bool(torch.isfinite(marr.normals).all())

    # dp: whole tiles a rank, erosion included
    bmesh = DM.batch_mesh(device=device)
    meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=100,
                       margin=4).validate()
    settings = ErosionSettings(PARTICLES_PER_CYCLE=32, MAXAGE=6, WATER_STEPS=2, CYCLES=1,
                               PILING_RADIUS=4)
    cfg = TL.TilePipelineConfig(meta=meta, noise_type="Perlin", octaves=3, noise_size=64.0,
                                blur_iterations=2, erosion=settings, erosion_cycles=1)
    tiles = TL.tile_batch(cfg, TL.grid_origins(meta, n_devices, 1), mesh=bmesh)
    assert tuple(tiles.shape) == (n_devices, 32, 32) and _finite(tiles)


def _worker(rank: int, n_devices: int, init: str, device: str) -> None:
    from ..parallel.distributed import initialize

    initialize(f"file://{init}", n_devices, rank, device=device)
    try:
        _body(n_devices, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"dryrun_multichip worker {rank}/{n_devices} OK")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "N", "INIT", "DEVICE"))
    args = ap.parse_args(argv)
    if args.worker:
        rank, n, init, device = args.worker
        _worker(int(rank), int(n), init, device)
        return 0
    if args.n_devices is None:
        ap.error("the number of devices is required")
    dryrun_multichip(args.n_devices, device=args.device)
    print(f"dryrun_multichip({args.n_devices}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
