"""Production tile serving on the PyTorch port — TileServer batching with
in-batch mesh emission and file export, the journey of
``examples/serving_tiles.py`` through ``noize_tpu_torch``.

Don't generate tiles one-by-one (the reference's one-tile-per-frame
queue); batch them.  This example stands up a TileServer whose config
erodes every tile and emits component-major vertex planes, submits a ring
of requests, and exports one served tile as OBJ.

Run:  python examples/serving_tiles_torch.py [outdir] [--device cpu]
(the card by default; ``--device cpu`` runs the kernels' plain versions)
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_torch_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# No compile cache to configure: the port compiles no program, and its
# CUDA kernels build once into build/ on first use.
from noize_tpu_torch.app import mesh_export
from noize_tpu_torch.app.server import TileServer
from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion.params import ErosionSettings
from noize_tpu_torch.ops.mesh import MeshPlanes, grid_indices
from noize_tpu_torch.parallel import device_mesh as DM
from noize_tpu_torch.parallel import tiled as TL


def main(outdir="out/serving", *, device="cuda"):
    os.makedirs(outdir, exist_ok=True)
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8).validate()
        es = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                             WATER_STEPS=2, CYCLES=1, PILING_RADIUS=4)
        octaves, blur_iters = 4, 2
    else:
        meta = TileSetMeta(tile_res=192, tile_size=192, generator_res=256,
                           height=1000, margin=32).validate()
        es = ErosionSettings(PARTICLES_PER_CYCLE=300, MAXAGE=32,
                             WATER_STEPS=4, CYCLES=1, PILING_RADIUS=8)
        octaves, blur_iters = 8, 5
    cfg = TL.TilePipelineConfig(
        meta=meta, octaves=octaves, noise_size=900.0,
        blur_iterations=blur_iters, erosion=es,
        erosion_cycles=1,
        emit_mesh=True,
    )
    # dp scale-out: whole tiles a rank when a process group of more than
    # one rank exists (every rank runs this; rank 0 takes the orders)
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    mesh = DM.batch_mesh() if grouped else None
    srv = TileServer(cfg, batch_size=8, mesh=mesh, max_wait_ms=20.0,
                     device=device).start()
    if not srv.controller:
        srv.drain(timeout=600)  # follow the controller's batches until it stops
        return

    # Two waves: the first pays the process's first calls (PyTorch's
    # first uses of its ops; on the card the kernels' build if nothing
    # built them yet); the second is the steady-state serving number.
    # The server waits for each batch on the device before delivering it.
    done = []
    for wave in ("cold", "warm"):
        wave_done = []
        t0 = time.perf_counter()
        for z in range(2):
            for x in range(4):
                srv.submit(f"tile_{x}_{z}_{wave}", (x, z),
                           on_complete=wave_done.append)
        assert srv.drain(timeout=600)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{wave}: served {len(wave_done)} tiles in {dt:.0f} ms "
              f"({dt / len(wave_done):.1f} ms/tile incl. erosion + mesh, "
              f"batches={srv.batches})")
        done.extend(wave_done)
    srv.stop()

    st = next(s for s in done if s.request.uuid == "tile_1_0_warm")
    planes = MeshPlanes(st.mesh_planes,
                        grid_indices(meta.tile_res, device=st.mesh_planes.device))
    obj = os.path.join(outdir, "tile_1_0.obj")
    mesh_export.to_obj(obj, planes)
    print("exported", obj, f"({planes.vertex_count} verts,"
          f" {planes.index_count // 3} tris)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="out/serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.outdir, device=args.device)
