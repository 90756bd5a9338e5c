"""End-to-end tile workflow on the PyTorch port — the MeshTileGenerator
user journey of ``examples/full_tile_workflow.py``, through
``noize_tpu_torch``.

Generates a 2x2 tile grid (noise → blur → context store), live-erodes each
tile for a few cycles, re-meshes, exports PNGs and a checkpoint, then
restores the checkpoint in a fresh store and renders it with TileDrawer.

Run:  python examples/full_tile_workflow_torch.py [outdir] [--device cpu]
(the card by default; ``--device cpu`` runs the kernels' plain versions)
"""

import argparse
import os
import time

import torch

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_torch_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# No compile cache to configure: the port compiles no program, and its
# CUDA kernels build once into build/ on first use.
from noize_tpu_torch.app.drawers import StreamDrawer, TileDrawer
from noize_tpu_torch.app.tile_generator import MeshTileGenerator
from noize_tpu_torch.core.store import PipelineStateManager
from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion.params import ErosionSettings
from noize_tpu_torch.pipeline.driver import Pipeline
from noize_tpu_torch.pipeline.stages import (
    NoiseStage, StageGaussianBlur, WriteGeneratorContextStage,
)


def _sync(device):
    # the card runs behind the host: wait for it before reading the clock
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(outdir="out/full_tile", *, device="cuda"):
    device = torch.device(device)
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8).validate()
        settings = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                                   CYCLES=1, WATER_STEPS=2, PILING_RADIUS=4)
        octaves, blur_iters = 4, 3
    else:
        meta = TileSetMeta(tile_res=192, tile_size=192, generator_res=256,
                           height=1000, margin=32).validate()
        settings = ErosionSettings(PARTICLES_PER_CYCLE=500, MAXAGE=48,
                                   CYCLES=2, WATER_STEPS=6)
        octaves, blur_iters = 13, 17
    sm = PipelineStateManager(outdir + "/saves", "island", "v1", device=device)
    source = Pipeline([
        NoiseStage(noiseType="Simplex", hurst=0.4, octaves=octaves,
                   noiseSize=1700),
        StageGaussianBlur(sigma="s1d00", width=5, iterations=blur_iters),
        WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
    ], state_manager=sm, name="generator", device=device)

    gen = MeshTileGenerator(source, meta=meta, state_manager=sm,
                            erosion_settings=settings, device=device)
    t0 = time.perf_counter()
    for z in range(2):
        for x in range(2):
            gen.enqueue(f"t{x}{z}", (x, z))
    gen.drain()
    _sync(device)
    print(f"generated {len(gen.children)} tiles "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    t0 = time.perf_counter()
    gen.step_erosion()
    _sync(device)
    print(f"eroded {len(gen.children)} tiles "
          f"({settings.CYCLES} cycles each) "
          f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    for key, child in gen.children.items():
        child.erosion.save_erosion_state()
        StreamDrawer(child.erosion, meta).export(outdir, prefix=f"tile{child.request.pos}")
        print(f"{key}: mesh {child.mesh.vertex_count} verts, "
              f"streams {float(child.erosion.stream_map.cpu().numpy().sum()):.1f}")

    # restore in a fresh store and draw from disk only
    sm2 = PipelineStateManager(outdir + "/saves", "island", "v1", device=device)
    paths = TileDrawer(sm2, meta, tile_pos=(0, 0)).draw(outdir, "restored_00")
    print("restored + drew from checkpoint:", paths)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="out/full_tile")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.outdir, device=args.device)
