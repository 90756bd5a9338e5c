"""Multi-device terrain field on the PyTorch port: one large grid sharded
over a 2-D mesh of ranks with halo exchange (sp), plus a tile batch
sharded over ranks (dp) — the journey of ``examples/multichip_field.py``
through ``noize_tpu_torch`` and ``torch.distributed``.

Run on one card (a one-rank group the example starts itself):
  python examples/multichip_field_torch.py [ckpt_dir]
on four cards (one rank a card, NCCL):
  torchrun --nproc-per-node 4 examples/multichip_field_torch.py
on the CPU (gloo): add ``--device cpu``.

Where a process group already exists the example runs on it; it destroys
only a group it started.
"""

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_torch_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# No compile cache to configure: the port compiles no program, and its
# CUDA kernels build once into build/ on first use.
from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion.params import ErosionSettings
from noize_tpu_torch.parallel import device_mesh as DM
from noize_tpu_torch.parallel import distributed as D
from noize_tpu_torch.parallel import sharded_ops as SO
from noize_tpu_torch.parallel import tiled as TL


def main(ckpt_dir="out/sharded_ckpt", *, device="cuda"):
    """Run the sp and dp journeys on every rank of the process group
    (started here when there is none).  Returns, on every rank, the whole
    fields as NumPy arrays: the sp path's ``height`` and ``velocity``, the
    sharded sim's ``eroded`` height and its ``restored`` copy, the dp
    ``tiles`` and their ``origins``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multichip_field_torch: device='cuda' without a CUDA device")
    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            # torchrun names the group in the environment; else one rank
            if not D.initialize(device=device):
                d = stack.enter_context(tempfile.TemporaryDirectory())
                D.initialize(f"file://{d}/init", 1, 0, device=device)
            stack.callback(dist.destroy_process_group)
        return _journeys(ckpt_dir, device)


def _journeys(ckpt_dir, device):
    def sync():
        # the card runs behind the host: wait for it before reading the clock
        if device.type == "cuda":
            torch.cuda.synchronize()

    say = print if D.is_primary() else (lambda *a, **k: None)
    n = dist.get_world_size()
    say("devices:", f"{n} rank(s), {dist.get_backend()} on {device.type}")
    mesh = DM.spatial_mesh()
    res = 256 if FAST else 1024
    octaves, blur_iters, flow_iters = (4, 3, 4) if FAST else (13, 17, 8)

    t0 = time.perf_counter()
    h = SO.sharded_fractal(mesh, res, 0, 0, noise_type="Simplex",
                           octaves=octaves, hurst=0.4, noise_size=1700.0)
    h = SO.sharded_gauss_blur(mesh, h, 5, 1.0, iterations=blur_iters)
    h = SO.sharded_thermal_erosion(mesh, h, 45.0, 0.5, 1.0, iterations=2)
    v = SO.sharded_flow_map(mesh, h, iterations=flow_iters)
    sync()
    sp_ms = (time.perf_counter() - t0) * 1e3
    vf = v.full_tensor()
    say(f"sp path: {res}² field over {tuple(mesh.shape)} mesh "
        f"in {sp_ms:.0f}ms; "
        f"velocity range [{float(vf.min()):.3f}, {float(vf.max()):.3f}]")

    # full sharded erosion: the COMPLETE cycle (particles, pools, sediment)
    # on the sharded field — parallel.sharded_erosion
    from noize_tpu_torch.parallel.sharded_erosion import ShardedErosionSim

    t0 = time.perf_counter()
    sim = ShardedErosionSim(
        mesh, h,
        settings=ErosionSettings(
            PARTICLES_PER_CYCLE=64 if FAST else 256,
            MAXAGE=8 if FAST else 24,
            WATER_STEPS=2 if FAST else 4, CYCLES=1,
            PILING_RADIUS=4 if FAST else 8),
        meta=TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                         height=1000, margin=0),
    )
    sim.step(2)
    sync()
    say(f"sp erosion: 2 full cycles on the sharded {res}² field "
        f"in {(time.perf_counter()-t0)*1e3:.0f}ms")

    # per-shard mesh emission off the eroded sharded world: each shard
    # computes its own renderable vertex block; triangles come in global
    # or block-local uint32 ids
    from noize_tpu_torch.parallel.sharded_mesh import (mesh_arrays_from_fields,
                                                       shard_mesh_indices)

    t0 = time.perf_counter()
    fields = sim.mesh_fields()
    sync()
    nx, ny = mesh.shape
    marr = mesh_arrays_from_fields(fields, res, res, (nx, ny))
    tris = shard_mesh_indices(res, res, (nx, ny), local=True)
    say(f"sp mesh: {marr.vertex_count} verts emitted per-shard in "
        f"{(time.perf_counter()-t0)*1e3:.0f}ms; "
        f"shard (0,0) renders {tris[(0, 0)].size // 3} triangles locally")

    # sharded checkpoint/resume: persists the full sim state (per shard
    # with more than one rank, through the store with one)
    from noize_tpu_torch.core.store import PipelineStateManager

    t0 = time.perf_counter()
    sim.state_manager = PipelineStateManager(ckpt_dir, device=device)
    sim.save_erosion_state()
    sim2 = ShardedErosionSim(
        mesh, torch.zeros((res, res)), settings=sim.settings,
        meta=sim.meta, state_manager=PipelineStateManager(ckpt_dir, device=device))
    sim2.restore_erosion_state()
    eroded = sim.height_map.full_tensor()
    restored = sim2.height_map.full_tensor()
    same = bool(torch.equal(restored, eroded))
    say(f"sp checkpoint: saved + restored bit-equal: {same} "
        f"in {(time.perf_counter()-t0)*1e3:.0f}ms")
    if not same:
        raise RuntimeError("sharded checkpoint restore mismatch")

    bmesh = DM.batch_mesh()
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8)
        cfg_es = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                                 CYCLES=1, WATER_STEPS=2, PILING_RADIUS=4)
        octaves, blur_iters = 4, 2
    else:
        meta = TileSetMeta(tile_res=96, tile_size=96, generator_res=128,
                           height=1000, margin=16)
        cfg_es = ErosionSettings(PARTICLES_PER_CYCLE=200, MAXAGE=24,
                                 CYCLES=1, WATER_STEPS=4)
        octaves, blur_iters = 8, 5
    cfg = TL.TilePipelineConfig(
        meta=meta, octaves=octaves, noise_size=900.0,
        blur_iterations=blur_iters, erosion=cfg_es,
        erosion_cycles=1,
    )
    origins = TL.grid_origins(meta, n, 1)
    t0 = time.perf_counter()
    tiles = TL.tile_batch(cfg, origins, mesh=bmesh)
    sync()
    say(f"dp path: {n} full tiles (noise+blur+erosion) sharded over "
        f"{n} ranks in {(time.perf_counter()-t0)*1e3:.0f}ms; "
        f"shape {tuple(tiles.shape)}")
    return {"height": h.full_tensor().cpu().numpy(), "velocity": vf.cpu().numpy(),
            "eroded": eroded.cpu().numpy(), "restored": restored.cpu().numpy(),
            "tiles": tiles.full_tensor().cpu().numpy(), "origins": origins}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir", nargs="?", default="out/sharded_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ckpt_dir, device=args.device)
