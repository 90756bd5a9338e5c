"""Multi-tile generation on one device — port of ``noize_tpu.parallel.tiled``.

Tiles are independent; neighbours agree on their overlap because noise is
a function of world position.  ``tile_batch`` runs a stack of T tiles:

  * the field stages run on the stack ``[T, R, R]``: fractal noise over the
    T origins, the blur chain as one K1 call (``ops.cuda.stencil``; a
    launch's grid holds every tile, each clamped at its own edges), the
    flow map as one K2 call;
  * erosion runs tile by tile, as the reference's ``lax.map`` does, so each
    tile keeps its own early exits and pool gate, and K3 and K4/K5 stay
    per map;
  * the mesh planes run on the stack.

A tile is a pure function of (origin, seed): its particle key is
``fold_in(fold_in(PRNGKey(seed), xpos), zpos)``, whatever batch, slot or
rank it lands in.

The sharded batch (``mesh=``): whole tiles per rank of the mesh's
``batch`` axis, each rank running its share through the one-device path
above, no communication; the stack comes back as a ``DTensor`` sharded on
the tile axis (``.full_tensor()`` gathers it on every rank).

Spans (``utils.tracking``): ``tile_batch`` around a batch on one device,
``field.fractal``, ``field.blur`` and ``field.flow`` around the field
stages, ``tile.erode`` around each tile's erosion.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.tiles import TileSetMeta
from ..erosion.params import ErosionSettings
from ..erosion.sim import erosion_cycles, init_state
from ..ops import mesh as _mesh
from ..ops.cuda.flow import flow_map_fused
from ..ops.cuda.stencil import gauss_chain
from ..ops.fractal import fractal
from ..prng import PRNGKey, fold_in_stack
from ..utils.tracking import span
from .device_mesh import tile_batch_sharding
from .halo import _mesh_device


@dataclass(frozen=True)
class TilePipelineConfig:
    """Static per-run config for the tile pipeline."""

    meta: TileSetMeta
    noise_type: str = "Simplex"
    hurst: float = 0.4
    octaves: int = 13
    stepdown: float = 2.0
    detune_rate: float = 0.0
    noise_size: float = 1700.0
    blur_width: int = 5
    blur_sigma: float = 1.0
    blur_iterations: int = 17
    flow_iterations: int = 0          # 0 = keep heights (flow overwrites them)
    erosion: Optional[ErosionSettings] = None
    erosion_cycles: int = 0
    emit_mesh: bool = False           # also emit per-tile vertex planes


def _tile_height(cfg: TilePipelineConfig, xpos, zpos, *, device="cuda"):
    """Field stages: noise → blur chain → optional flow map, of one tile
    (scalar origins) or of a stack (sequences of T origins)."""
    with span("field.fractal"):
        h = fractal(cfg.meta.generator_res, xpos, zpos, noise_type=cfg.noise_type,
                    hurst=cfg.hurst, octaves=cfg.octaves, stepdown=cfg.stepdown,
                    detune_rate=cfg.detune_rate, noise_size=cfg.noise_size, device=device)
    with span("field.blur"):
        h = gauss_chain(h, cfg.blur_width, cfg.blur_sigma, cfg.blur_iterations)
    if cfg.flow_iterations:
        with span("field.flow"):
            h = flow_map_fused(h, iterations=cfg.flow_iterations)
    return h


def _tile_erode(cfg: TilePipelineConfig, h, key):
    """Erosion stage of one tile: cfg.erosion_cycles particle cycles."""
    with span("tile.erode"):
        return erosion_cycles(init_state(h, key), cfg.erosion, cfg.meta,
                              cfg.erosion_cycles).world.height


def _tile_mesh_planes(cfg: TilePipelineConfig, h):
    """Mesh stage: component-major vertex planes of one tile, or of each
    tile of a stack (``[T, 12, tr+1, tr+1]``)."""
    m = cfg.meta
    return _mesh.heightmap_mesh_overshoot_planes(
        h, m.tile_res, m.generator_res, float(m.height), float(m.tile_size)).planes


def _eroding(cfg: TilePipelineConfig) -> bool:
    return cfg.erosion is not None and cfg.erosion_cycles > 0


def generate_tile(cfg: TilePipelineConfig, xpos, zpos, key):
    """One tile end to end on ``key``'s device: noise → blur chain → (flow
    | erosion) → mesh-ready heights.  Pure function of (origin, key).

    With ``cfg.emit_mesh`` returns ``{"height": f32[R, R], "mesh_planes":
    f32[12, tile_res+1, tile_res+1]}``; the triangle indices are the same
    for every tile: ``ops.mesh.grid_indices(cfg.meta.tile_res)``."""
    h = _tile_height(cfg, xpos, zpos, device=key.device)
    if _eroding(cfg):
        h = _tile_erode(cfg, h, key)
    if cfg.emit_mesh:
        return {"height": h, "mesh_planes": _tile_mesh_planes(cfg, h)}
    return h


def _local_batch(cfg: TilePipelineConfig, xs, zs, keys):
    """A batch of whole tiles on one device: the field stages on the stack,
    erosion tile by tile, the mesh planes on the stack."""
    with span("tile_batch"):
        h = _tile_height(cfg, xs, zs, device=keys.device)
        if _eroding(cfg):
            h = torch.stack([_tile_erode(cfg, h[i], keys[i]) for i in range(h.shape[0])])
        if cfg.emit_mesh:
            return {"height": h, "mesh_planes": _tile_mesh_planes(cfg, h)}
        return h


def tile_batch(cfg: TilePipelineConfig, origins: np.ndarray, mesh=None, seed: int = 0, *,
               device="cuda"):
    """Generate a stack of tiles on ``device`` (the card by default; no GPU
    raises).

    ``origins``: int array [T, 2] of (xpos, zpos) tile origins.  Returns
    f32[T, R, R] heightmaps, or (with ``cfg.emit_mesh``) a dict
    {"height": f32[T, R, R], "mesh_planes": f32[T, 12, tr+1, tr+1]}.
    Per-tile keys come from the tile's world position, so a tile is a pure
    function of (origin, seed).

    ``mesh``: a ``DeviceMesh`` with a ``batch`` axis (``device_mesh.
    batch_mesh``), on which every rank calls this with the same origins; T
    must divide evenly over the axis.  Each rank runs its T / n tiles on
    the mesh's device (``device`` is not read) and the result is a
    ``DTensor`` of the same shape placed
    ``device_mesh.tile_batch_sharding(mesh)`` (a dict of them with
    ``cfg.emit_mesh``)."""
    origins = np.asarray(origins)
    if mesh is not None:
        return _sharded_batch(cfg, origins, mesh, seed)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tile_batch(device='cuda'): no CUDA device")
    return _local_batch(cfg, *_tile_inputs(origins, seed, device))


def _tile_inputs(origins, seed: int, device):
    """(float32 x origins, z origins, per-tile keys from world positions)."""
    keys = fold_in_stack(fold_in_stack(PRNGKey(seed, device=device), origins[:, 0]),
                         origins[:, 1])
    # float32 origins, as the reference vmaps over them
    return origins[:, 0].astype(np.float32), origins[:, 1].astype(np.float32), keys


def _sharded_batch(cfg: TilePipelineConfig, origins, mesh, seed: int):
    """Whole tiles per rank of the ``batch`` axis (the reference's
    ``P('batch')`` sharding): this rank's contiguous share of the origins
    through the one-device path, returned as its shard."""
    nb = mesh.size(mesh.mesh_dim_names.index("batch"))
    if len(origins) % nb != 0:
        raise ValueError(
            f"tile_batch: {len(origins)} tiles do not divide over the "
            f"{nb}-device 'batch' mesh axis — pad the request to a "
            f"multiple of {nb} (whole tiles per device)")
    per = len(origins) // nb
    b = mesh.get_local_rank("batch")
    mine = origins[b * per:(b + 1) * per]
    out = _local_batch(cfg, *_tile_inputs(mine, seed, _mesh_device(mesh)))
    placements = tile_batch_sharding(mesh)

    def shard(t):
        shape = (len(origins), *t.shape[1:])
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    return {k: shard(v) for k, v in out.items()} if isinstance(out, dict) else shard(out)


def grid_origins(meta: TileSetMeta, nx: int, nz: int) -> np.ndarray:
    """Tile origins for an nx × nz tile grid (DemoTileGenerator enqueue
    pattern — BasicDemo~/DemoTileGenerator.cs:12-19)."""
    out = []
    for z in range(nz):
        for x in range(nx):
            out.append(meta.tile_origin((x, z)))
    return np.asarray(out, np.int32)
