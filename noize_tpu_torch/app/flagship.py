"""Flagship tile step — port of ``noize_tpu.app.flagship``.

Simplex fBm (13 octaves) → Gauss-5 ×17 (kernel K1) → flow map ×8 (K2) →
erosion cycles (thermal on K3, particle descent, sediment, pool automata
on K4) → mesh emission, for one generator tile on one device.

Spans (``utils.tracking``): ``step`` around a call, ``field.fractal``,
``field.blur`` and ``field.flow`` around the field stages; the erosion
cycles and the mesh record their own.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.tiles import TileSetMeta
from ..erosion import sim as _sim
from ..erosion.graphs import CycleGraphs
from ..erosion.params import ErosionSettings
from ..ops import mesh as _mesh
from ..ops.cuda.flow import flow_map_fused
from ..ops.cuda.stencil import gauss_chain
from ..ops.fractal import fractal
from ..utils.tracking import span


def default_meta(generator_res: int = 2048, margin: int = 16) -> TileSetMeta:
    tile = generator_res - 2 * margin
    return TileSetMeta(
        tile_res=tile, tile_size=tile, generator_res=generator_res,
        height=1000, margin=margin,
    ).validate()


def default_settings() -> ErosionSettings:
    """Reference default scale: 1000 particles/cycle, MAXAGE 100."""
    return ErosionSettings()


def make_tile_step(
    meta: Optional[TileSetMeta] = None,
    settings: Optional[ErosionSettings] = None,
    *,
    octaves: int = 13,
    hurst: float = 0.4,
    noise_size: float = 1700.0,
    noise_type: str = "Simplex",
    blur_iterations: int = 17,
    flow_iterations: int = 8,
    erosion_cycles: int = 1,
    emit_mesh: bool = True,
    mesh_layout: str = "arrays",
    device="cuda",
):
    """Build the flagship step on ``device``; returns (step, meta,
    settings).

    ``step(xpos, zpos, key, *, fresh=None) -> dict`` with keys
    ``height``, ``flow_velocity``, ``pool``, ``stream`` and (with
    ``emit_mesh``) ``mesh``.  ``key`` (``prng.PRNGKey``) seeds the particle
    spawn as the reference's ``jax.random`` key does; ``fresh``, a test
    hook, is an optional list with one ``Particles`` per erosion cycle that
    replaces that cycle's random spawn.  ``step.syncs`` lists the host
    syncs of the last call.

    ``device="cuda"`` raises when no GPU is present: the step never falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_tile_step(device='cuda'): no CUDA device")
    meta = meta or default_meta()
    settings = settings or default_settings()
    if mesh_layout not in ("arrays", "planes"):
        raise ValueError(f"unknown mesh layout {mesh_layout!r}")
    res = meta.generator_res
    graphs = CycleGraphs()  # the step's erosion cycles, replayed as CUDA graphs

    def step(xpos, zpos, key, *, fresh=None):
        with span("step"):
            syncs = []
            with span("field.fractal"):
                h = fractal(res, xpos, zpos, noise_type=noise_type, hurst=hurst,
                            octaves=octaves, noise_size=noise_size, device=device)
            with span("field.blur"):
                h = gauss_chain(h, 5, 1.0, blur_iterations)
            with span("field.flow"):
                flow_v = flow_map_fused(h, iterations=flow_iterations)
            state = _sim.erosion_cycles(_sim.init_state(h, key), settings, meta,
                                        erosion_cycles, fresh=fresh, syncs=syncs,
                                        graphs=graphs)
            out = {
                "height": state.world.height,
                "flow_velocity": flow_v,
                "pool": state.world.pool,
                "stream": state.world.flow,
            }
            if emit_mesh:
                mesher = (_mesh.heightmap_mesh_overshoot_planes
                          if mesh_layout == "planes"
                          else _mesh.heightmap_mesh_overshoot)
                out["mesh"] = mesher(state.world.height, meta.tile_res, res,
                                     float(meta.height), float(meta.tile_size))
            step.syncs = syncs
            return out

    step.syncs = []
    return step, meta, settings
