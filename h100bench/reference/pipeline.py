"""The reference's side of each entry the benchmark drives, on the frozen
plain versions of this folder: plain PyTorch on whatever device it is
given, no kernel of the port, nothing of ``noize_tpu_torch`` imported.

``cast`` is applied to every map between two stages (and to the erosion
state after each cycle).  The reference passes none; the control passes a
rounding to bfloat16, the precision a later change would be tempted to
store the maps in.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from . import kernels, mesh
from .flow import flow_map
from .fractal import fractal
from .params import ErosionSettings
from .prng import PRNGKey, fold_in_stack
from .sim import SimState, erosion_cycle, init_state
from .tiles import TileSetMeta


def same(t):
    return t


def to_bfloat16(t):
    """The control's rounding: float32 stored as bfloat16."""
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def meta_of(config: dict) -> TileSetMeta:
    return TileSetMeta(**config["tile"]).validate()


def settings_of(config: dict) -> ErosionSettings:
    return ErosionSettings(**config["erosion"])


def field(config: dict, xpos, zpos, *, device, cast=same):
    """fBm → Gauss chain of one tile (scalar origins) or of a stack."""
    f = config["field"]
    h = cast(fractal(config["tile"]["generator_res"], xpos, zpos, noise_type=f["noise_type"],
                     hurst=f["hurst"], octaves=f["octaves"], noise_size=f["noise_size"],
                     device=device))
    return cast(kernels.gauss_chain(h, f["blur_width"], f["blur_sigma"], f["blur_iterations"]))


def flow(config: dict, h, cast=same):
    return cast(flow_map(h, config["field"]["flow_iterations"]))


def cast_state(state: SimState, cast) -> SimState:
    w = state.world
    world = replace(w, height=cast(w.height), pool=cast(w.pool), flow=cast(w.flow),
                    track=cast(w.track), plants=cast(w.plants))
    return SimState(world=world, drain_water=cast(state.drain_water), key=state.key)


def erode(state: SimState, config: dict, cycles: int, *, tuned: bool, cast=same) -> SimState:
    """``cycles`` erosion cycles from ``state``; ``tuned`` passes the
    settings' tunables, as ``ErosionSim.step`` does."""
    settings, meta = settings_of(config), meta_of(config)
    for _ in range(cycles):
        state = cast_state(erosion_cycle(state, settings, meta,
                                         tuned=settings.tunable_values() if tuned else None),
                           cast)
    return state


def mesh_of(config: dict, h, layout: str, cast=same):
    m = meta_of(config)
    fn = (mesh.heightmap_mesh_overshoot_planes if layout == "planes"
          else mesh.heightmap_mesh_overshoot)
    out = fn(h, m.tile_res, m.generator_res, float(m.height), float(m.tile_size))
    if layout == "planes":
        return {"planes": cast(out.planes), "indices": out.indices}
    return {"positions": cast(out.positions), "normals": cast(out.normals),
            "tangents": cast(out.tangents), "uvs": cast(out.uvs), "indices": out.indices}


def sim_start(config: dict, xpos, zpos, sim_seed: int, *, device, cast=same) -> SimState:
    """The live sim's start: the Quickstart field (fBm, blur, flow map
    written as the height) and ``PRNGKey(sim_seed)``."""
    h = flow(config, field(config, xpos, zpos, device=device, cast=cast), cast)
    return init_state(h, PRNGKey(sim_seed, device=device))


def tile_step(config: dict, xpos, zpos, key, cycles: int, *, device, cast=same) -> dict:
    """The flagship tile step: field, flow map beside it, ``cycles``
    erosion cycles of the blurred height, the mesh."""
    h = field(config, xpos, zpos, device=device, cast=cast)
    flow_v = flow(config, h, cast)
    state = erode(init_state(h, key), config, cycles, tuned=False, cast=cast)
    w = state.world
    return {"height": w.height, "flow_velocity": flow_v, "pool": w.pool, "stream": w.flow,
            "mesh": mesh_of(config, w.height, config["mesh"], cast)}


def tile_batch(config: dict, origins, seed: int, cycles: int, *, device, cast=same) -> dict:
    """Tiles of ``origins`` ([T, 2] ints), each a pure function of its
    world position and ``seed``: field and flow map on the stack, erosion
    tile by tile, the mesh planes on the stack."""
    origins = np.asarray(origins)
    keys = fold_in_stack(fold_in_stack(PRNGKey(seed, device=device), origins[:, 0]),
                         origins[:, 1])
    h = flow(config, field(config, origins[:, 0].astype(np.float32),
                           origins[:, 1].astype(np.float32), device=device, cast=cast), cast)
    if cycles:
        h = torch.stack([erode(init_state(h[i], keys[i]), config, cycles, tuned=False,
                               cast=cast).world.height for i in range(h.shape[0])])
    return {"height": h, "mesh": mesh_of(config, h, "planes", cast)}
