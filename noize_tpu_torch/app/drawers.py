"""Drawers — port of ``noize_tpu.app.drawers``: render live or saved
terrain/water maps to textures.

Reference: ``StreamDrawer`` (Geologic/ParticleErosion/Component/
StreamDrawer.cs:29-132 — CustomRenderTextures fed from the water/terrain
control textures of a live sim) and ``TileDrawer`` (Component/
TileDrawer.cs:19-137 — render saved maps from the state store without
running the sim).  The drawers produce the composite control textures and
display a tile from live state or a checkpoint, as PNG/array outputs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.store import PipelineStateManager
from ..core.tiles import TileSetMeta
from . import visualize as V


class StreamDrawer:
    """Consumes an ``IProvideGeodata`` source (anything exposing pool/
    stream/height maps — ErosionSim fits) and keeps its control textures
    current."""

    def __init__(self, source, meta: TileSetMeta):
        self.source = source
        self.meta = meta
        self.water_control: Optional[np.ndarray] = None
        self.terrain_control: Optional[np.ndarray] = None

    def refresh(self):
        m = self.meta
        self.water_control = V.water_control_texture(
            self.source.pool_map, self.source.stream_map, m.tile_res
        )
        self.terrain_control = V.terrain_control_texture(
            self.source.height_map, self.source.stream_map,
            m.tile_res, float(m.height), m.patch_res,
        )
        return self.water_control, self.terrain_control

    def export(self, outdir: str, prefix: str = "tile"):
        os.makedirs(outdir, exist_ok=True)
        if self.water_control is None:
            self.refresh()
        paths = []
        for name, tex in (("water", self.water_control),
                          ("terrain", self.terrain_control)):
            p = os.path.join(outdir, f"{prefix}_{name}.png")
            V.to_png(p, tex)
            paths.append(p)
        return paths


class TileDrawer:
    """Render a saved tile from the state store without running the sim
    (TileDrawer parity): loads TERRAIN_HEIGHT / stream / pool checkpoints
    by the canonical buffer names and produces height + control textures."""

    ALIASES = ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL")

    def __init__(self, state_manager: PipelineStateManager, meta: TileSetMeta,
                 tile_pos=(0, 0)):
        self.sm = state_manager
        self.meta = meta
        self.tile_pos = tuple(tile_pos)

    def _load(self, alias: str):
        name = self.meta.buffer_name(self.tile_pos, alias)
        if not self.sm.buffer_exists(name):
            return None
        return self.sm.get_buffer(name)

    def draw(self, outdir: str, prefix: Optional[str] = None):
        os.makedirs(outdir, exist_ok=True)
        prefix = prefix or f"tile_{self.tile_pos[0]}_{self.tile_pos[1]}"
        height = self._load("TERRAIN_HEIGHT")
        if height is None:
            raise FileNotFoundError(
                f"no saved TERRAIN_HEIGHT for tile {self.tile_pos}"
            )
        stream = self._load("PARTERO_WATERMAP_STREAM")
        pool = self._load("PARTERO_WATERMAP_POOL")
        paths = [V.to_png(os.path.join(outdir, f"{prefix}_height.png"), height)]
        if stream is not None and pool is not None:
            tex = V.water_control_texture(pool, stream, self.meta.tile_res)
            paths.append(V.to_png(os.path.join(outdir, f"{prefix}_water.png"), tex))
        return paths
