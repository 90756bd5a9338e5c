"""MeshTileGenerator — port of ``noize_tpu.app.tile_generator``, the
top-level tile manager (reference L6).

Reference: Scripts/MeshTileGenerator.cs:39-275 and ``DemoTileGenerator``
(BasicDemo~/DemoTileGenerator.cs:7-21).

Publishes TileSetMeta to the state store (and disk), owns the tile work
queue, requests a generator-pipeline run per tile, spawns one live-erosion
sim per tile and exposes Enqueue(id, pos)/Remove(pos).  GameObjects become
per-tile records holding the erosion sim and mesh tensors, all on the
generator's device (the card by default).
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.stageio import GeneratorData
from ..core.store import PipelineStateManager
from ..core.tiles import TileRequest, TileSetMeta
from ..erosion.params import ErosionSettings
from ..erosion.sim import ErosionSim
from ..ops import mesh as _mesh
from ..pipeline.driver import Pipeline


@dataclass
class TileChild:
    """The GameObject-with-LiveErosion stand-in (CreateChildMesh,
    MeshTileGenerator.cs:213-243)."""

    request: TileRequest
    position_ws: Tuple[float, float]
    erosion: Optional[ErosionSim] = None
    mesh: Optional[_mesh.MeshArrays] = None


class MeshTileGenerator:
    """``device`` is where the store restores buffers, the sims run and
    the meshes are made (``device="cuda"`` without a GPU raises); the data
    source pipeline runs on its own device, which should be the same."""

    def __init__(
        self,
        data_source: Pipeline,
        meta: Optional[TileSetMeta] = None,
        state_manager: Optional[PipelineStateManager] = None,
        erosion_settings: Optional[ErosionSettings] = None,
        save_name: str = "default",
        save_version: str = "0",
        gen_tile_offset: Tuple[int, int] = (0, 0),
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MeshTileGenerator(device='cuda'): no CUDA device")
        self.meta = (meta or TileSetMeta()).validate()
        self.state_manager = state_manager or PipelineStateManager(device=self.device)
        self.data_source = data_source
        if data_source.state_manager is None:
            data_source.state_manager = self.state_manager
        self.erosion_settings = erosion_settings or ErosionSettings()
        self.gen_tile_offset = gen_tile_offset

        self.active_tiles: Dict[str, TileRequest] = {}
        self.children: Dict[str, TileChild] = {}
        self.work_queue: "queue.Queue[TileRequest]" = queue.Queue()
        self.is_running = False

        # Awake parity: publish meta to the store (+ disk when a save path
        # is configured) — MeshTileGenerator.cs:84-115
        self.state_manager.set_buffer("__G_TileSetMeta", self.meta)
        if self.state_manager.serde is not None:
            self.state_manager.serde.save(
                "__G_TileSetMeta",
                np.asarray([
                    self.meta.tile_res, self.meta.tile_size,
                    self.meta.generator_res, self.meta.height, self.meta.margin,
                ], np.int64),
            )

    # --- public API (MeshTileGenerator.cs:154-165) ---------------------------

    def enqueue(self, tile_id: str, pos: Tuple[int, int]):
        pos = (pos[0] + self.gen_tile_offset[0], pos[1] + self.gen_tile_offset[1])
        key = str(pos)
        if key in self.children:
            raise ValueError("Child exists at this position")
        self.work_queue.put(TileRequest(uuid=key, pos=pos))

    def remove(self, pos: Tuple[int, int]):
        key = str(tuple(pos))
        if key not in self.children:
            raise KeyError("No child exists at this position")
        del self.children[key]

    # --- frame loop (Update, MeshTileGenerator.cs:125-138) -------------------

    def update(self):
        """Service one queued tile request (per-frame semantics)."""
        if self.is_running or not self.data_source.pipeline_ready:
            return False
        try:
            req = self.work_queue.get_nowait()
        except queue.Empty:
            return False
        self.is_running = True
        self.active_tiles[req.uuid] = req
        self._request_tile_data(req)
        return True

    def drain(self):
        while self.update():
            pass

    # --- internals (RequestTileData / RequestMesh / CreateChildMesh) ---------

    def _request_tile_data(self, req: TileRequest):
        origin = self.meta.tile_origin(req.pos)
        payload = GeneratorData(
            uuid=req.uuid,
            resolution=self.meta.generator_res,
            xpos=origin[0],
            zpos=origin[1],
            data=None,
        )
        out = self.data_source.run(payload)
        self._create_child(req, out)

    def _create_child(self, req: TileRequest, generated: GeneratorData):
        m = self.meta
        ws = (
            req.pos[0] * m.tile_size - m.margin_ws,
            req.pos[1] * m.tile_size - m.margin_ws,
        )
        name = m.buffer_name(req.pos, "TERRAIN_HEIGHT")
        height = self.state_manager.get_buffer(name, default=generated.data)
        sim = ErosionSim(
            height,
            settings=self.erosion_settings,
            meta=m,
            state_manager=self.state_manager,
            tile_pos=req.pos,
            device=self.device,
        )
        child = TileChild(request=req, position_ws=ws, erosion=sim)
        child.mesh = self.mesh_for(sim.height_map)
        self.children[req.uuid] = child
        self.active_tiles.pop(req.uuid, None)
        self.is_running = False

    def mesh_for(self, height):
        m = self.meta
        return _mesh.heightmap_mesh_overshoot(
            height, m.tile_res, m.generator_res,
            float(m.height), float(m.tile_size),
        )

    # --- erosion stepping ----------------------------------------------------

    def step_erosion(self, cycles: Optional[int] = None, remesh: bool = True):
        """Advance every child's live erosion (the LiveErosion Update loop)."""
        for child in self.children.values():
            if child.erosion is not None:
                child.erosion.step(cycles)
                if remesh:
                    child.mesh = self.mesh_for(child.erosion.height_map)


class DemoTileGenerator(MeshTileGenerator):
    """BasicDemo~/DemoTileGenerator.cs:7-21: enqueue an (x_range+1) ×
    (z_range+1) grid of tiles at start."""

    def start(self, x_range: int = 1, z_range: int = 1):
        n = 0
        for x in range(x_range + 1):
            for z in range(z_range + 1):
                self.enqueue(f"{n}", (x, z))
                n += 1
        self.drain()
        return self.children
