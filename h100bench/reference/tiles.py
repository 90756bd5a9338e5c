"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.core.tiles``.

Tile geometry metadata — the port's copy of ``noize_tpu.core.tiles``.

A tile set is a grid of square tiles.  Each tile is *generated* at
``generator_res²`` (tile + margin overlap so neighbouring tiles agree
without communication), then meshed at ``mesh_resolution²`` (tile +
2·margin_verts) by center-cropping.  Same dataclasses, fields and methods
as the reference (TileTypes.cs:10-36, MeshTileGenerator.cs:94-177).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TileRequest:
    """TileTypes.cs:10-13."""

    uuid: str
    pos: Tuple[int, int]


@dataclass(frozen=True)
class TileSetMeta:
    """TileTypes.cs:15-27 — global tile-grid geometry.

    Fields keep the reference names (upper-cased there):
      tile_res        cells per tile edge (TILE_RES)
      tile_size       world-space tile edge length (TILE_SIZE)
      generator_res   generation resolution incl. margin (GENERATOR_RES)
      patch_res       cells per world unit = tile_res / tile_size (PATCH_RES)
      height          world-space height scale (HEIGHT)
      margin          margin in world units (MARGIN)
    """

    tile_res: int = 1000
    tile_size: int = 1000
    generator_res: int = 1000
    height: int = 1000
    margin: int = 5

    @property
    def patch_res(self) -> float:
        return float(self.tile_res) / float(self.tile_size)

    @property
    def height_f(self) -> float:
        return float(self.height)

    @property
    def mesh_resolution(self) -> int:
        """calcTotalResolution: tileRes + 2·int(margin · patchRes)."""
        return self.tile_res + 2 * int(self.margin * self.patch_res)

    @property
    def margin_verts(self) -> int:
        """calcMarginVerts."""
        return (self.mesh_resolution - self.tile_res) // 2

    @property
    def margin_ws(self) -> float:
        """calculateMarginWS: margin verts in world units."""
        return self.margin_verts * (float(self.tile_size) / float(self.tile_res))

    def validate(self):
        """OnValidate (MeshTileGenerator.cs:119-123)."""
        if self.mesh_resolution > self.generator_res:
            raise ValueError(
                "Generator data must have higher resolution than tile + margin"
            )
        return self

    def buffer_name(self, pos: Tuple[int, int], alias: str) -> str:
        """'{x}_{z}__{res}__{alias}' keyed buffer name for the state store
        (LiveErosion.cs:157-159)."""
        return (
            f"{pos[0] * self.tile_res}_{pos[1] * self.tile_res}"
            f"__{self.generator_res}__{alias}"
        )

    def tile_origin(self, pos: Tuple[int, int]) -> Tuple[int, int]:
        """World-grid offset fed to the generator pipeline
        (MeshTileGenerator.cs:188-189): tileRes · pos."""
        return (self.tile_res * pos[0], self.tile_res * pos[1])
