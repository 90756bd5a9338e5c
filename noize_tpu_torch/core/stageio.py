"""StageIO payload taxonomy — port of ``noize_tpu.core.stageio``.

Typed request/result records flowing through pipelines
(StageIO.cs:8-11 and ``Pipeline/Stage/StageIOTypes/``).  ``data`` is a
``torch.Tensor``; stages return new payloads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any


@dataclass
class StageIO:
    uuid: str = ""

    def with_(self, **kw):
        return replace(self, **kw)


@dataclass
class GeneratorData(StageIO):
    """StageIOTypes/GeneratorData.cs:9-15."""

    resolution: int = 0
    xpos: int = 0
    zpos: int = 0
    data: Any = None  # float32[resolution, resolution]


@dataclass
class ReduceData(StageIO):
    """StageIOTypes/ReduceData.cs:9-16 — binary op payload; ``data`` is the
    left operand and receives the result, ``right_data`` the right."""

    resolution: int = 0
    xpos: int = 0
    zpos: int = 0
    data: Any = None
    right_data: Any = None


@dataclass
class DownsampleData(StageIO):
    """StageIOTypes/DownsampleData.cs:9-16 — crop/downsample payload."""

    resolution: int = 0
    inputResolution: int = 0
    data: Any = None
    inputData: Any = None


@dataclass
class MeshStageData(StageIO):
    """StageIOTypes/MeshStageData.cs:9-22 — mesh emission payload."""

    resolution: int = 0        # mesh resolution (tile + margins)
    inputResolution: int = 0   # generator resolution
    marginPix: int = 0
    tileHeight: int = 0
    tileSize: float = 0.0
    xpos: int = 0
    zpos: int = 0
    data: Any = None           # heightmap in
    mesh: Any = None           # ops.mesh.MeshArrays out
