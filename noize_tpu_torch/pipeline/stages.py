"""Concrete pipeline stages — port of ``noize_tpu.pipeline.stages``: same
classes, parameter names and ranges.

On the card the blur stages and ``KernelFilterStage`` run kernel K1 (the
whole iterated chain in one call; Sobel3_2D two calls an iteration),
``FlowMapStage`` runs K2 and ``StageThermalErosion`` runs K3, at any size;
the reference runs its TPU kernels only on the TPU and falls back to XLA
elsewhere.  On the CPU each wrapper runs its plain version.

The array stages expose ``array_fn(data, io=None)`` (``NoiseStage``:
``array_fn(data, io, *, device)``), which ``compose.fuse`` chains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core.stageio import DownsampleData, GeneratorData, MeshStageData, ReduceData
from ..ops import filters as _filters
from ..ops import fractal as _fractal
from ..ops import kernels as _kernels
from ..ops import mesh as _mesh
from ..ops.blur import limit_width, smooth_taps
from ..ops.cuda.flow import flow_map_fused
from ..ops.cuda.stencil import gauss_chain, separable_chain
from ..ops.cuda.thermal import thermal_erosion_fused
from .stage import PipelineWorkItem, Stage


class _ArrayStage(Stage):
    """A stage that maps a GeneratorData payload's ``data`` through
    ``array_fn``."""

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data, work.data))
        return work


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NoiseStage(Stage):
    """Noise/NoiseStage.cs:13-61 — params & ranges preserved; the tile is
    made on the work item's device."""

    noiseType: str = "Perlin"          # FractalNoise enum member name
    hurst: float = 0.0                 # [0, 2]
    startingAmplitude: float = 1.0     # [.01, 5]
    octaves: int = 1                   # [1, 24]
    stepdown: float = 2.0              # [1.8, 2.2]
    detuneRate: float = 0.0            # [-.05, .05]
    noiseSize: int = 1000              # [5, 32000]

    makes_data = True

    def __post_init__(self):
        if self.noiseType not in _fractal.NOISE_TYPES:
            raise ValueError(
                f"unknown noiseType {self.noiseType!r}; expected one of "
                f"{_fractal.NOISE_TYPES}")

    def array_fn(self, data, io: GeneratorData, *, device="cuda"):
        """The tile at ``io.resolution``, ``io.xpos``, ``io.zpos``; the
        incoming ``data`` is ignored but for its device (``device`` when
        ``data`` is None)."""
        if isinstance(data, torch.Tensor):
            device = data.device
        return _fractal.fractal(
            io.resolution, io.xpos, io.zpos, noise_type=self.noiseType,
            hurst=self.hurst, octaves=self.octaves, stepdown=self.stepdown,
            detune_rate=self.detuneRate, noise_size=float(self.noiseSize),
            starting_amplitude=self.startingAmplitude, device=device)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        d = work.data
        work.data = d.with_(data=self.array_fn(d.data, d, device=work.device))
        return work


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelFilterStage(_ArrayStage):
    """Filter/KernelFilterStage.cs:13-51; on K1."""

    filter: str = "Smooth3"            # KernelFilterType member
    iterations: int = 1                # [1, 32]

    def array_fn(self, data, io=None):
        return _kernels.kernel_filter(data, self.filter, self.iterations)


@dataclass(frozen=True)
class StageGaussianBlur(_ArrayStage):
    """Filter/Kernel/Blur/StageGaussianBlur.cs:13-55; the whole chain on
    K1."""

    sigma: str = "s1d00"               # GaussSigma member
    width: int = 3                     # [3, 25]
    iterations: int = 1                # [1, 32]

    def array_fn(self, data, io=None):
        return gauss_chain(data, self.width, self.sigma, self.iterations)


@dataclass(frozen=True)
class StageGaussianBlurFused(StageGaussianBlur):
    """The reference's Pallas-accelerated StageGaussianBlur: the same chain
    on K1 here.  ``block`` chose the TPU's row block and is ignored."""

    block: int = None


@dataclass(frozen=True)
class StageSmoothBlur(_ArrayStage):
    """Filter/Kernel/Blur/StageSmoothBlur.cs:13-55; the whole chain on
    K1."""

    width: int = 3
    iterations: int = 1

    def array_fn(self, data, io=None):
        return separable_chain(data, smooth_taps(limit_width(self.width)),
                               self.iterations)


@dataclass(frozen=True)
class StageThermalErosion(_ArrayStage):
    """Filter/Kernel/Blur/StageThermalErosion.cs:13-36; on K3."""

    iterations: int = 1                  # [1, 32]
    talus: int = 45                      # [1, 90] degrees
    increment: float = 0.5
    meshHeightWidthRatio: float = 0.75

    def array_fn(self, data, io=None):
        return thermal_erosion_fused(data, float(self.talus), self.increment,
                                     self.meshHeightWidthRatio,
                                     iterations=self.iterations)


@dataclass(frozen=True)
class ConstantStage(_ArrayStage):
    """Filter/ConstantStage.cs:13-57."""

    operation: str = "MULTIPLY"        # MULTIPLY | BINARIZE
    value: float = 0.5                 # [0, 1]

    def array_fn(self, data, io=None):
        return _filters.CONSTANT_OPS[self.operation](data, self.value)


@dataclass(frozen=True)
class CurveStage(_ArrayStage):
    """Filter/Curve/CurveStage.cs:13-71 — ``curve`` is the discretised LUT
    (the AnimationCurve sampled at ``samples`` points)."""

    curve: Tuple[float, ...] = ()
    samples: int = 256

    @classmethod
    def from_function(cls, fn, samples: int = 256):
        return cls(curve=tuple(float(fn(i / samples)) for i in range(samples)),
                   samples=samples)

    @classmethod
    def from_keyframes(cls, keys, samples: int = 256):
        """Discretise Unity AnimationCurve keyframes with the exact
        Hermite/Bezier evaluator (CurveStage.cs ExtractCurve parity)."""
        from ..utils.anim_curve import sample_lut

        return cls(curve=sample_lut(keys, samples), samples=samples)

    def array_fn(self, data, io=None):
        lut = torch.tensor(self.curve, dtype=torch.float32, device=data.device)
        return _filters.curve_apply(data, lut)


@dataclass(frozen=True)
class ReduceStage(Stage):
    """Filter/Reduce/ReduceStage.cs:21-70 — consumes ReduceData, emits
    GeneratorData (TransformData parity)."""

    operation: str = "SUBTRACT"

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, ReduceData)
        d = work.data
        out = _filters.REDUCTION_OPS[self.operation](d.data, d.right_data)
        work.data = GeneratorData(uuid=d.uuid, resolution=d.resolution, data=out,
                                  xpos=d.xpos, zpos=d.zpos)
        return work


@dataclass(frozen=True)
class CropStage(Stage):
    """Filter/Sample/CropStage.cs:12-19 — consumes DownsampleData, crops
    ``inputData`` to resolution² (the reference's offset quirk: it starts
    at (0, 0))."""

    offset: int = 0

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, DownsampleData)
        d = work.data
        work.data = d.with_(data=_filters.crop(d.inputData, d.resolution, self.offset))
        return work


@dataclass(frozen=True)
class FlowMapStage(_ArrayStage):
    """Geologic/Stage/FlowMapStage.cs:16-220 — the output overwrites the
    height with the statically normalised velocity map; on K2."""

    iterations: int = 5                # [1, 128]
    normMin: float = -0.1
    normMax: float = 0.1

    def array_fn(self, data, io=None):
        return flow_map_fused(data, iterations=self.iterations,
                              norm_min=self.normMin, norm_max=self.normMax)


# ---------------------------------------------------------------------------
# context (state-store) stages
# ---------------------------------------------------------------------------

def _context_buffer_name(d: GeneratorData, alias: str) -> str:
    """'{xpos}_{zpos}__{res}__{alias}' (ReadGeneratorContextStage.cs:18-20)."""
    return f"{d.xpos}_{d.zpos}__{d.resolution}__{alias}"


@dataclass(frozen=True)
class WriteGeneratorContextStage(Stage):
    """WriteGeneratorContextStage.cs — copies the payload into the named
    context buffer, locked until committed."""

    contextAlias: str = ""

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        if work.state_manager is None:
            return False
        name = _context_buffer_name(work.data, self.contextAlias)
        return not work.state_manager.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        sm = work.state_manager
        name = _context_buffer_name(work.data, self.contextAlias)
        token = object()
        sm.try_set_lock(name, token)
        sm.set_buffer(name, work.data.data)
        sm.unlock(name, token)
        return work


@dataclass(frozen=True)
class ReadGeneratorContextStage(Stage):
    """ReadGeneratorContextStage.cs — replaces the payload data with the
    named context buffer; gated on existence and unlock."""

    contextAlias: str = ""

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        if work.state_manager is None:
            return False
        name = _context_buffer_name(work.data, self.contextAlias)
        if not work.state_manager.buffer_exists(name):
            return False
        return not work.state_manager.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        name = _context_buffer_name(work.data, self.contextAlias)
        work.data = work.data.with_(data=work.state_manager.get_buffer(name))
        return work


# ---------------------------------------------------------------------------
# mesh stages
# ---------------------------------------------------------------------------

def _mesher(overshoot: bool):
    return _mesh.heightmap_mesh_overshoot if overshoot else _mesh.heightmap_mesh


@dataclass(frozen=True)
class MeshTileStage(Stage):
    """Mesh/Stage/MeshTileStage.cs:28-64 — heightmap payload → MeshArrays."""

    overshoot: bool = False

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        d = work.data
        mesh = _mesher(self.overshoot)(d.data, d.resolution, d.inputResolution,
                                       float(d.tileHeight), float(d.tileSize))
        work.data = d.with_(mesh=mesh)
        return work


@dataclass(frozen=True)
class MeshTileReferenceDataStage(Stage):
    """Mesh/Stage/MeshTileReferenceDataStage.cs:23-80 — meshes from a named
    context buffer instead of the payload, gated on its lock."""

    contextAlias: str = "TERRAIN_HEIGHT"
    overshoot: bool = True

    def _name(self, d: MeshStageData) -> str:
        return f"{d.xpos}_{d.zpos}__{d.inputResolution}__{self.contextAlias}"

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        sm = work.state_manager
        if sm is None:
            return False
        name = self._name(work.data)
        return sm.buffer_exists(name) and not sm.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        d = work.data
        heights = work.state_manager.get_buffer(self._name(d))
        mesh = _mesher(self.overshoot)(heights, d.resolution, d.inputResolution,
                                       float(d.tileHeight), float(d.tileSize))
        work.data = d.with_(mesh=mesh)
        return work


@dataclass(frozen=True)
class MeshBakeStage(Stage):
    """Mesh/Stage/MeshBakeStage.cs:12-25 — the physics-collider bake is a
    Unity concept; here it waits until the mesh is computed on its
    device."""

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        mesh = work.data.mesh
        if mesh is not None and mesh.indices.device.type == "cuda":
            torch.cuda.synchronize(mesh.indices.device)
        return work
