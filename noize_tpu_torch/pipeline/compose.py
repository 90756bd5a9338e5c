"""Pipeline composition — port of ``noize_tpu.pipeline.compose``:
definitions, masking, fusion and the fan-in reduce
(PipelineDefinition.cs:28-115, ReducePipeline.cs:18-166).

``fuse`` chains the array stages into one plain callable.  The reference
jits that chain into one XLA program; the port runs it eagerly (its
kernels are the stages' own), which computes the same thing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch

from ..core.stageio import GeneratorData, ReduceData
from .stage import PipelineWorkItem, Stage


@dataclass(frozen=True)
class StageMask:
    """PipelineDefinition.cs:28-47: disable stages by index per instance."""

    disabled: Tuple[int, ...] = ()

    def enabled_stages(self, stages: Sequence[Stage]) -> List[Stage]:
        return [s for i, s in enumerate(stages) if i not in self.disabled]


@dataclass(frozen=True)
class PipelineDefinition:
    """Declarative ordered stage list (PipelineDefinition.cs:90-115)."""

    name: str
    stages: Tuple[Stage, ...]

    def masked(self, mask: StageMask) -> "PipelineDefinition":
        """MaskedPipeline parity (PipelineDefinition.cs:49-87)."""
        return PipelineDefinition(name=self.name,
                                  stages=tuple(mask.enabled_stages(self.stages)))


def run_stages(stages: Sequence[Stage], work: PipelineWorkItem) -> PipelineWorkItem:
    """Synchronous stage cascade (BasePipeline.Schedule wiring,
    Pipeline.cs:104-151): each stage, the scheduled callback after each,
    then every stage's completion hook and the completion callback."""
    for s in stages:
        work = s.apply(work)
        if work.on_scheduled is not None:
            work.on_scheduled(work.data)
    for s in stages:
        s.on_complete(work)
    if work.on_complete is not None:
        work.on_complete(work.data)
    return work


def fuse(stages: Sequence[Stage], resolution: int, *, device="cuda"):
    """Chain array stages into one callable ``fn(data, xpos, zpos)``.

    Only valid when every stage exposes ``array_fn`` (``Stage.fusable``).
    Each stage gets ``(data, io)`` with ``io`` a ``GeneratorData`` of the
    request and the current data.  A stage that makes its data
    (``NoiseStage``) ignores the incoming data but for its device, and
    makes it on ``device`` when ``data`` is None."""
    not_fusable = [s for s in stages if not s.fusable]
    if not_fusable:
        raise ValueError(f"stages not fusable: {not_fusable}")
    stage_list = tuple(stages)
    device = torch.device(device)

    def fn(data, xpos, zpos):
        io = GeneratorData(resolution=resolution, xpos=xpos, zpos=zpos, data=data)
        for s in stage_list:
            if s.makes_data:
                data = s.array_fn(data, io, device=device)
            else:
                data = s.array_fn(data, io)
            io = io.with_(data=data)
        return data

    return fn


@dataclass
class ReducePipeline:
    """Fan-in combinator (ReducePipeline.cs:18-166): run the left and right
    upstream stages on the same request, join, then apply a binary reduce
    chain.  ``reduce_stage`` is a ReduceStage (or any Stage consuming
    ReduceData)."""

    left: Sequence[Stage]
    right: Sequence[Stage]
    reduce_stage: Stage
    post: Sequence[Stage] = field(default_factory=tuple)

    def run(self, work: PipelineWorkItem) -> PipelineWorkItem:
        d = work.data

        def branch(stages):
            return run_stages(stages, PipelineWorkItem(
                data=d.with_(), state_manager=work.state_manager, device=work.device))

        lw, rw = branch(self.left), branch(self.right)
        rd = ReduceData(uuid=d.uuid, resolution=d.resolution,
                        xpos=getattr(d, "xpos", 0), zpos=getattr(d, "zpos", 0),
                        data=lw.data.data, right_data=rw.data.data)
        joined = PipelineWorkItem(data=rd, state_manager=work.state_manager,
                                  on_scheduled=work.on_scheduled,
                                  on_complete=work.on_complete, device=work.device)
        return run_stages([self.reduce_stage, *self.post], joined)
