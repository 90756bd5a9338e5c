"""Stage protocol — port of ``noize_tpu.pipeline.stage``
(PipelineStage.cs:10-63, PipelineDefinition.cs:18-115).

A stage is a frozen dataclass of user-tunable parameters plus ``apply``:

  Schedule(workItem, dep)      → apply(work) — returns the new work item
  CheckRequirements<T>         → check_requirements(work, T)
  IsSchedulable(workItem)      → is_schedulable(work) — context-buffer gates
  OnStageComplete              → on_complete(work)

The work item carries the pipeline's device: stages that create tensors
(``NoiseStage``) put them there.  Stages whose body is pure array math
also expose ``array_fn(data, io=None) -> data``, so ``compose.fuse`` can
chain them into one callable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..core.stageio import StageIO


class RequirementError(TypeError):
    """CheckRequirements failure (PipelineStage.cs:29-39)."""


@dataclass
class PipelineWorkItem:
    """PipelineDefinition.cs:18-25: payload + callbacks + state manager,
    and the device the pipeline runs on."""

    data: StageIO
    state_manager: Any = None
    on_scheduled: Optional[Callable] = None
    on_complete: Optional[Callable] = None
    device: torch.device = field(default=torch.device("cuda"), kw_only=True)


@dataclass(frozen=True)
class Stage:
    #: the stage makes its payload's data instead of transforming it, so its
    #: ``array_fn`` takes the ``device`` to make it on (``NoiseStage``)
    makes_data = False

    def check_requirements(self, work: PipelineWorkItem, payload_type):
        if not isinstance(work.data, payload_type):
            raise RequirementError(
                f"{type(self).__name__} requires {payload_type.__name__}, "
                f"got {type(work.data).__name__}")

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        return True

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        raise NotImplementedError

    def on_complete(self, work: PipelineWorkItem):
        return None

    # --- fusion -------------------------------------------------------------

    @property
    def fusable(self) -> bool:
        """True when the stage is pure array→array on the payload's
        ``data`` (it has ``array_fn(data, io)``) and can join a
        ``compose.fuse`` chain."""
        return hasattr(self, "array_fn")
