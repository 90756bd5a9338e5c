"""Pipeline runtime — port of ``noize_tpu.pipeline.driver`` (the
work-queue executor, Pipeline.cs:19-287).

Enqueue → queue → executor loop → schedulability gate → stage cascade →
wait for the device → callbacks; unschedulable work parks in
``dependency_hell`` (Pipeline.cs:183-214).  PyTorch launches device work
asynchronously, so the reference's ``block_until_ready`` becomes a
synchronize of the pipeline's device.  A pipeline runs on one device, the
card by default; ``device="cuda"`` without a GPU raises.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..core.stageio import StageIO
from .stage import PipelineWorkItem, Stage

log = logging.getLogger("noize_tpu_torch.pipeline")


class Pipeline:
    """BasePipeline equivalent.

    Synchronous use: ``run(payload)``.
    Async use: ``start()`` + ``enqueue(payload, on_complete=...)`` — the
    executor thread services the queue, retrying dependency-hell items
    first (Pipeline.cs:183-200).  As in the reference, the executor logs a
    stage failure and goes on with the next item, so the item's
    ``on_complete`` never fires.
    """

    def __init__(self, stages: Sequence[Stage], state_manager=None, name: str = "", *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Pipeline(device='cuda'): no CUDA device")
        self.stages: List[Stage] = list(stages)
        self.state_manager = state_manager
        self.name = name or type(self).__name__
        self.queue: "queue.Queue[PipelineWorkItem]" = queue.Queue()
        self.dependency_hell: List[PipelineWorkItem] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.pipeline_ready = True

    def _work(self, payload, on_scheduled=None, on_complete=None):
        return PipelineWorkItem(data=payload, state_manager=self.state_manager,
                                on_scheduled=on_scheduled, on_complete=on_complete,
                                device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- IPipeline surface (Pipeline/Interface.cs:22-36) --------------------

    def enqueue(self, payload: StageIO, on_scheduled: Optional[Callable] = None,
                on_complete: Optional[Callable] = None):
        self.queue.put(self._work(payload, on_scheduled, on_complete))

    def run(self, payload: StageIO) -> StageIO:
        """Synchronous end-to-end run (schedule + wait for the device)."""
        work = self._schedule(self._work(payload))
        self._sync()
        return work.data

    # --- scheduling ---------------------------------------------------------

    def work_is_schedulable(self, work: PipelineWorkItem) -> bool:
        """Every stage must pass its gate (Pipeline.cs:256-265)."""
        return all(s.is_schedulable(work) for s in self.stages)

    def _schedule(self, work: PipelineWorkItem) -> PipelineWorkItem:
        t0 = time.perf_counter()
        for s in self.stages:
            work = s.apply(work)
        log.debug("%s fully scheduled %s in (%.1fms)", self.name, work.data.uuid,
                  (time.perf_counter() - t0) * 1e3)
        if work.on_scheduled is not None:
            work.on_scheduled(work.data)
        return work

    def _complete(self, work: PipelineWorkItem, t_sched: float):
        self._sync()
        for s in self.stages:
            s.on_complete(work)
        log.debug("%s completed -> %s: %.1fms", self.name, work.data.uuid,
                  (time.perf_counter() - t_sched) * 1e3)
        if work.on_complete is not None:
            work.on_complete(work.data)

    def _get_next_job(self) -> Optional[PipelineWorkItem]:
        """dependencyHell retry first, then fresh queue items
        (Pipeline.cs:183-200)."""
        for i, work in enumerate(self.dependency_hell):
            if self.work_is_schedulable(work):
                return self.dependency_hell.pop(i)
        try:
            work = self.queue.get_nowait()
        except queue.Empty:
            return None
        if not self.work_is_schedulable(work):
            self.dependency_hell.append(work)
            log.debug("%s: work -> dependency hell (%d parked)", self.name,
                      len(self.dependency_hell))
            return None
        return work

    # --- executor loop (the frame loop analog) ------------------------------

    def _loop(self):
        while not self._stop.is_set():
            work = self._get_next_job()
            if work is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            try:
                work = self._schedule(work)
                self._complete(work, t0)
            except Exception:  # the reference's behaviour: log, go on
                log.exception("%s: stage cascade failed for %s", self.name,
                              work.data.uuid)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def drain(self, timeout: float = 60.0):
        """Wait until the queue and dependency hell are empty."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.queue.empty() and not self.dependency_hell:
                return True
            time.sleep(0.005)
        return False


class GeneratorPipeline(Pipeline):
    """Scripts/GeneratorPipeline.cs:11-13 — trivial concrete pipeline."""
