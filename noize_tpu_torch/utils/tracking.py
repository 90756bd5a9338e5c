"""Standalone async computation tracker and observability taps — port of
``noize_tpu.utils.tracking``.

  * ``StandAloneJobHandler`` (StandAloneJobHandler.cs:6-36) tracks one
    in-flight computation outside a pipeline (the continuous erosion
    mode's cycle scheduling).  PyTorch enqueues CUDA work asynchronously;
    a job is a ``torch.cuda.Event`` recorded after it on the current
    stream of each device its tensors live on, and readiness is the
    event's ``query()``.  Work on CPU tensors is complete once enqueued.
  * ``stage_timer``: the 'scheduled in / completed in' log lines
    (Pipeline.cs:115-126, 169-171).
  * ``array_stats``: min/max/mean/non-finite taps (the structured stand-in
    for the reference's Debug.Log invariant checks).
  * ``device_trace``: a ``torch.profiler`` trace (Chrome JSON) of a block.
  * ``stage_cost``: flops and bytes of a stage, counted op by op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

log = logging.getLogger("noize_tpu_torch")


def _tensors(obj):
    """The tensors in ``obj``: a tensor, or dataclasses, NamedTuples,
    dicts, lists and tuples of them (the reference's pytree leaves)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _cuda_devices(obj):
    return sorted({t.device for t in _tensors(obj) if t.device.type == "cuda"},
                  key=lambda d: d.index or 0)


class StandAloneJobHandler:
    """Track one in-flight device computation (tensors, or containers of
    them).

    ``track_job`` records a CUDA event on the current stream of each
    device the tensors live on; ``job_complete`` polls the events without
    blocking, ``close_job`` and ``wait`` synchronise on them."""

    def __init__(self):
        self.is_running = False
        self.handle: Any = None
        self._events: list = []

    def track_job(self, arrays) -> bool:
        self.handle = arrays
        self._events = []
        for dev in _cuda_devices(arrays):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self._events.append(ev)
        self.is_running = True
        return True

    def job_complete(self) -> bool:
        if not self.is_running:
            return False
        return all(ev.query() for ev in self._events)

    def close_job(self) -> bool:
        if not self.job_complete():
            return False
        self._sync()
        self.is_running = False
        return True

    def wait(self):
        if self.is_running:
            self._sync()
            self.is_running = False
        return self.handle

    def _sync(self):
        for ev in self._events:
            ev.synchronize()


@contextlib.contextmanager
def stage_timer(name: str, sync: bool = False, result=None):
    """'scheduled in Xms / completed in Yms' log-shape parity
    (Pipeline.cs:115-126, 169-171); ``sync`` waits for the devices that
    ``result``'s tensors live on."""
    t0 = time.perf_counter()
    yield
    t_sched = (time.perf_counter() - t0) * 1e3
    if sync and result is not None:
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        t_done = (time.perf_counter() - t0) * 1e3
        log.info("%s scheduled in (%.1fms), completed in %.1fms",
                 name, t_sched, t_done)
    else:
        log.info("%s scheduled in (%.1fms)", name, t_sched)


def array_stats(name: str, arr, warn_nonfinite: bool = True) -> dict:
    """Per-stage array tap: min/max/mean/non-finite count (a tensor on any
    device, or an array); warns on the ``noize_tpu_torch`` logger."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    finite = np.isfinite(a)
    stats = {
        "name": name,
        "shape": tuple(a.shape),
        "min": float(a[finite].min()) if finite.any() else float("nan"),
        "max": float(a[finite].max()) if finite.any() else float("nan"),
        "mean": float(a[finite].mean()) if finite.any() else float("nan"),
        "nonfinite": int((~finite).sum()),
    }
    if warn_nonfinite and stats["nonfinite"]:
        log.warning("array %s has %d non-finite values", name, stats["nonfinite"])
    return stats


@contextlib.contextmanager
def device_trace(outdir: str):
    """``torch.profiler`` trace of the block (the Unity Profiler marker
    analog): host ops, and the card's kernels where CUDA is present,
    written to ``outdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


class _OpCounter(TorchDispatchMode):
    """Counts, op by op, the elements each op produces (flops of an
    elementwise op), ``flop_counter``'s count for the ops it knows
    (matmul, convolution, attention), and each op's input plus output
    bytes.  Views move nothing and count nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out
        outs = list(_tensors(out))
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        else:
            self.flops += float(sum(t.numel() for t in outs))
        ins = list(_tensors(list(args) + list(kwargs.values())))
        self.bytes += float(sum(t.numel() * t.element_size() for t in ins + outs))
        return out


def stage_cost(fn, *args, **kwargs) -> dict:
    """Flops, bytes accessed and arithmetic intensity (flops/byte) of one
    call of ``fn(*args, **kwargs)``, with the reference's three keys.

    The reference reads XLA's cost analysis of the compiled program; the
    eager port has no compiled program, so this is an unfused op count:
    each op's produced elements as its flops (``flop_counter``'s count for
    matmul- and convolution-type ops) and its input plus output bytes,
    every intermediate included.  It runs ``fn`` once."""
    with _OpCounter() as c:
        fn(*args, **kwargs)
    return {
        "flops": c.flops,
        "bytes_accessed": c.bytes,
        "arithmetic_intensity": c.flops / c.bytes if c.bytes else 0.0,
    }
