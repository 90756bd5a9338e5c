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
  * ``device_trace``: a ``torch.profiler`` trace (Chrome JSON) of a block,
    with the program's spans of the block on their own tracks.
  * ``stage_cost``: flops and bytes of a stage, counted op by op.
  * ``span``, ``open_span``/``close_span``, ``sync_bool``: the program's own
    spans (name, start and end on ``time.time_ns()``, thread, id, parent,
    attributes), kept in memory while an operator has called ``enable()``
    or while a ``torch.profiler`` runs anywhere in the process; ``spans()``
    reads them, ``clear()`` empties the store.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler
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


# --- spans ----------------------------------------------------------------

class Span(NamedTuple):
    """One span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``, the
    clock of the profiler's events; ``thread`` the native id of the thread
    that opened it; ``parent`` the id of the span open around it on that
    thread (None at the top, and for an ``is_async`` span, which may end on
    another thread)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    attrs: Optional[dict]
    is_async: bool


#: spans the store keeps; past it a span is dropped and counted
SPAN_CAPACITY = 1 << 18

_enabled = False
_records: list = []           # Span fields as plain tuples, appended in end order
_dropped = 0
_drop_lock = threading.Lock()
_ids = itertools.count(1)


class _Stack(threading.local):
    """A thread's open spans, and its native id, read once: a call of
    ``threading.get_native_id`` is a system call, which costs microseconds
    on some hosts."""

    def __init__(self):
        self.ids = []
        self.thread = threading.get_native_id()


_stack = _Stack()


def enable():
    """Record spans until ``disable()`` (a running ``torch.profiler``
    records them as well)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def _keep(rec: tuple):
    global _dropped
    if len(_records) < SPAN_CAPACITY:
        _records.append(rec)
    else:
        with _drop_lock:
            _dropped += 1


def spans() -> list:
    """The spans recorded so far, as ``Span``s in the order they ended."""
    return [Span._make(r) for r in list(_records)]


def dropped() -> int:
    """Spans dropped since the last ``clear()`` because the store was full
    (``SPAN_CAPACITY``)."""
    return _dropped


def clear():
    global _dropped
    _records.clear()
    with _drop_lock:
        _dropped = 0


#: the span of every block that is not recorded
_OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        ids = _stack.ids
        self.parent = ids[-1] if ids else None
        self.id = next(_ids)
        ids.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = _stack
        stack.ids.pop()
        _keep((self.name, self.start, end, stack.thread, self.id, self.parent, self.attrs,
               False))
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block as one span, nested in
    the span open around it on this thread.  Whether it is recorded is
    decided here, as the ``with`` enters: off, it is a shared context that
    does nothing.  Neither way does it launch, allocate or wait for
    anything on a device."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _On(name, attrs or None)


def open_span(name: str, **attrs):
    """Start a span that ends elsewhere, possibly on another thread (an
    order's wait in a queue); returns its token for ``close_span``, or None
    when spans are not being recorded."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return None
    return (name, time.time_ns(), _stack.thread, next(_ids), dict(attrs))


def close_span(token, **attrs):
    """End the span ``open_span`` returned ``token`` for, adding ``attrs``
    to its attributes; a None token does nothing."""
    if token is None:
        return
    end = time.time_ns()
    name, start, thread, sid, first = token
    first.update(attrs)
    _keep((name, start, end, thread, sid, None, first or None, True))


def sync_bool(site: str, value, syncs: list = None) -> bool:
    """``bool(value)`` of a device tensor, a host sync at ``site``: appended
    to ``syncs`` when given, and recorded as the span ``sync.<site>``."""
    if syncs is not None:
        syncs.append(site)
    with span("sync." + site):
        return bool(value)


#: the Chrome trace's process for the spans: above any Linux pid
#: (``pid_max`` is at most 2**22), so their tracks are their own
SPAN_TRACKS_PID = 1 << 22


def _chrome_events(recs, base_ns: int) -> list:
    """Chrome trace events of the spans ``recs``, ``ts`` in µs from
    ``base_ns``: a complete event a span, a begin and an end for an
    ``is_async`` one, a track for each thread."""
    pid = SPAN_TRACKS_PID
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "noize_tpu_torch spans"}}]
    for t in sorted({r.thread for r in recs}):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                    "args": {"name": f"spans of thread {t}"}})
    for r in recs:
        args = dict(r.attrs or {}, span_id=r.id, parent=r.parent)
        ts, end = (r.start_ns - base_ns) / 1e3, (r.end_ns - base_ns) / 1e3
        if r.is_async:
            ev = {"cat": "span", "name": r.name, "pid": pid, "tid": r.thread, "id": r.id}
            out += [dict(ev, ph="b", ts=ts, args=args), dict(ev, ph="e", ts=end)]
        else:
            out.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                        "tid": r.thread, "ts": ts, "dur": end - ts, "args": args})
    return out


@contextlib.contextmanager
def device_trace(outdir: str):
    """``torch.profiler`` trace of the block (the Unity Profiler marker
    analog): host ops, and the card's kernels where CUDA is present,
    written to ``outdir/trace.json`` (Chrome trace format), with the
    program's spans of the block on tracks of their own, on the same time
    base (the spans stay in the store)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    mine = [r for r in spans() if r.start_ns >= t0]
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += _chrome_events(mine, trace.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(trace, f)


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
