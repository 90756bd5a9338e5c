"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over the
window's last calls, reduced to what the per-layer readers and the result
line need.

A ``Trace`` holds the device operations (kernels, copies, fills) as
(name, start µs, end µs), the host operations likewise, the window's
length on the host clock, the calls and erosion cycles the program ran in
it, and the program's own counters.  Readers (``metrics/<name>.py``) take
their numbers from it and from the cell; nothing here knows a metric.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trace:
    device_ops: list            # [(name, start_us, end_us)] sorted by start
    host_ops: list              # [(name, start_us, end_us)]
    window_s: float             # host clock, profiler start to the last sync
    calls: int = 0              # closed-loop calls (steps, batches) in the window
    cycles: int = 0             # erosion cycles the program ran in the window
    counters: dict = field(default_factory=dict)
    cell: dict = field(default_factory=dict)      # the workload's entry
    config: dict = field(default_factory=dict)    # configs/<config>.json
    traffic: dict = field(default_factory=dict)   # traffic/<traffic>.json

    def kernels(self, match) -> list:
        """Durations (s) of the device operations whose name ``match``
        accepts."""
        return [(e - s) * 1e-6 for n, s, e in self.device_ops if match(n)]

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        return sum(b - a for a, b in _union(self.device_ops)) * 1e-6

    def idle_gaps(self) -> list:
        """[(start_us, end_us)] between the union's intervals."""
        u = _union(self.device_ops)
        return [(a[1], b[0]) for a, b in zip(u, u[1:]) if b[0] > a[1]]


def _union(ops) -> list:
    out = []
    for _, s, e in ops:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Profiled:
    """``with Profiled(device) as p: ...`` profiles the block, which ends
    with a synchronise; ``p.trace()`` reduces it."""

    def __init__(self, device="cuda"):
        import torch

        self._cuda = torch.device(device).type == "cuda"

    def _sync(self):
        import torch

        if self._cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        return False

    def trace(self, **kw) -> Trace:
        """The profile's raw events (the profiler's own parse of a long
        window takes minutes)."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            (dev if e.device_type() == cuda else host).append(rec)
        dev.sort(key=lambda r: r[1])
        return Trace(device_ops=dev, host_ops=host, window_s=self.window_s, **kw)


#: host operations that say nothing of what the program was doing
_NOT_WORK = ("ProfilerStep", "[memory]", "PyTorch Profiler", "Activity Buffer Request")


def breakdown(tr: Trace, top: int = 10, gaps: int = 2000) -> dict:
    """The device operations that took the most time, by name, and the
    idle gaps of the device by what the host was doing: each of the
    ``gaps`` longest gaps goes to the innermost host operation that spans
    its middle ("host: no traced operation" where none does)."""
    by_op = {}
    for n, s, e in tr.device_ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:gaps]
    host = [h for h in tr.host_ops if not h[0].startswith(_NOT_WORK)]
    by_host = {}
    if idle:
        names = [h[0] for h in host]
        hs = np.asarray([h[1] for h in host] or [0.0])
        he = np.asarray([h[2] for h in host] or [0.0])
        for a, b in idle:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid)) if host else []
            name = (names[inside[np.argmin(he[inside] - hs[inside])]] if len(inside)
                    else "host: no traced operation")
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    gap_list = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in gap_list]}
