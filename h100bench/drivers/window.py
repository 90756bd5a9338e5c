"""The closed loop the closed drivers share, and what a window returns."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..trace import Profiled, Trace


@dataclass
class Window:
    metrics: dict                 # end-to-end values by name
    attempted: int
    failed: int
    trace: Optional[Trace] = None
    notes: dict = field(default_factory=dict)   # printed to standard error
    detail: list = None           # per call or order, for the tools; never printed


def p95_ms(latencies_s) -> float:
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))


def closed_loop(entry, traffic: dict, seconds: float, trace: bool):
    """Calls one after another, each ended by a synchronise, until
    ``seconds`` have passed.  With ``trace``, the window's last
    ``trace_seconds`` run under the profiler, which is started between two
    calls and runs at least that long.  Returns (latencies s, window s,
    Trace or None)."""
    from ..entries.common import sync

    lat = []
    t0 = time.perf_counter()
    now = t0

    def until(end):
        nonlocal now
        while now < end:
            entry.call()
            sync(entry.device)
            t = time.perf_counter()
            lat.append(t - now)
            now = t

    if not trace:
        until(t0 + seconds)
        return lat, now - t0, None
    until(t0 + seconds - traffic["trace_seconds"])
    with Profiled(entry.device) as prof:
        traced_from, now = len(lat), time.perf_counter()
        until(now + traffic["trace_seconds"])
    calls = len(lat) - traced_from
    tr = prof.trace(calls=calls, cycles=calls * entry.cycles_per_call,
                    counters=entry.counters())
    return lat, now - t0, tr
