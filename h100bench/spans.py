"""The program's own spans in a ``--trace 1`` window, for the readers of
``program_span`` and ``program_counter`` metrics.

The program (``noize_tpu_torch.utils.tracking``) records its spans while
the profiler runs, on the clock of the profiler's events
(``time.time_ns()``).  ``of(tr)`` keeps those that lie inside the trace,
from its first event's start to its last event's end, with every span
recorded around them, in the trace's µs: a step that began before the
first event is left out with its cycles and their syncs, so a count over
cycles counts whole cycles.  ``idle_us`` puts each idle gap of the device down to the innermost span
that holds the gap's middle, the rule ``trace.breakdown`` applies to host
operations; an async span (an order's wait in a queue, which starts on one
thread and ends on another) is never blamed.  A program that records no
spans gives None, and the readers leave their metric out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .trace import Trace, _union


class Span(NamedTuple):
    name: str
    start: float            # µs, the trace's clock
    end: float
    thread: int
    id: int
    parent: Optional[int]
    attrs: Optional[dict]
    is_async: bool


def of(tr: Trace) -> Optional[list]:
    """The program's spans inside the trace whose recorded ancestors lie
    inside it too, as ``Span``s; None where the program keeps no spans, or
    the trace has no events."""
    try:
        from noize_tpu_torch.utils import tracking
    except ImportError:
        return None
    read = getattr(tracking, "spans", None)
    ops = tr.device_ops + tr.host_ops
    if read is None or not ops:
        return None
    lo, hi = min(o[1] for o in ops), max(o[2] for o in ops)
    recs = {s.id: s for s in read()}
    kept = {}

    def keep(s) -> bool:
        if s.id not in kept:
            up = recs.get(s.parent)
            kept[s.id] = (lo <= s.start_ns * 1e-3 and s.end_ns * 1e-3 <= hi
                          and (up is None or keep(up)))
        return kept[s.id]

    return [Span(s.name, s.start_ns * 1e-3, s.end_ns * 1e-3, s.thread, s.id, s.parent,
                 s.attrs, s.is_async) for s in recs.values() if keep(s)]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def durations_ms(spans: list, name: str) -> list:
    return [(s.end - s.start) * 1e-3 for s in spans if s.name == name]


def _timeline(spans: list, idx: list):
    """One thread's nested spans ``idx`` as segments: (segment starts µs,
    the index of the innermost span open in each, -1 where none is)."""
    ev = [(spans[i].start, 1, -spans[i].end, i) for i in idx]
    ev += [(spans[i].end, 0, -spans[i].start, i) for i in idx]
    ev.sort()
    stack, ts, owner = [], [], []
    for t, opening, _, i in ev:
        if opening:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
        ts.append(t)
        owner.append(stack[-1] if stack else -1)
    return np.asarray(ts, float), np.asarray(owner, int)


def innermost(spans: list, at: np.ndarray) -> np.ndarray:
    """For each time in ``at`` (µs), the index in ``spans`` of the
    shortest span that holds it, async spans left out; -1 where none
    does."""
    best = np.full(len(at), -1)
    best_len = np.full(len(at), np.inf)
    length = np.asarray([s.end - s.start for s in spans] + [np.inf])
    threads = {}
    for i, s in enumerate(spans):
        if not s.is_async:
            threads.setdefault(s.thread, []).append(i)
    for idx in threads.values():
        ts, owner = _timeline(spans, idx)
        k = np.searchsorted(ts, at, side="right") - 1
        own = np.where(k >= 0, owner[np.clip(k, 0, None)], -1)
        ln = length[own]          # -1 reads the sentinel inf
        better = ln < best_len
        best[better], best_len[better] = own[better], ln[better]
    return best


def within(spans: list, match) -> np.ndarray:
    """bool[len(spans)]: the span's name, or a name of a span around it,
    is one ``match`` accepts."""
    pos = {s.id: i for i, s in enumerate(spans)}
    hit = [None] * len(spans)

    def chain(i):
        if hit[i] is None:
            s = spans[i]
            up = pos.get(s.parent)
            hit[i] = bool(match(s.name)) or (up is not None and chain(up))
        return hit[i]

    return np.asarray([chain(i) for i in range(len(spans))], bool)


def idle_us(tr: Trace, spans: list, match) -> float:
    """The device's idle time (µs) in gaps whose middle's innermost span is
    a span ``match`` accepts or lies inside one."""
    gaps = np.asarray(tr.idle_gaps(), float).reshape(-1, 2)
    if not len(gaps) or not spans:
        return 0.0
    own = innermost(spans, gaps.mean(axis=1))
    inside = np.append(within(spans, match), False)[own]   # -1: no span
    return float((gaps[:, 1] - gaps[:, 0])[inside].sum())


def idle_ms_per(tr: Trace, match, per: str) -> Optional[float]:
    """``idle_us`` of ``match`` in ms over the window's spans named
    ``per``; None without them."""
    s = of(tr)
    n = len(named(s, per)) if s is not None else 0
    if not n:
        return None
    return idle_us(tr, s, match) * 1e-3 / n


def idle_by_span(tr: Trace) -> dict:
    """The device's idle gaps by the innermost span holding each one's
    middle (µs by name; "no span" where none does): what the spans leave
    unexplained."""
    s = of(tr) or []
    gaps = np.asarray(tr.idle_gaps(), float).reshape(-1, 2)
    out = {}
    for (a, b), i in zip(gaps, innermost(s, gaps.mean(axis=1)) if len(gaps) else []):
        name = s[i].name if i >= 0 else "no span"
        out[name] = out.get(name, 0.0) + float(b - a)
    return out


def busy_share(tr: Trace, spans: list) -> Optional[float]:
    """The share of the time inside ``spans`` (which must not overlap)
    that the union of the device's operations covers; None when they
    last no time."""
    total = sum(s.end - s.start for s in spans)
    if total <= 0:
        return None
    u = np.asarray(_union(tr.device_ops), float).reshape(-1, 2)
    cum = np.concatenate([[0.0], np.cumsum(u[:, 1] - u[:, 0])])

    def busy_before(t):
        k = int(np.searchsorted(u[:, 0], t, side="right"))
        return cum[k - 1] + min(u[k - 1, 1], t) - u[k - 1, 0] if k else 0.0

    return sum(busy_before(s.end) - busy_before(s.start) for s in spans) / total
