"""An open loop of orders: Poisson arrivals at the traffic's fixed
``rate``, each order a tile on the player's random walk, sent when due
whatever the server is doing.

Every seed gets the same arrivals in another order: the gaps are the
exponential distribution's quantiles at (i + ½) / n, shuffled by the seed
and scaled to fill the window exactly.  ``tile_p95_ms`` is the 95th
percentile, over every order due in the window, of the time from the
order's due time to its ``on_complete``; the orders still out are waited
for, up to ``grace_seconds`` past the window, and an order that fails or
never comes counts as failed, its latency the whole wait.

With ``trace`` the whole window is profiled, the drain included: the
profiler starts and stops only while the server's worker is idle (started
or stopped under a thread that is running operations, it can bring the
process down).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..trace import Profiled
from .window import Window, p95_ms


def schedule(rng, rate: float, seconds: float) -> np.ndarray:
    """Due offsets (s) of the window's orders, the first at 0."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def run(entry, traffic: dict, seed: int, seconds: float, trace: bool) -> Window:
    due = schedule(entry.rng, traffic["rate"], seconds)
    n = len(due)
    path = entry.walk(n)
    entry.choose_sample(n)
    done = np.full(n, np.nan)
    bad = np.zeros(n, bool)
    lock = threading.Lock()

    def on_complete(i):
        def cb(st):
            t = time.perf_counter()
            entry.delivered(st)
            with lock:
                done[i] = t
                bad[i] = st.error is not None
        return cb

    prof = Profiled(entry.device).__enter__() if trace else None
    counters0 = entry.counters()
    late = 0.0
    t0 = time.perf_counter()
    for i in range(n):
        at = t0 + due[i]
        wait = at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - at)
        entry.submit(f"o{i}", path[i], on_complete(i))
    rest = t0 + seconds - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
    entry.drain(traffic["grace_seconds"])
    end = time.perf_counter()
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        c1 = entry.counters()
        tr = prof.trace(calls=c1["batches"] - counters0["batches"],
                        cycles=(c1["served"] - counters0["served"]) * entry.cycles_per_call,
                        counters=c1)
    with lock:
        missing = np.isnan(done) | bad
        lat = np.where(missing, end, done) - (t0 + due)
    half = n // 2
    return Window(metrics={"tile_p95_ms": p95_ms(lat)}, attempted=n,
                  failed=int(missing.sum()), trace=tr,
                  detail=[(float(d), float(x) * 1e3, p) for d, x, p in zip(due, lat, path)],
                  notes={"orders": n, "generator_late_ms_max": late * 1e3,
                         "delivered": int((~missing).sum()),
                         "p50_ms": float(np.median(lat) * 1e3),
                         "p95_ms_first_half": p95_ms(lat[:half]) if half else None,
                         "p95_ms_second_half": p95_ms(lat[half:]),
                         "done_per_s": float((~missing).sum() / (np.nanmax(done) - t0))})
