"""A closed loop of steps: the next step starts when the last has
synchronised.  ``step_ms`` is the window over the steps completed in it,
``step_p95_ms`` the 95th percentile of every step's latency."""

from .window import Window, closed_loop, p95_ms


def run(entry, traffic: dict, seed: int, seconds: float, trace: bool) -> Window:
    lat, window, tr = closed_loop(entry, traffic, seconds, trace)
    return Window(metrics={"step_ms": window * 1e3 / len(lat), "step_p95_ms": p95_ms(lat)},
                  attempted=len(lat), failed=0, trace=tr, notes={"steps": len(lat)})
