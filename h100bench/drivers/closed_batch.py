"""A closed loop of batches: the next batch starts when the last has
synchronised.  ``tiles_per_s`` is the tiles of every batch completed in the
window over the window."""

from .window import Window, closed_loop


def run(entry, traffic: dict, seed: int, seconds: float, trace: bool) -> Window:
    lat, window, tr = closed_loop(entry, traffic, seconds, trace)
    tiles = len(lat) * entry.tiles_per_call
    return Window(metrics={"tiles_per_s": tiles / window}, attempted=tiles, failed=0,
                  trace=tr, notes={"batches": len(lat), "tiles": tiles})
