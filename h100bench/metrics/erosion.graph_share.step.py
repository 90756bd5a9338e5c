"""The share of the window's erosion cycles replayed as CUDA graphs, %: the
``erosion.cycle`` spans that hold an ``erosion.graph`` span, over all of
them (the program's spans, ``h100bench/spans.py``).  A program without the
cycle's graphs (no ``noize_tpu_torch.erosion.graphs``) gives None."""

import importlib.util

from h100bench import spans


def read(tr):
    if importlib.util.find_spec("noize_tpu_torch.erosion.graphs") is None:
        return None
    s = spans.of(tr)
    cycles = {x.id for x in spans.named(s, "erosion.cycle")} if s is not None else set()
    if not cycles:
        return None
    replayed = {x.parent for x in spans.named(s, "erosion.graph")} & cycles
    return 100.0 * len(replayed) / len(cycles)
