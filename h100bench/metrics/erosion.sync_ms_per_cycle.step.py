"""The host's time in host syncs a cycle, ms: the ``sync.*`` spans'
summed length over the window's ``erosion.cycle`` spans (the program's
spans, ``h100bench/spans.py``)."""

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    cycles = len(spans.named(s, "erosion.cycle")) if s is not None else 0
    if not cycles:
        return None
    return sum((x.end - x.start) * 1e-3 for x in s if x.name.startswith("sync.")) / cycles
