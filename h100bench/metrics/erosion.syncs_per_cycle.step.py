"""Host syncs a cycle: the window's ``sync.*`` spans over its
``erosion.cycle`` spans (the program's spans, one a sync, which the
``syncs`` lists count as well; ``h100bench/spans.py``)."""

from h100bench import spans


def read(tr):
    s = spans.of(tr)
    cycles = len(spans.named(s, "erosion.cycle")) if s is not None else 0
    if not cycles:
        return None
    return sum(x.name.startswith("sync.") for x in s) / cycles
