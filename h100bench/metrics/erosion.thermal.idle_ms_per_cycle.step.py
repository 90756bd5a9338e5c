"""The device's idle time a cycle, ms, in gaps whose middle lies in an
``erosion.thermal`` span, the spans inside it included, over the window's
``erosion.cycle`` spans (the program's spans, ``h100bench/spans.py``)."""

from h100bench import spans


def read(tr):
    return spans.idle_ms_per(tr, lambda n: n == "erosion.thermal", "erosion.cycle")
